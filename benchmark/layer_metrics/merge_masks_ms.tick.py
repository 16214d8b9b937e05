"""Mean time (ms) a tick in the program's `merge_masks` spans: the merged
route's open and join masks under several pools (compat, the fits test,
each class's admitted pools, the first pool it opens in). Nothing on a
program or a cell whose calls open none."""


def read(trace):
    from spans import mean_ms

    return mean_ms(trace, ["merge_masks"])
