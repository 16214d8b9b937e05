"""Mean time (ms) a tick in the program's `join_masks` spans: the merged
route's taint gate, the columns of each tainted pool a class may use at
all (inside `merge_masks`). Nothing on a program or a cell whose calls
gate no column by a taint."""


def read(trace):
    from spans import mean_ms

    return mean_ms(trace, ["join_masks"])
