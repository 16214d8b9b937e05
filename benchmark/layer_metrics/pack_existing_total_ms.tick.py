"""Mean time (ms) a tick in the program's `pack_existing` spans, whole:
the pack onto the standing nodes, its four stages and what they leave."""


def read(trace):
    from spans import mean_ms

    return mean_ms(trace, ["pack_existing"])
