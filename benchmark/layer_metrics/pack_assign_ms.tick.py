"""Mean time (ms) a tick in the program's `pack_assign` spans: kernel B's
takes turned into pods placed on standing nodes."""


def read(trace):
    from spans import mean_ms

    return mean_ms(trace, ["pack_assign"])
