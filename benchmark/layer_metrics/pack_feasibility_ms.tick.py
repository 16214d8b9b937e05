"""Mean time (ms) a tick in the program's `pack_feasibility` spans: the
host's [C, N] feasibility of every pending class on every standing node,
kernel B's first operand built."""


def read(trace):
    from spans import mean_ms

    return mean_ms(trace, ["pack_feasibility"])
