"""Mean time (ms) a tick in the program's `pack_headroom` spans: each
standing node's remaining capacity, scaled to the solver's vector."""


def read(trace):
    from spans import mean_ms

    return mean_ms(trace, ["pack_headroom"])
