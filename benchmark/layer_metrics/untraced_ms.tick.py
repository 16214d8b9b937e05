"""Mean self time (ms) a tick of the root span `bench.call`: the tick's
time inside no program span."""


def read(trace):
    from spans import mean_ms

    return mean_ms(trace, ["bench.call"], self_time=True)
