"""Mean time (ms) a tick in the program's `bound` and `quality` spans: the
fractional price bound's dispatch, then its fetch and the quality
document."""


def read(trace):
    from spans import mean_ms

    return mean_ms(trace, ["bound", "quality"])
