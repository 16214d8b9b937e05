"""Mean time (ms) a tick in the program's `route` and `prepare` spans:
schedule()'s routing checks (pools overlap, supports, the oracle suffix,
the minValues prefix) and solve_begin's class preparation (the pool's
requirements merged per class, the spread and suffix checks)."""


def read(trace):
    from spans import mean_ms

    return mean_ms(trace, ["route", "prepare"])
