"""Mean time (ms) a tick in the program's `envelopes` spans: the price
envelopes unified per (opening pool, class key), on the one-pool and the
merged route alike. Nothing on a program that does not open them."""


def read(trace):
    from spans import mean_ms

    return mean_ms(trace, ["envelopes"])
