"""Mean time (ms) a tick in the program's `pack_device` spans: kernel B's
full entry, from the upload of its operands to its takes on the host."""


def read(trace):
    from spans import mean_ms

    return mean_ms(trace, ["pack_device"])
