"""Share (%) of the traced window in which nothing ran on the card, over
the provisioning ticks."""


def read(trace):
    if trace.window_us <= 0 or trace.busy_us <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_us / trace.window_us)
