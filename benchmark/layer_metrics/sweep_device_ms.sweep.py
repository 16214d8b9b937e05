"""Milliseconds a sweep in which something ran on the card (the union of
kernel and copy intervals of the traced sweeps, over their number)."""


def read(trace):
    if not trace.calls or trace.busy_us <= 0:
        return None
    return trace.busy_us / 1e3 / len(trace.calls)
