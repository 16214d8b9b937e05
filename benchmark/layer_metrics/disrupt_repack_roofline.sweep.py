"""Kernel B's share (%) of its roofline over the traced sweeps: the least
time of its leftover-only entry (roofline/counts.py, from each sweep's own
inputs) over the time of its kernels on the card (span, sweep and block
kernels), by name. Nothing when no sweep launched it."""


def read(trace):
    times = [dur for name, _, dur in trace.kernels if "disrupt_repack" in name]
    if not times:
        return None
    bound = sum(b["disrupt_repack"] for b in trace.bounds)
    return 100.0 * bound / (sum(times) / 1e3)
