"""Kernel B's share (%) of its roofline over the traced ticks that pack onto
standing nodes: the least time of its full entry (roofline/counts.py,
from each tick's own inputs) over the time of its kernels on the card, by
name. Nothing when no tick launched it."""


def read(trace):
    times = [dur for name, _, dur in trace.kernels if "disrupt_repack" in name]
    bounds = [b["disrupt_repack"] for b in trace.bounds if "disrupt_repack" in b]
    if not times or not bounds:
        return None
    return 100.0 * sum(bounds) / (sum(times) / 1e3)
