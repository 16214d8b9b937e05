"""Kernel A's share (%) of its roofline over the traced ticks: the least
time its launches could take (roofline/counts.py, from each tick's own
inputs) over their time on the card, by kernel name. Nothing when the
trace does not hold one launch a tick."""


def read(trace):
    times = [dur for name, _, dur in trace.kernels if "ffd_scan" in name]
    if not times or len(times) != len(trace.calls):
        return None
    bound = sum(b["ffd_scan"] for b in trace.bounds)
    return 100.0 * bound / (sum(times) / 1e3)
