"""Kernel A's share (%) of its roofline over the traced ticks: the least
time its launches could take (roofline/counts.py, from each tick's own
inputs) over their time on the card, by kernel name. A tick that launches
it twice (the dense refetch after the sparse take overflows its budget)
counts its least time twice. Nothing when a traced tick has no launch in
the trace, or the trace's markers do not match the ticks."""


def read(trace):
    launches = [(start, dur) for name, start, dur in trace.kernels if "ffd_scan" in name]
    if not launches or trace.marks is None:
        return None
    bound = busy = 0.0
    for (m0, m1), b in zip(trace.marks, trace.bounds):
        inside = [dur for start, dur in launches if m0 <= start <= m1]
        if not inside:
            return None
        bound += b["ffd_scan"] * len(inside)
        busy += sum(inside)
    return 100.0 * bound / (busy / 1e3)
