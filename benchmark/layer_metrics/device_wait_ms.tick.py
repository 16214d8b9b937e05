"""Mean time (ms) a tick the host waits in the program's `device` spans:
the one fetch of the fused decision, which waits for the card."""


def read(trace):
    from harness import span_ms

    if not trace.calls:
        return None
    return sum(span_ms(c["root"], "device", False) for c in trace.calls) / len(trace.calls)
