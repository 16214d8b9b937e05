"""Mean self time (ms) a tick of the program's `encode` spans: the class
tensors against the staged catalog, price envelopes, counts."""


def read(trace):
    from harness import span_ms

    if not trace.calls:
        return None
    return sum(span_ms(c["root"], "encode", True) for c in trace.calls) / len(trace.calls)
