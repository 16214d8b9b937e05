"""Mean self time (ms) a tick of the program's `decode` spans: the fetched
decision turned into node groups, their types and their pods."""


def read(trace):
    from harness import span_ms

    if not trace.calls:
        return None
    return sum(span_ms(c["root"], "decode", True) for c in trace.calls) / len(trace.calls)
