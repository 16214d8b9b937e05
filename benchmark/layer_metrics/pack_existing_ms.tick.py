"""Mean self time (ms) a tick of the program's `pack_existing` spans: the
host's [C, N] feasibility over the standing nodes, kernel B's full entry
and the assignment of its takes to pods. Nothing when no tick packs onto
standing nodes."""


def read(trace):
    from harness import span_ms

    if not any(span_ms(c["root"], "pack_existing", False) for c in trace.calls):
        return None
    return sum(span_ms(c["root"], "pack_existing", True) for c in trace.calls) / len(trace.calls)
