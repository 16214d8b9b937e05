"""Share (%) of the traced ticks' kernel dispatches that no armed graph
replayed: each span's `dispatch` attribute maps the entries it dispatched
to the implementation that ran, `aot` for an armed graph."""


def read(trace):
    impls = []
    stack = [c["root"] for c in trace.calls]
    while stack:
        sp = stack.pop()
        stack.extend(sp.children)
        impls.extend((sp.attributes.get("dispatch") or {}).values())
    if not impls:
        return None
    return 100.0 * sum(impl != "aot" for impl in impls) / len(impls)
