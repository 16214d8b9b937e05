"""Share (%) of the traced ticks whose sparse take overflowed its budget:
a `device` span whose `take_pairs` (the true (class, group) pairs) exceeds
its `take_budget`, so the tick refetched the dense decision and ran
kernel A twice. Nothing when no span carries the counters."""


def read(trace):
    counted = over = 0
    for c in trace.calls:
        seen = tripped = False
        stack = [c["root"]]
        while stack:
            sp = stack.pop()
            stack.extend(sp.children)
            if sp.name == "device" and "take_pairs" in sp.attributes:
                seen = True
                tripped |= sp.attributes["take_pairs"] > sp.attributes["take_budget"]
        counted += seen
        over += tripped
    if not counted:
        return None
    return 100.0 * over / len(trace.calls)
