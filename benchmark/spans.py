"""Means a tick of the program's spans, for the per-layer readers in
layer_metrics/: a metric whose spans no traced call holds reads None, as
it does on a program that does not open them."""
from typing import Iterable, Optional

from harness import span_ms


def _names(root) -> set:
    out, stack = set(), [root]
    while stack:
        sp = stack.pop()
        out.add(sp.name)
        stack.extend(sp.children)
    return out


def mean_ms(trace, names: Iterable[str], self_time: bool = False) -> Optional[float]:
    """Mean ms a traced call in the spans `names` (whole, or their self
    time); None when no call holds any of them."""
    names = tuple(names)
    roots = [c["root"] for c in trace.calls]
    if not roots or not any(set(names) & _names(r) for r in roots):
        return None
    return sum(span_ms(r, n, self_time) for r in roots for n in names) / len(roots)
