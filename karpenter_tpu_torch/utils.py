"""Small shared utilities: the two the solve path uses.

Copy of InternTable and gc_paused from karpenter_tpu/utils/__init__.py.
"""
from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Dict


class InternTable:
    """Bounded tuple->small-int intern table for hot dict keys: nested
    tuples re-hash on every probe (tuples do not cache their hash), so the
    50k-pod grouping loops intern them ONCE -- at construction or first
    sight, off the latency path -- and probe with trivially-hashed ints.

    The counter is MONOTONE across clears, so an id handed out before an
    overflow clear can never collide with one handed out after; stale
    holders simply re-intern to fresh ids, which can only SPLIT lookup
    groups, never merge them (both users converge through content-keyed
    maps downstream). One design, two instances: Pod spec tokens
    (apis/pod.py) and grouping signatures (solver/encode.py)."""

    def __init__(self, cap: int = 1 << 18):
        self._table: Dict[tuple, int] = {}
        self._next = 1
        self._cap = cap

    def intern(self, key: tuple) -> int:
        v = self._table.get(key)
        if v is None:
            if len(self._table) >= self._cap:
                self._table.clear()
            v = self._table[key] = self._next
            self._next += 1
        return v


_gc_pause_lock = threading.Lock()
_gc_pause_depth = 0
_gc_was_enabled = False


@contextmanager
def gc_paused():
    """Pause the cyclic garbage collector across an allocation-heavy hot
    section. A 50k-pod solve allocates hundreds of thousands of young
    container objects; the generational collector fires repeatedly mid-loop
    and multiplies the cold grouping cost. The objects are overwhelmingly
    acyclic, so deferring collection to the end of the section costs
    nothing; refcounting still frees as usual.

    Nesting AND concurrency are safe: a shared depth counter means only the
    last section to exit (across all threads) re-enables."""
    import gc

    global _gc_pause_depth, _gc_was_enabled
    with _gc_pause_lock:
        if _gc_pause_depth == 0:
            _gc_was_enabled = gc.isenabled()
            gc.disable()
        _gc_pause_depth += 1
    try:
        yield
    finally:
        with _gc_pause_lock:
            _gc_pause_depth -= 1
            if _gc_pause_depth == 0 and _gc_was_enabled:
                gc.enable()
