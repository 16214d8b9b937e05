"""Small shared utilities (reference: pkg/utils/utils.go:1-123).

Copy of karpenter_tpu/utils/__init__.py, imports rewritten to the port's.
`probe_jax_backend` and `enable_jax_compilation_cache` are not copied:
the port's binary probes the card with `probe_cuda_device` instead, and
has no compilation cache (its kernels build once per checkout).
"""
from __future__ import annotations

from contextlib import contextmanager
import re
from typing import Dict, Mapping

_PROVIDER_ID_RE = re.compile(r"^tpu:///(?P<zone>[^/]+)/(?P<id>[^/]+)$")


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


def parse_instance_id(provider_id: str) -> str:
    """providerID ("tpu:///zone/i-abc") -> instance id (reference:
    ParseInstanceID regex over aws:///...)."""
    m = _PROVIDER_ID_RE.match(provider_id)
    if not m:
        raise ValueError(f"unparseable provider id {provider_id!r}")
    return m.group("id")


def nodeclaim_instance_id(claim) -> "str | None":
    """Index key for the status.instanceID field index: the instance id
    from a NodeClaim's providerID, or None when unset/unparseable (the
    claim is then simply not indexed)."""
    try:
        return parse_instance_id(claim.provider_id) if claim.provider_id else None
    except ValueError:
        return None


def merge_tags(*tag_maps: Mapping[str, str]) -> Dict[str, str]:
    """Later maps win (reference: GetTags merge order)."""
    out: Dict[str, str] = {}
    for m in tag_maps:
        out.update(m)
    return out


import threading as _threading

_gc_pause_lock = _threading.Lock()
_gc_pause_depth = 0
_gc_was_enabled = False


@contextmanager
def gc_paused():
    """Pause the cyclic garbage collector across an allocation-heavy hot
    section. A 50k-pod solve allocates hundreds of thousands of young
    container objects; the generational collector fires repeatedly mid-loop
    and multiplies the cold grouping cost ~6x (measured: 400ms -> 60ms).
    The objects are overwhelmingly acyclic, so deferring collection to the
    end of the section costs nothing; refcounting still frees as usual.

    Nesting AND concurrency are safe: a shared depth counter means only the
    last section to exit (across all threads) re-enables -- a per-call
    isenabled() snapshot would let one thread's exit re-enable GC in the
    middle of another thread's hot loop."""
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


_PROBE_CODE = (
    "import torch\n"
    "assert torch.cuda.is_available(), 'torch.cuda.is_available() is False'\n"
    "x = torch.arange(8.0, device='cuda')\n"
    "assert float((x * 2).sum()) == 56.0\n"
    "print('DEVICE=' + torch.cuda.get_device_name(0))\n"
)


def probe_cuda_device(timeout_s: float = 120.0):
    """Initialize CUDA in a SUBPROCESS and run one tiny kernel there, so a
    wedged driver cannot hang the caller. Returns (device_name, error):
    device_name is None on failure. The binary refuses to start on a
    failed probe; only an explicit ``--device cpu`` runs without a card."""
    import subprocess
    import sys

    try:
        r = subprocess.run(
            [sys.executable, "-c", _PROBE_CODE],
            timeout=timeout_s, capture_output=True, text=True,
        )
    except subprocess.TimeoutExpired:
        return None, f"CUDA probe timed out after {timeout_s:.0f}s"
    for line in r.stdout.splitlines():
        if line.startswith("DEVICE="):
            return line.split("=", 1)[1], None
    return None, (r.stderr or r.stdout).strip()[-500:] or f"probe exited {r.returncode}"


def configure_gc_for_latency() -> None:
    """Tune the cyclic collector for a latency-critical tick loop.

    The scheduling path allocates hundreds of thousands of young container
    objects per 50k-pod tick, nearly all acyclic (pods, Resources,
    Requirements tuples) and freed by refcounting. With default
    thresholds, CPython's generational collector promotes that churn into
    gen2 and then runs ~400 ms full collections -- measured walking ~1M
    live objects, firing at arbitrary points INSIDE the scheduling
    decision and tripling p99. The policy here, applied once at operator
    or bench startup after the long-lived graph exists:

    - one full collect, then gc.freeze(): the framework/jax module
      baseline moves to the permanent generation, out of every future
      collection's walk;
    - gen0 threshold raised to 1M allocations: tick churn is freed by
      refcounting, so automatic cyclic collections become rare instead of
      constant. Cyclic garbage (there is nearly none) still gets collected
      -- just in batches, off the critical path.

    Go's concurrent collector gives the reference this for free; CPython
    needs to be told. (Measured effect: cold grouping 75 ms -> 18 ms
    stable, solve p99 variance collapses, RSS flat over 50+ ticks.)"""
    import gc

    gc.collect()
    gc.freeze()
    gc.set_threshold(1_000_000, 50, 50)
