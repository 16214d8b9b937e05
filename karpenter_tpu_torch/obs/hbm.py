"""Device memory accounting: the card's allocator ledger, per tick, with owner attribution.

Copy of karpenter_tpu/obs/hbm.py on torch's CUDA caching allocator in
place of ``jax.devices()[i].memory_stats()``: per device ``cuda:<i>``,

    bytes_in_use       torch.cuda.memory_stats(i)["allocated_bytes.all.current"]
                       (what torch.cuda.memory_allocated(i) reads)
    peak_bytes_in_use  memory_stats(i)["allocated_bytes.all.peak"]
                       (torch.cuda.max_memory_allocated(i))
    bytes_limit        the total of torch.cuda.mem_get_info(i)

polled into the same ``karpenter_device_hbm_*`` gauges, with the same
process-lifetime peak ledger and the same **headroom** signal: when the
fraction of device memory still free (1 - in_use / limit on the fullest
device) drops below the evict threshold, TorchSolver's staged-catalog
LRU shrinks to a floor of one entry instead of waiting for its fixed
capacity (``karpenter_solver_staged_pressure_evictions_total``).

Attribution rides next to the raw gauges: ``sum_nbytes`` is the shared
walker behind ``TorchSolver.staged_bytes_by_kind`` -- ``.nbytes`` is
tensor METADATA on numpy and torch alike, so reading it never
synchronizes with the card.

A process that has not initialized CUDA polls nothing (no context is
ever created for accounting's sake); polls then record nothing and
``headroom()`` is None, so pressure eviction degrades to capacity-only,
as on the CPU. Tests inject a provider (``set_stats_provider``) to
exercise the pressure paths without a card.
"""
from __future__ import annotations

import os
import threading
import time
from typing import Any, Callable, Dict, Optional

from karpenter_tpu_torch import metrics

HBM_IN_USE = metrics.REGISTRY.gauge(
    "karpenter_device_hbm_bytes_in_use",
    "Device HBM bytes currently allocated, per device, from the runtime's "
    "own allocator ledger (torch.cuda.memory_stats(); absent while the "
    "process has not initialized CUDA)",
    labels=("device",),
)
HBM_LIMIT = metrics.REGISTRY.gauge(
    "karpenter_device_hbm_bytes_limit",
    "Device HBM capacity visible to the allocator, per device "
    "(the total of torch.cuda.mem_get_info())",
    labels=("device",),
)
HBM_PEAK = metrics.REGISTRY.gauge(
    "karpenter_device_hbm_peak_bytes",
    "High-water mark of device HBM bytes in use since process start, per "
    "device (max over every observatory poll; the runtime's own "
    "peak_bytes_in_use when it reports one)",
    labels=("device",),
)
HBM_HEADROOM = metrics.REGISTRY.gauge(
    "karpenter_device_hbm_headroom_fraction",
    "Fraction of HBM still free on the FULLEST device (min over devices "
    "of 1 - in_use/limit); below the evict threshold the staged-catalog "
    "LRU shrinks on pressure instead of capacity -- see "
    "karpenter_solver_staged_pressure_evictions_total",
)

# headroom fraction below which the staging LRU evicts down to its
# floor; 0 disables pressure eviction entirely
EVICT_HEADROOM_ENV = "KARPENTER_TPU_HBM_EVICT_HEADROOM"
EVICT_HEADROOM_DEFAULT = 0.10

# polls within this window reuse the last snapshot: the per-tick caller
# (the flight recorder) and the per-stage caller (the catalog LRU
# insert) must not turn a fast tick loop into a memory_stats() storm
POLL_MAX_AGE_S = 0.2

_lock = threading.Lock()
_peak: Dict[str, int] = {}
_last_snapshot: Dict[str, Any] = {"devices": {}, "headroom_fraction": None}
_last_poll: float = -1e9
# test seam: () -> {device_label: {"bytes_in_use": int, "bytes_limit":
# int, ...}} | None; None = read the real CUDA devices
_stats_provider: Optional[Callable[[], Optional[Dict[str, dict]]]] = None


def set_stats_provider(fn: Optional[Callable[[], Optional[Dict[str, dict]]]]) -> None:
    """Inject a memory-stats source (tests / fakes); None restores the
    real CUDA device walk. Resets the peak ledger: a provider swap is a
    new device world."""
    global _stats_provider, _last_poll
    with _lock:
        _stats_provider = fn
        _peak.clear()
        _last_poll = -1e9


def _real_stats() -> Optional[Dict[str, dict]]:
    import sys

    torch = sys.modules.get("torch")
    if torch is None or not torch.cuda.is_initialized():
        # accounting must never be the reason a CUDA context comes up: a
        # process that solved on the CPU polls nothing
        return None
    try:
        out: Dict[str, dict] = {}
        for i in range(torch.cuda.device_count()):
            st = torch.cuda.memory_stats(i)
            _free, total = torch.cuda.mem_get_info(i)
            out[f"cuda:{i}"] = {
                "bytes_in_use": int(st.get("allocated_bytes.all.current", 0)),
                "peak_bytes_in_use": int(st.get("allocated_bytes.all.peak", 0)),
                "bytes_limit": int(total),
            }
        return out or None
    except Exception:  # noqa: BLE001 -- accounting must never fail a tick
        metrics.HANDLED_ERRORS.inc(site="obs.hbm.memory_stats")
        return None


def poll(max_age_s: float = POLL_MAX_AGE_S) -> Dict[str, Any]:
    """One accounting pass: read memory stats, update the gauges and the
    per-device peak ledger, return the snapshot. Recent polls (within
    ``max_age_s``) return the cached snapshot untouched."""
    global _last_poll
    now = time.monotonic()
    with _lock:
        if now - _last_poll < max_age_s:
            return dict(_last_snapshot)
        provider = _stats_provider
    stats = provider() if provider is not None else _real_stats()
    devices: Dict[str, dict] = {}
    headroom: Optional[float] = None
    if stats:
        for label, st in sorted(stats.items()):
            in_use = int(st.get("bytes_in_use", 0))
            limit = int(st.get("bytes_limit", 0))
            peak = max(int(st.get("peak_bytes_in_use", 0)), in_use)
            with _lock:
                peak = max(peak, _peak.get(label, 0))
                _peak[label] = peak
            HBM_IN_USE.set(float(in_use), device=label)
            HBM_PEAK.set(float(peak), device=label)
            if limit > 0:
                HBM_LIMIT.set(float(limit), device=label)
                free = 1.0 - in_use / limit
                headroom = free if headroom is None else min(headroom, free)
            devices[label] = {
                "bytes_in_use": in_use, "bytes_limit": limit,
                "peak_bytes": peak,
            }
        if headroom is not None:
            HBM_HEADROOM.set(headroom)
    snapshot = {"devices": devices, "headroom_fraction": headroom}
    with _lock:
        _last_snapshot.clear()
        _last_snapshot.update(snapshot)
        _last_poll = now
    return snapshot


def headroom() -> Optional[float]:
    """Min-over-devices free-HBM fraction from a fresh-enough poll;
    None when no device reports an allocator ledger (CPU backend)."""
    return poll().get("headroom_fraction")


def evict_threshold() -> float:
    try:
        return float(os.environ.get(EVICT_HEADROOM_ENV, EVICT_HEADROOM_DEFAULT))
    except ValueError:
        return EVICT_HEADROOM_DEFAULT


def under_pressure() -> bool:
    """True when the fullest device's free fraction is below the evict
    threshold -- the staging LRU's signal to shrink to its floor. No
    ledger (CPU) = never under pressure (capacity eviction still holds)."""
    thresh = evict_threshold()
    if thresh <= 0:
        return False
    free = headroom()
    return free is not None and free < thresh


def peak_bytes_max() -> int:
    """Largest per-device peak seen since process start."""
    with _lock:
        return max(_peak.values(), default=0)


def sum_nbytes(obj: Any) -> int:
    """Total ``nbytes`` under obj: arrays and tensors count themselves;
    tuples/lists/dicts/NamedTuples/objects with ``_fields`` or
    ``__dict__`` walk one level of their values. Metadata reads only --
    never a transfer."""
    n = getattr(obj, "nbytes", None)
    if isinstance(n, int):
        return n
    if obj is None:
        return 0
    if isinstance(obj, dict):
        values = obj.values()
    elif isinstance(obj, (tuple, list)):
        values = obj
    elif hasattr(obj, "_fields"):  # NamedTuple
        values = (getattr(obj, f) for f in obj._fields)
    elif hasattr(obj, "__dict__"):
        values = vars(obj).values()
    else:
        return 0
    total = 0
    for v in values:
        n = getattr(v, "nbytes", None)
        if isinstance(n, int):
            total += n
        elif isinstance(v, (tuple, list, dict)):
            total += sum_nbytes(v)
    return total
