"""Flight-data recorder: the always-on black box of the last 256 ticks.

Copy of karpenter_tpu/obs/flight.py. The slow-tick trace recorder
(tracing.FlightRecorder) keeps whole span TREES, but only for ticks past
a slowness threshold; this ring keeps one compact record per tick, every
tick:

    {seq, t_mono_s, tick_ms, stages_ms, device_ms, hbm_*, dirty_fraction,
     staged_bytes, optimality_gap, quality, deferred_pods, nodes_ready,
     pods_bound_total, crashed?}

``build_tick_record`` walks a finished port span tree for the stage
times (the same ``STAGE_NAMES`` as the JAX package: a port tick names
``encode``, ``device`` and ``decode``), polls obs/hbm.py, and reads the
solver's ``last_group_stats``, ``staged_bytes_by_kind`` and
``last_quality``. The operator's fields -- brownout rung, breaker state,
the disruption sweep, shed and deferred counts, ready nodes and bound
pods -- come from the port's Operator (``Operator._observe_tick``) and
its metrics registry, as in the JAX package.

``flush_blackbox(reason)`` writes the ring to a JSONL file (header line
first, then one record per line, write-then-rename so a crashing process
never leaves a torn file) at ``$KARPENTER_TPU_FLIGHTDATA`` (default
``flightdata.jsonl`` in the working directory).

Timestamps are MONOTONIC seconds plus the ring seq.
"""
from __future__ import annotations

import json
import os
import threading
from collections import deque
from typing import Any, Dict, Optional

from karpenter_tpu_torch import metrics
from karpenter_tpu_torch.logging import get_logger

BLACKBOX_ENV = "KARPENTER_TPU_FLIGHTDATA"
BLACKBOX_DEFAULT = "flightdata.jsonl"
CAPACITY_DEFAULT = 256

FLIGHT_RECORDS = metrics.REGISTRY.counter(
    "karpenter_flightdata_records_total",
    "Per-tick flight-data records appended to the black-box ring (one "
    "per operator sweep with the observatory enabled; keeps counting "
    "through every brownout rung by design)",
)
FLIGHT_FLUSHES = metrics.REGISTRY.counter(
    "karpenter_flightdata_flushes_total",
    "Black-box JSONL flushes by trigger (operator-crashed = the "
    "OperatorCrashed path through the tick; watchdog-crash = the "
    "stuck-tick watchdog's crash escalation; manual = operator-requested)",
    labels=("reason",),
)

log = get_logger("flightdata")


class FlightDataRecorder:
    """Bounded ring of per-tick records. ``record`` is the per-tick hot
    call: one lock, one deque append -- microseconds, measured into
    ``observatory_overhead_pct`` by bench. The lock is a leaf (nothing
    is called while holding it), so the recorder composes with every
    caller's locks."""

    def __init__(self, capacity: int = CAPACITY_DEFAULT):
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=capacity)
        self._seq = 0
        self.flushes = 0
        self._last_flush_path: Optional[str] = None

    @property
    def capacity(self) -> int:
        return self._ring.maxlen or 0

    def configure(self, capacity: Optional[int] = None) -> "FlightDataRecorder":
        if capacity is not None and capacity != self._ring.maxlen:
            with self._lock:
                self._ring = deque(self._ring, maxlen=max(1, int(capacity)))
        return self

    def record(self, rec: Dict[str, Any]) -> int:
        """Append one tick's record; returns its seq. The record dict is
        stored as-is (callers build it fresh per tick; nothing mutates
        it after)."""
        with self._lock:
            self._seq += 1
            rec["seq"] = self._seq
            self._ring.append(rec)
            seq = self._seq
        FLIGHT_RECORDS.inc()
        return seq

    def last(self) -> Optional[Dict[str, Any]]:
        with self._lock:
            return self._ring[-1] if self._ring else None

    def dump(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "capacity": self._ring.maxlen,
                "ticks_recorded": self._seq,
                "flushes": self.flushes,
                "last_flush_path": self._last_flush_path,
                "records": list(self._ring),
            }

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
            self._seq = 0
            self.flushes = 0
            self._last_flush_path = None

    def flush_blackbox(self, reason: str, path: Optional[str] = None) -> Optional[str]:
        """Write the ring to a JSONL black box: one header line
        ``{"flight_data": ..., "reason": ...}`` then one record per
        line, oldest first. Write-then-rename (the PR-5 side-file
        pattern): the crash that triggered the flush must never leave a
        torn file. Returns the path, or None when the ring is empty or
        the write failed (a flush must never turn a crash into a
        different crash)."""
        with self._lock:
            records = list(self._ring)
            seq = self._seq
        if not records:
            return None
        path = path or os.environ.get(BLACKBOX_ENV) or BLACKBOX_DEFAULT
        try:
            parent = os.path.dirname(path)
            if parent:
                os.makedirs(parent, exist_ok=True)
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                f.write(json.dumps({
                    "flight_data": 1,
                    "reason": reason,
                    "ticks_recorded": seq,
                    "records": len(records),
                    "capacity": self._ring.maxlen,
                }) + "\n")
                for rec in records:
                    f.write(json.dumps(rec, default=repr) + "\n")
            os.replace(tmp, path)
        except OSError as e:
            log.warning("flight-data flush failed", path=path, error=str(e))
            return None
        with self._lock:
            self.flushes += 1
            self._last_flush_path = path
        FLIGHT_FLUSHES.inc(reason=reason)
        log.warning(
            "flight data flushed", path=path, reason=reason, records=len(records),
        )
        return path


# process-wide recorder, the same shape as tracing.TRACER and
# metrics.REGISTRY: the operator feeds it per tick, /debug/flightdata
# and the crash paths read it without any plumbing
RECORDER = FlightDataRecorder()


def record(rec: Dict[str, Any]) -> int:
    return RECORDER.record(rec)


def flush_blackbox(reason: str, path: Optional[str] = None) -> Optional[str]:
    return RECORDER.flush_blackbox(reason, path=path)


def dump_json(indent: Optional[int] = None) -> str:
    return json.dumps(RECORDER.dump(), indent=indent, default=repr)


# span names whose durations the per-tick record keys on: the PR-2 span
# vocabulary (docs/observability.md tree) -- stable identifiers, same
# contract as bench's trace_stages_ms
STAGE_NAMES = (
    "snapshot", "dispatch", "drain", "launch", "bind", "disruption",
    "encode", "wire", "wire_dispatch", "device", "decode", "fetch",
)


def build_tick_record(root_sp, t0: float, *, solver=None, brownout=None,
                      breaker=None, disruption=None, crashed: bool = False,
                      clock=None) -> Dict[str, Any]:
    """ONE tick's flight record, the single source of what a record
    contains: the operator's per-tick path (Operator._observe_tick) and
    bench's observatory-overhead measurement both call THIS, so the <1%
    overhead contract is measured on exactly the work production pays --
    a field added here is automatically in both. Stage ms from the
    finished span tree, the rate-limited HBM poll, the solver's
    churn/staging state, and the overload/fleet gauges (plain dict
    reads)."""
    import time

    from karpenter_tpu_torch import metrics
    from karpenter_tpu_torch.obs import hbm

    now = (clock or time.monotonic)()
    rec: Dict[str, Any] = {
        "t_mono_s": round(now, 3),
        "tick_ms": round((now - t0) * 1e3, 3),
    }
    rec.update(stage_summary(root_sp))
    snap = hbm.poll()
    if snap["devices"]:
        rec["hbm_bytes_in_use"] = sum(
            d["bytes_in_use"] for d in snap["devices"].values()
        )
        rec["hbm_peak_bytes"] = hbm.peak_bytes_max()
    if snap["headroom_fraction"] is not None:
        rec["hbm_headroom"] = round(snap["headroom_fraction"], 4)
    if solver is not None:
        st = getattr(solver, "last_group_stats", None)
        if st and "dirty_fraction" in st:
            rec["dirty_fraction"] = round(float(st["dirty_fraction"]), 4)
        staged = getattr(solver, "staged_bytes_by_kind", None)
        if callable(staged):
            rec["staged_bytes"] = staged()
        # solution-quality observatory (obs/quality.py): the last solve's
        # gap + waste attribution headline fields -- cheap dict reads of
        # the document solve_finish already built, so the black box shows
        # answer quality next to where the time went
        q = getattr(solver, "last_quality", None)
        if q:
            if "optimality_gap" in q:
                rec["optimality_gap"] = q["optimality_gap"]
            rec["quality"] = {
                k: q[k]
                for k in ("bound_per_h", "realized_per_h",
                          "stranded_cpu_fraction", "stranded_memory_fraction",
                          "fragmentation_index")
                if k in q
            }
        # mesh fault tolerance: stamp the tick with the live topology
        # document (epoch, healthy/quarantined devices, ladder mode) so a
        # post-incident trace shows which device set each decision ran
        # under -- plain dict reads, same <1% overhead discipline
        engine = getattr(solver, "mesh_engine", None)
        topo = getattr(engine, "topology", None)
        if topo is not None:
            rec["topology"] = topo.describe()
            rec["topology"]["mode"] = topo.mode()
        if breaker is None:
            breaker = getattr(solver, "breaker", None)
    if breaker is not None:
        rec["breaker"] = breaker.state
    if brownout is not None:
        rec["brownout_level"] = brownout.level
    if disruption is not None:
        # device-consolidation sweep (controllers/disruption.py
        # last_sweep_stats): sweep mode + wall ms + candidate-set counts
        # by enumeration kind -- the black box must show whether the
        # rung-1 bounded sweep kept running through a brownout
        st = getattr(disruption, "last_sweep_stats", None)
        if st and "consolidation_ms" in st:
            rec["consolidation_ms"] = st["consolidation_ms"]
            rec["consolidation_mode"] = st.get("mode", "full")
            sets = st.get("sets") or {}
            if sets:
                rec["consolidation_sets"] = dict(sets)
    rec["deferred_pods"] = int(metrics.OVERLOAD_DEFERRED.value())
    shed = {
        reason: int(metrics.OVERLOAD_SHED.value(reason=reason))
        for reason in ("admission-cap", "deadline", "launch-bound")
    }
    if any(shed.values()):
        rec["shed_total"] = shed
    rec["nodes_ready"] = int(metrics.NODES_READY.value())
    rec["pods_bound_total"] = int(metrics.PODS_BOUND.value())
    if crashed:
        rec["crashed"] = True
    return rec


def stage_summary(root) -> Dict[str, Any]:
    """{stages_ms, device_ms} from one finished tick span tree (a
    tracing.Span root). Sums durations per STAGE_NAMES name across the
    tree -- ~20 nodes on a full tick, so the walk is cheap enough for
    every tick. Non-Span roots (tracing disabled -> the no-op
    singleton) summarize to nothing; the record still lands."""
    stages: Dict[str, float] = {}
    if root is None or not getattr(root, "children", None):
        return {}
    stack = list(root.children)
    while stack:
        sp = stack.pop()
        stack.extend(sp.children)
        if sp.name in STAGE_NAMES:
            end = sp.end if sp.end is not None else sp.start
            stages[sp.name] = stages.get(sp.name, 0.0) + (end - sp.start) * 1e3
    out: Dict[str, Any] = {}
    if stages:
        out["stages_ms"] = {k: round(v, 3) for k, v in sorted(stages.items())}
        if "device" in stages:
            out["device_ms"] = round(stages["device"], 3)
    return out
