"""Shard-straggler watchdog: the per-shard-dispatch arm of PR-9's
stuck-tick machinery.

Copy of karpenter_tpu/fleet/straggler.py over the port (imports
rewritten; nothing else changed).

The StuckTickWatchdog (overload.py) sees a WHOLE tick wedged; it cannot
tell which layer wedged it. On the mesh fleet path the interesting
failure is one rung lower: a single sharded dispatch stalls -- one
device's program hangs, a collective waits on a dead chip -- while the
rest of the mesh is healthy. This watchdog brackets every
``MeshSolveEngine._dispatch`` and escalates a dispatch wedged past N x
the per-shard budget through its own ladder:

    cancel       (default  4 x budget) -- run the cancel hook (close the
                 solver wire / abort the transfer); a blocked fetch dies
                 with its stream and the dispatch raises
    quarantine   (default  8 x budget) -- mark the WORST device lost on
                 the engine's TopologyTracker: the epoch bumps, the next
                 dispatch resolves the stall as a typed
                 StaleTopologyError, and the reshard lands the solve on
                 the surviving devices
    breaker-open (default 12 x budget) -- force the breaker open so
                 regular traffic stops touching the mesh path at all
    crash        (default 16 x budget) -- async-raise OperatorCrashed
                 into the wedged thread; the PR-6 journal recovery sweep
                 takes over

Same discipline as the template: hooks run OUTSIDE the lock, the crash
raise alone runs UNDER it after re-verifying the same dispatch is still
wedged, and the flight-data black box flushes before the raise.
Deterministic rigs drive ``check_now()``; the production sidecar runs
the background thread (``start()``).
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Optional

from karpenter_tpu_torch import metrics
from karpenter_tpu_torch.logging import get_logger
from karpenter_tpu_torch.overload import _async_raise_crash


class ShardStragglerWatchdog:
    """Detects one sharded dispatch wedged past N x the per-shard budget
    and escalates cancel -> device-quarantine (epoch bump) -> the
    existing breaker/crash rungs."""

    STAGES = ("cancel", "quarantine", "breaker-open", "crash")
    log = get_logger("straggler")

    def __init__(self, budget: float, *, engine=None,
                 cancel: Optional[Callable[[], None]] = None, breaker=None,
                 multiples=(4.0, 8.0, 12.0, 16.0),
                 clock: Callable[[], float] = time.monotonic):
        self.budget = float(budget)
        self.multiples = tuple(float(m) for m in multiples)
        self._engine = engine
        self._cancel = cancel
        self._breaker = breaker
        self._clock = clock
        self._lock = threading.Lock()
        self._started: Optional[float] = None
        self._entry: Optional[str] = None
        self._thread_id: Optional[int] = None
        self._stage = 0
        # dispatch generation: bumps on every dispatch_started so the
        # crash rung can re-verify under the lock that the SAME dispatch
        # is still wedged immediately before the async raise (see
        # StuckTickWatchdog._generation)
        self._generation = 0
        self.escalations = {s: 0 for s in self.STAGES}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- dispatch bracketing (called by MeshSolveEngine._dispatch) ------------
    def dispatch_started(self, entry: str) -> None:
        with self._lock:
            self._started = self._clock()
            self._entry = str(entry)
            self._thread_id = threading.get_ident()
            self._stage = 0
            self._generation += 1

    def dispatch_finished(self) -> None:
        with self._lock:
            self._started = None
            self._entry = None
            self._stage = 0

    # -- escalation ----------------------------------------------------------
    def check_now(self) -> Optional[str]:
        """Evaluate the ladder once; returns the stage name fired, or
        None. Cancel/quarantine/breaker hooks run OUTSIDE the lock (they
        take other subsystems' locks: the engine's topology lock, the
        breaker's); the crash raise alone runs UNDER it."""
        with self._lock:
            if self._started is None or self._stage >= len(self.STAGES):
                return None
            elapsed = self._clock() - self._started
            if elapsed < self.multiples[self._stage] * self.budget:
                return None
            stage = self._stage
            self._stage += 1
            entry = self._entry
            tid = self._thread_id
            gen = self._generation
        name = self.STAGES[stage]
        if name == "crash":
            # flush the black box BEFORE the raise, from this thread: a
            # C-level hang may never reach a bytecode boundary, so the
            # dispatch-side OperatorCrashed flush may never run
            try:
                from karpenter_tpu_torch.obs import flight

                flight.flush_blackbox(reason="straggler-crash")
            except Exception:  # noqa: BLE001 -- best-effort, like cancel
                metrics.HANDLED_ERRORS.inc(site="fleet.straggler.flush")
            # re-check AND raise under the lock: dispatch_finished takes
            # this same lock, so the exception is pending in the wedged
            # thread before the dispatch can be marked finished
            with self._lock:
                still_wedged = (
                    self._started is not None and self._generation == gen
                    and tid is not None
                )
                if still_wedged:
                    _async_raise_crash(tid)
            if not still_wedged:
                self.log.warning(
                    "straggling shard dispatch un-wedged before the crash "
                    "escalation; standing down")
                return None
        self.escalations[name] += 1
        metrics.MESH_SHARD_WATCHDOG.inc(stage=name)
        self.log.warning(
            "shard-straggler watchdog escalation",
            stage=name, entry=entry, elapsed_s=round(elapsed, 3),
            budget_s=self.budget,
        )
        if name == "cancel":
            if self._cancel is not None:
                try:
                    self._cancel()
                except Exception:  # noqa: BLE001 -- cancel is best-effort
                    metrics.HANDLED_ERRORS.inc(site="fleet.straggler.cancel")
        elif name == "quarantine":
            if self._engine is not None:
                try:
                    idx = self._engine.quarantine_worst_device(reason="straggler")
                    self.log.warning(
                        "straggler quarantine", device=idx,
                        epoch=self._engine.epoch)
                except Exception:  # noqa: BLE001 -- escalation is best-effort
                    metrics.HANDLED_ERRORS.inc(site="fleet.straggler.quarantine")
        elif name == "breaker-open":
            if self._breaker is not None:
                try:
                    self._breaker.force_open(reason="shard-straggler watchdog")
                except Exception:  # noqa: BLE001 -- escalation is best-effort
                    metrics.HANDLED_ERRORS.inc(site="fleet.straggler.breaker")
        # (the crash rung already raised above, under the lock)
        return name

    # -- background loop (the wall-clock sidecar) -----------------------------
    def start(self) -> "ShardStragglerWatchdog":
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop, daemon=True, name="shard-straggler-watchdog"
            )
            self._thread.start()
        return self

    def _loop(self) -> None:
        interval = max(0.05, self.budget / 2.0)
        while not self._stop.wait(timeout=interval):
            self.check_now()

    def stop(self) -> None:
        self._stop.set()

    def describe(self) -> dict:
        with self._lock:
            active_s = (
                round(self._clock() - self._started, 3)
                if self._started is not None else None
            )
            entry = self._entry
        return {
            "budget_s": self.budget,
            "multiples": list(self.multiples),
            "dispatch_active_for_s": active_s,
            "entry": entry,
            "escalations": dict(self.escalations),
        }
