"""Solver-wire circuit breaker with supervised recovery.

Copy of karpenter_tpu/solver/breaker.py, whole, with the port's metrics
and logger; the families and log lines keep the JAX package's names, and
under the same ``clock`` and ``rng`` the state sequence is the JAX
breaker's (tests/test_torch_breaker.py). In the port, the in-process rung
the open breaker routes to is TorchSolver on its own device (the card by
default), never a quiet move to the CPU.

The pipelined production tick rides the solver RPC sidecar (solver/rpc.py);
its failure mode before this module was per-call: every degraded tick paid
the full connect/read ladder before the CPU fallback fired, and recovery
was a blind per-call reconnect. The breaker gives the wire path the three
canonical states:

- CLOSED    -- healthy; wire solves flow, consecutive failures counted.
- OPEN      -- K consecutive wire failures tripped it; ``allow()`` is
  False so TPUSolver skips the wire ENTIRELY (no connect attempt, no
  stall) and solves in process -- same kernels, same
  decisions, degraded speed. The provisioner keeps ticking synchronously.
- HALF-OPEN -- a probe (one bounded ping on the shared client) is testing
  the sidecar. Regular traffic still skips the wire; only a SUCCESSFUL
  probe re-promotes, and the promotion hook drops the client connection
  so the next wire solve reconnects, re-auths, and RE-STAGES the catalog
  (rpc.SolverClient.close clears the per-connection staged-seqnum set) --
  the device path never resumes against a stale staging.

Probes back off exponentially with jitter (base doubling up to a cap, a
0..50% jitter factor so a fleet of controllers does not synchronize its
re-probe storms against one recovering sidecar). Probing is available in
two forms: ``maybe_probe()`` for deterministic, clock-driven callers
(tests, the kwok rig) and a background daemon thread (``auto_probe=True``,
the production binary) woken on trip.

Every transition is observable: ``karpenter_scheduler_breaker_*`` metrics,
structured logs, and ``describe()`` served on ``/debug/breaker`` and
summarized on ``/healthz`` (operator/health.py).
"""
from __future__ import annotations

import random
import threading
import time
from typing import Callable, Optional

from karpenter_tpu_torch import metrics
from karpenter_tpu_torch.logging import get_logger

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half-open"


class CircuitBreaker:
    log = get_logger("breaker")

    def __init__(
        self,
        failure_threshold: int = 3,
        backoff_base: float = 0.5,
        backoff_max: float = 30.0,
        *,
        probe: Optional[Callable[[], bool]] = None,
        on_promote: Optional[Callable[[], None]] = None,
        clock: Callable[[], float] = time.monotonic,
        rng: Callable[[], float] = random.random,
        auto_probe: bool = False,
    ):
        self.failure_threshold = max(1, int(failure_threshold))
        self.backoff_base = float(backoff_base)
        self.backoff_max = float(backoff_max)
        self._probe = probe
        self._on_promote = on_promote
        self._clock = clock
        self._rng = rng
        self._lock = threading.RLock()
        self._state = CLOSED
        self._consecutive = 0
        self._opened_at: Optional[float] = None
        self._next_probe_at: Optional[float] = None
        self._backoff = self.backoff_base
        self._probing = False
        self.trips = 0
        self.probes_ok = 0
        self.probes_failed = 0
        self.promotions = 0
        self.auto_probe = auto_probe
        self._stop = threading.Event()
        self._wake = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._set_state_gauge(CLOSED)

    # -- hot-path reads (lock-free: str/int stores are atomic in CPython) ----
    def allow(self) -> bool:
        """True while the wire path should be used. False in OPEN and
        HALF-OPEN: regular traffic skips the wire instantly; only the
        probe touches the sidecar until re-promotion."""
        return self._state == CLOSED

    @property
    def state(self) -> str:
        return self._state

    # -- outcome accounting (TPUSolver's wire ladder calls these) ------------
    def record_success(self) -> None:
        with self._lock:
            self._consecutive = 0

    def record_failure(self) -> bool:
        """Count one wire failure; returns True when this one tripped the
        breaker open."""
        with self._lock:
            self._consecutive += 1
            if self._state == CLOSED and self._consecutive >= self.failure_threshold:
                self._open_locked(
                    "solver wire breaker OPEN",
                    consecutive_failures=self._consecutive,
                )
                return True
            return False

    def force_open(self, reason: str = "") -> None:
        """Trip the breaker regardless of the consecutive-failure count --
        the stuck-tick watchdog's escalation rung (karpenter_tpu/
        overload.py): a wedged solve the finish-level failure accounting
        never sees (it only advances when a wire call RETURNS) must still
        stop regular traffic touching the wire. Same transition machinery
        as record_failure (_open_locked), so probes, backoff, and
        recovery (supervised probe + catalog re-stage) behave
        identically."""
        with self._lock:
            if self._state != CLOSED:
                return  # already open/half-open: the ladder is running
            self._consecutive = max(self._consecutive, self.failure_threshold)
            self._open_locked(
                "solver wire breaker FORCED OPEN",
                reason=reason or "watchdog escalation",
            )

    def _open_locked(self, log_msg: str, **log_fields) -> None:
        """THE open-transition body (caller holds the lock), shared by
        the counted trip and the watchdog's forced trip so the two can
        never drift on probe scheduling or backoff seeding."""
        self._transition(OPEN)
        self.trips += 1
        self._opened_at = self._clock()
        self._backoff = self.backoff_base
        self._schedule_probe()
        self.log.warning(
            log_msg,
            next_probe_in_s=round(self._next_probe_at - self._clock(), 3),
            **log_fields,
        )
        if self.auto_probe:
            self._ensure_probe_thread()
        self._wake.set()

    # -- probing / recovery ---------------------------------------------------
    def maybe_probe(self) -> bool:
        """Run the half-open probe if one is due (clock-driven; the
        deterministic rig's entry point). Returns True when the probe
        promoted the breaker back to CLOSED."""
        with self._lock:
            if self._state == CLOSED or self._probing:
                return False
            if self._next_probe_at is not None and self._clock() < self._next_probe_at:
                return False
        return self.probe_now()

    def probe_now(self) -> bool:
        """Force one probe regardless of the backoff schedule (supervised
        recovery: an operator who KNOWS the sidecar is back re-tests
        immediately)."""
        with self._lock:
            if self._state == CLOSED:
                return True
            if self._probing:
                return False
            self._probing = True
            self._transition(HALF_OPEN)
        ok = False
        try:
            ok = bool(self._probe()) if self._probe is not None else False
        except Exception:  # noqa: BLE001 -- a probe failure is data, not a crash
            ok = False
        if ok and self._on_promote is not None:
            # the re-stage gate runs BEFORE traffic re-enters: close the
            # stale client connection so the first post-promotion solve
            # reconnects and re-stages the catalog
            try:
                self._on_promote()
            except Exception as e:  # noqa: BLE001
                self.log.warning(
                    "breaker promotion hook failed; promoting anyway "
                    "(the next wire solve reconnects and re-stages)",
                    error=f"{type(e).__name__}: {e}"[:200],
                )
        with self._lock:
            self._probing = False
            if ok:
                self.probes_ok += 1
                self.promotions += 1
                self._consecutive = 0
                self._transition(CLOSED)
                metrics.BREAKER_PROBES.inc(outcome="success")
                self.log.info("solver wire breaker CLOSED: probe succeeded, catalog will re-stage")
            else:
                self.probes_failed += 1
                self._transition(OPEN)
                self._backoff = min(self.backoff_max, self._backoff * 2.0)
                self._schedule_probe()
                metrics.BREAKER_PROBES.inc(outcome="failure")
                self.log.info(
                    "solver wire probe failed; breaker stays open",
                    next_probe_in_s=round(self._next_probe_at - self._clock(), 3),
                )
        return ok

    def _schedule_probe(self) -> None:
        # caller holds the lock. Jittered exponential backoff: +0..50% so
        # many controllers recovering against one sidecar spread their
        # probes instead of thundering in lockstep
        self._next_probe_at = self._clock() + self._backoff * (1.0 + 0.5 * self._rng())

    def _transition(self, to: str) -> None:
        # caller holds the lock
        if self._state != to:
            metrics.BREAKER_TRANSITIONS.inc(to=to)
        self._state = to
        self._set_state_gauge(to)

    @staticmethod
    def _set_state_gauge(cur: str) -> None:
        for s in (CLOSED, OPEN, HALF_OPEN):
            metrics.BREAKER_STATE.set(1.0 if s == cur else 0.0, state=s)

    # -- background probe loop (wall-clock deployments) -----------------------
    def _ensure_probe_thread(self) -> None:
        # caller holds the lock
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(
                target=self._probe_loop, daemon=True, name="breaker-probe"
            )
            self._thread.start()

    def _probe_loop(self) -> None:
        while not self._stop.is_set():
            if self._state == CLOSED:
                self._wake.wait(timeout=0.5)
                self._wake.clear()
                continue
            with self._lock:
                due = self._next_probe_at if self._next_probe_at is not None else self._clock()
                wait = max(0.0, due - self._clock())
            if wait > 0:
                if self._stop.wait(timeout=min(wait, 0.5)):
                    return
                continue
            self.maybe_probe()

    def stop(self) -> None:
        self._stop.set()
        self._wake.set()

    # -- observability --------------------------------------------------------
    def describe(self) -> dict:
        """Breaker state document for /debug/breaker and /healthz."""
        with self._lock:
            now = self._clock()
            return {
                "state": self._state,
                "consecutive_failures": self._consecutive,
                "failure_threshold": self.failure_threshold,
                "trips": self.trips,
                "open_for_s": (
                    round(now - self._opened_at, 3)
                    if self._state != CLOSED and self._opened_at is not None else None
                ),
                "next_probe_in_s": (
                    round(max(0.0, self._next_probe_at - now), 3)
                    if self._state != CLOSED and self._next_probe_at is not None else None
                ),
                "backoff_s": round(self._backoff, 3),
                "probes": {"ok": self.probes_ok, "failed": self.probes_failed},
                "promotions": self.promotions,
            }
