"""Overload control: tick deadline budgets, shedding, brownout, watchdog.

Every robustness layer before this one defends against component FAILURE
(the breaker, the crash journal, the chaos soaks); none defends against
sustained OVERLOAD: an arrival storm past solver capacity just grows the
pending set and stretches ticks unboundedly. This module gives the
operator tick a degraded-but-predictable mode instead, four pieces:

- ``TickBudget`` -- a per-tick deadline (``Options.tick_deadline`` /
  ``--tick-deadline``) decomposed hierarchically into stage budgets on
  the PR-2 trace span boundaries (snapshot/encode/wire/device/decode/
  bind), threaded through the sweep as a thread-local so deep layers
  (the solver wire's read timeout, the provisioner's admission sizing)
  can shed work EARLY instead of timing out late;
- bounded admission with priority-aware shedding lives in the
  provisioner (``Provisioner._admit``): when a tick cannot solve the
  whole pending set within budget it solves a deterministic
  priority/age-ordered PREFIX and defers the rest
  (``karpenter_overload_shed_total``) -- deferred pods stay pending, so
  nothing is lost, only delayed;
- ``BrownoutController`` -- a fixed, documented shed ladder above the
  transport degrade ladder, driven by an EWMA of tick-budget overrun:
  (1) consolidation/disruption sweeps downgrade to a bounded
  singleton-only device pass (or stand down when no device engine is
  wired), (2) trace sampling
  stops feeding the stats/metrics volume, (3) delta-epoch staging (and
  its restage retry roundtrips) stands down. Recovery is hysteretic
  (exit threshold below the enter threshold, plus a dwell) so the
  ladder never flaps tick to tick;
- ``StuckTickWatchdog`` -- detects a tick wedged past N x deadline (the
  solver hang the breaker's finish-level failure counter never sees)
  and escalates through a fixed ladder: cancel the wire (unblocks ring
  waits and forces the degrade ladder), force the breaker open (regular
  traffic stops touching the wire), and finally an async-raised
  ``OperatorCrashed`` into the stuck thread -- the PR-6 recovery sweep
  then takes over exactly as for any other crash.

Everything is OFF at ``tick_deadline == 0`` (the default): no budget, no
brownout, no watchdog, bit-identical behavior to the pre-overload tree.
The deterministic shedding knob (``Options.admission_max_pods``) works
with or without a deadline, which is what the sim's overload-storm
scenario pins byte-deterministically.

Copy of karpenter_tpu/overload.py, imports rewritten to the port's.
"""
from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from typing import Callable, Optional

from karpenter_tpu_torch import metrics
from karpenter_tpu_torch.logging import get_logger

# hierarchical stage decomposition of one tick deadline, on the PR-2
# trace span boundaries. Fractions are budget CEILINGS, not predictions:
# a stage that finishes early donates its slack to everything after it
# (stage_deadline() is min(ceiling, remaining)).
STAGE_FRACTIONS = {
    "snapshot": 0.10,
    "encode": 0.15,
    "wire": 0.20,
    "device": 0.25,
    "decode": 0.15,
    "bind": 0.15,
}
# the solve share of a tick (everything between snapshot and bind): the
# admission sizing divides this by the EWMA per-pod solve cost
SOLVE_FRACTION = (
    STAGE_FRACTIONS["encode"] + STAGE_FRACTIONS["wire"]
    + STAGE_FRACTIONS["device"] + STAGE_FRACTIONS["decode"]
)


class TickBudget:
    """One tick's deadline budget on a monotonic clock. Cheap by design
    (two floats); constructed at tick start, consulted by whoever wants
    to shed early."""

    __slots__ = ("deadline", "started", "_clock")

    def __init__(self, deadline: float, clock: Callable[[], float] = time.monotonic):
        self.deadline = float(deadline)
        self._clock = clock
        self.started = clock()

    def elapsed(self) -> float:
        return self._clock() - self.started

    def remaining(self) -> float:
        return self.deadline - self.elapsed()

    def overrun(self) -> float:
        """elapsed / deadline: < 1 inside budget, > 1 blown."""
        return self.elapsed() / self.deadline if self.deadline > 0 else 0.0

    def stage_budget(self, stage: str) -> float:
        """The stage's budget ceiling (its fraction of the deadline)."""
        return STAGE_FRACTIONS.get(stage, 1.0) * self.deadline

    def stage_deadline(self, stage: str) -> float:
        """Seconds this stage may still spend: its ceiling or whatever is
        left of the whole tick, whichever is smaller -- floored so a
        nearly-blown budget degrades (short timeouts -> the ladder) but
        never hands a zero/negative timeout to a transport."""
        floor = max(0.05, 0.1 * self.deadline)
        return max(floor, min(self.stage_budget(stage), self.remaining()))

    def solve_budget(self) -> float:
        """Seconds the solve stages (encode+wire+device+decode) may still
        spend this tick -- the admission sizing's numerator."""
        return max(0.0, min(SOLVE_FRACTION * self.deadline, self.remaining()))


# -- thread-local active budget ------------------------------------------------
#
# The budget rides the sweep as a thread-local (the same shape as the
# tracer's current-span context): the operator pushes it around the tick
# body, and deep layers -- the solver client's read-timeout clamp, the
# provisioner's admission sizing -- read it without any parameter
# threading through ~10 call layers.

_local = threading.local()


@contextmanager
def active(budget: Optional[TickBudget]):
    """Install `budget` as THIS thread's active tick budget for the
    duration (None = no budget: every consumer behaves exactly as before
    the overload subsystem existed)."""
    prev = getattr(_local, "budget", None)
    _local.budget = budget
    try:
        yield budget
    finally:
        _local.budget = prev


def current() -> Optional[TickBudget]:
    return getattr(_local, "budget", None)


def clamp_timeout(default: float) -> float:
    """The read budget a blocking wire call should use: the caller's
    default, clamped to the active tick budget's REMAINING time (floored
    like stage_deadline, so a nearly-blown budget degrades rather than
    hands out a zero timeout). The whole remainder, not the wire stage's
    ceiling: the client-side read wait spans wire + device compute +
    fetch, and the shed criterion is "the TICK cannot afford to keep
    waiting", not one stage's share. No active budget = the default,
    untouched. A clamped timeout expiring surfaces as the same
    timeout/ConnectionError every degrade ladder already handles -- the
    tick sheds the wire EARLY instead of blowing its deadline waiting."""
    budget = current()
    if budget is None:
        return default
    floor = max(0.05, 0.1 * budget.deadline)
    return min(default, max(floor, budget.remaining()))


# -- brownout ladder -----------------------------------------------------------

class BrownoutController:
    """Sheds optional work in a FIXED documented order under sustained
    deadline pressure, recovering hysteretically. Levels:

        0 normal           -- nothing shed
        1 shed-disruption  -- consolidation/disruption sweeps downgrade:
                              with the batched device engine wired
                              (solver/disrupt/), the sweep runs a BOUNDED
                              singleton-only device pass (one dispatch
                              over the cheapest candidates, deletion
                              verdicts only) -- cheap enough to leave on;
                              without it, the sweep stands down entirely
                              (controllers/disruption.py gates on this)
        2 shed-tracing     -- trace sampling stops feeding the per-span
                              stats/metrics volume, and an armed
                              jax.profiler capture (obs/profiler.py)
                              defers -- profiling has a real device-side
                              cost and must not deepen the overload it
                              would diagnose. The slow-tick trace
                              recorder still judges every sweep, and the
                              flight-data recorder (obs/flight.py) keeps
                              writing its per-tick record on EVERY rung:
                              it is the black box, and the ticks that
                              caused the brownout must stay visible
        3 shed-delta       -- delta-epoch class staging stands down (the
                              wire ships full; no staging diffs, no
                              restage retry roundtrips; bit-identical by
                              construction)

    Driven by an EWMA of tick overrun (tick duration / deadline): one
    rung per transition, entered at ``enter`` (default: ticks exceed the
    deadline on average), exited at ``exit`` (default: half the
    deadline), with a ``dwell`` of ticks between transitions so the
    ladder cannot flap. Level reads are lock-free (int store)."""

    LEVELS = ("normal", "shed-disruption", "shed-tracing", "shed-delta")
    log = get_logger("brownout")

    def __init__(self, deadline: float, enter: float = 1.0, exit: float = 0.5,
                 alpha: float = 0.3, dwell: int = 3):
        self.deadline = float(deadline)
        self.enter = float(enter)
        self.exit = float(exit)
        self.alpha = float(alpha)
        self.dwell = int(dwell)
        self._lock = threading.Lock()
        self._ewma: Optional[float] = None
        self._level = 0
        self._dwell_left = 0
        self.transitions = 0
        metrics.OVERLOAD_BROWNOUT_LEVEL.set(0.0)

    # -- pressure input (the operator calls this once per tick) --------------
    def observe(self, tick_seconds: float) -> int:
        """Feed one finished tick's duration; returns the (possibly new)
        level. Transition side effects (tracer throttle, metrics, log)
        run OUTSIDE the lock -- they touch other subsystems' locks."""
        ratio = tick_seconds / self.deadline if self.deadline > 0 else 0.0
        metrics.OVERLOAD_TICK_OVERRUN.observe(ratio)
        changed = False
        with self._lock:
            self._ewma = (
                ratio if self._ewma is None
                else (1.0 - self.alpha) * self._ewma + self.alpha * ratio
            )
            if self._dwell_left > 0:
                self._dwell_left -= 1
            elif self._ewma >= self.enter and self._level < len(self.LEVELS) - 1:
                self._level += 1
                changed = True
            elif self._ewma <= self.exit and self._level > 0:
                self._level -= 1
                changed = True
            if changed:
                self._dwell_left = self.dwell
                self.transitions += 1
            level, ewma = self._level, self._ewma
        if changed:
            self._apply(level, ewma)
        return level

    def _apply(self, level: int, ewma: float) -> None:
        from karpenter_tpu_torch import tracing
        from karpenter_tpu_torch.obs import profiler as obs_profiler

        metrics.OVERLOAD_BROWNOUT_LEVEL.set(float(level))
        metrics.OVERLOAD_BROWNOUT_TRANSITIONS.inc(to=self.LEVELS[level])
        # rung 2's effect applies on the transition edge in both
        # directions: throttle keeps the configured sample rate around
        # for the hysteretic recovery (tracing.Tracer.set_throttled).
        # The profiler capture throttles on the same edge -- an armed
        # capture defers and resumes when the ladder recovers. The
        # flight-data recorder is deliberately NOT on this rung.
        tracing.TRACER.set_throttled(level >= 2)
        obs_profiler.PROFILER.set_throttled(level >= 2)
        self.log.warning(
            "brownout ladder transition",
            ladder_level=self.LEVELS[level], overrun_ewma=round(ewma, 3),
        )

    # -- level reads (lock-free: int stores are atomic in CPython) ------------
    @property
    def level(self) -> int:
        return self._level

    def sheds_disruption(self) -> bool:
        return self._level >= 1

    def sheds_tracing(self) -> bool:
        return self._level >= 2

    def sheds_delta(self) -> bool:
        return self._level >= 3

    def describe(self) -> dict:
        """Brownout state document for /debug/overload."""
        with self._lock:
            return {
                "level": self._level,
                "level_name": self.LEVELS[self._level],
                "overrun_ewma": round(self._ewma, 4) if self._ewma is not None else None,
                "enter_threshold": self.enter,
                "exit_threshold": self.exit,
                "dwell_ticks_left": self._dwell_left,
                "transitions": self.transitions,
                "sheds": {
                    "disruption": self._level >= 1,
                    "tracing": self._level >= 2,
                    "delta": self._level >= 3,
                },
            }


# process-wide brownout handle, installed by the last-constructed
# Operator (the same process-policy shape as tracing.TRACER and the
# metrics registry; None = no brownout configured). Module-level so the
# solver client's delta shed needs no plumbing through ~6 layers.
_BROWNOUT: Optional[BrownoutController] = None


def install_brownout(ctrl: Optional[BrownoutController]) -> None:
    global _BROWNOUT
    _BROWNOUT = ctrl
    from karpenter_tpu_torch import tracing
    from karpenter_tpu_torch.obs import profiler as obs_profiler

    # the tracer/profiler throttles follow the INSTALLED brownout's
    # state: a new Operator replacing a mid-brownout one (tests,
    # restarts) must not inherit a stuck throttle from the previous reign
    throttled = ctrl is not None and ctrl.sheds_tracing()
    tracing.TRACER.set_throttled(throttled)
    obs_profiler.PROFILER.set_throttled(throttled)


def brownout() -> Optional[BrownoutController]:
    return _BROWNOUT


def sheds_delta() -> bool:
    """True while the brownout ladder's rung 3 is active (the solver
    client checks this per solve and ships full instead of delta)."""
    ctrl = _BROWNOUT
    return ctrl is not None and ctrl.sheds_delta()


# -- stuck-tick watchdog -------------------------------------------------------

def _async_raise_crash(thread_id: int) -> bool:
    """Raise OperatorCrashed INSIDE the (wedged) thread `thread_id` via
    the CPython async-exception hook. The exception lands at the
    thread's next bytecode boundary -- which is why the `stall`
    failpoint action sleeps in slices instead of one long sleep."""
    import ctypes

    from karpenter_tpu_torch.failpoints import OperatorCrashed

    n = ctypes.pythonapi.PyThreadState_SetAsyncExc(
        ctypes.c_ulong(thread_id), ctypes.py_object(OperatorCrashed)
    )
    if n > 1:
        # invalid/ambiguous target: undo rather than poison another thread
        ctypes.pythonapi.PyThreadState_SetAsyncExc(ctypes.c_ulong(thread_id), None)
        return False
    return n == 1


class StuckTickWatchdog:
    """Detects a tick wedged past N x deadline and escalates through a
    fixed ladder -- the failure mode the breaker cannot see: its
    finish-level failure counter only advances when a wire call RETURNS,
    and a truly wedged solve (a hung device tunnel, a stalled stage
    inside the read timeout) never returns.

        cancel       (default  4 x deadline) -- close the solver wire:
                     a blocked ring wait sees the closed flag and raises,
                     a blocked socket read dies with its fd; either way
                     the solve ladder degrades and the tick completes
        breaker-open (default  8 x deadline) -- force the breaker open so
                     regular traffic stops touching the wire at all
        crash        (default 16 x deadline) -- async-raise
                     OperatorCrashed into the stuck thread; the run-loop
                     driver (or the process supervisor) restarts the
                     operator and the PR-6 recovery sweep takes over

    Deterministic rigs drive ``check_now()`` from their own loop; the
    production binary runs the background thread (``start()``)."""

    STAGES = ("cancel", "breaker-open", "crash")
    log = get_logger("watchdog")

    def __init__(self, deadline: float, *, cancel: Optional[Callable[[], None]] = None,
                 breaker=None, multiples=(4.0, 8.0, 16.0),
                 clock: Callable[[], float] = time.monotonic):
        self.deadline = float(deadline)
        self.multiples = tuple(float(m) for m in multiples)
        self._cancel = cancel
        self._breaker = breaker
        self._clock = clock
        self._lock = threading.Lock()
        self._started: Optional[float] = None
        self._thread_id: Optional[int] = None
        self._stage = 0
        # tick generation: bumps on every tick_started, so the crash
        # escalation can re-verify under the lock that the SAME tick is
        # still wedged immediately before the async raise (a tick that
        # un-wedged in the window between decision and raise must not
        # get OperatorCrashed injected into a now-healthy loop)
        self._generation = 0
        self.escalations = {s: 0 for s in self.STAGES}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- tick bracketing (called by Operator.tick on the loop thread) ---------
    def tick_started(self) -> None:
        with self._lock:
            self._started = self._clock()
            self._thread_id = threading.get_ident()
            self._stage = 0
            self._generation += 1

    def tick_finished(self) -> None:
        with self._lock:
            self._started = None
            self._stage = 0

    # -- escalation ----------------------------------------------------------
    def check_now(self) -> Optional[str]:
        """Evaluate the ladder once; returns the stage name fired, or
        None. The cancel/breaker hooks run OUTSIDE the lock (they take
        other subsystems' locks: the client's, the breaker's); the crash
        raise alone runs UNDER it -- see the comment at that rung."""
        with self._lock:
            if self._started is None or self._stage >= len(self.STAGES):
                return None
            elapsed = self._clock() - self._started
            if elapsed < self.multiples[self._stage] * self.deadline:
                return None
            stage = self._stage
            self._stage += 1
            tid = self._thread_id
            gen = self._generation
        name = self.STAGES[stage]
        if name == "crash":
            # flush the flight-data black box BEFORE the raise, from this
            # (the watchdog's own) thread: the wedged tick may never reach
            # a bytecode boundary (a C-level hang), in which case the
            # async exception never lands and the tick-side
            # OperatorCrashed flush never runs -- and once the raise is
            # pending, nothing after it in THIS thread is guaranteed
            # either (deterministic rigs drive check_now from the tick
            # thread itself)
            try:
                from karpenter_tpu_torch.obs import flight

                flight.flush_blackbox(reason="watchdog-crash")
            except Exception:  # noqa: BLE001 -- best-effort, like cancel
                metrics.HANDLED_ERRORS.inc(site="overload.watchdog.flush")
            # re-check AND raise under the lock: tick_finished takes this
            # same lock, so the exception is pending in the wedged thread
            # before the tick can possibly be marked finished -- a tick
            # that un-wedged first stands the escalation down instead of
            # crashing a healthy loop. The raise itself takes no other
            # locks (one C call), so holding the lock across it is safe.
            with self._lock:
                still_wedged = (
                    self._started is not None and self._generation == gen
                    and tid is not None
                )
                if still_wedged:
                    _async_raise_crash(tid)
            if not still_wedged:
                self.log.warning(
                    "stuck tick un-wedged before the crash escalation; "
                    "standing down")
                return None
        self.escalations[name] += 1
        metrics.OVERLOAD_WATCHDOG.inc(stage=name)
        self.log.warning(
            "stuck-tick watchdog escalation",
            stage=name, elapsed_s=round(elapsed, 3), deadline_s=self.deadline,
        )
        if name == "cancel":
            if self._cancel is not None:
                try:
                    self._cancel()
                except Exception:  # noqa: BLE001 -- cancel is best-effort
                    metrics.HANDLED_ERRORS.inc(site="overload.watchdog.cancel")
        elif name == "breaker-open":
            if self._breaker is not None:
                try:
                    self._breaker.force_open(reason="stuck-tick watchdog")
                except Exception:  # noqa: BLE001 -- escalation is best-effort
                    metrics.HANDLED_ERRORS.inc(site="overload.watchdog.breaker")
        # (the crash rung already raised above, under the lock)
        return name

    # -- background loop (the wall-clock binary) ------------------------------
    def start(self) -> "StuckTickWatchdog":
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop, daemon=True, name="stuck-tick-watchdog"
            )
            self._thread.start()
        return self

    def _loop(self) -> None:
        interval = max(0.05, self.deadline / 2.0)
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
        return {
            "deadline_s": self.deadline,
            "multiples": list(self.multiples),
            "tick_active_for_s": active_s,
            "escalations": dict(self.escalations),
        }
