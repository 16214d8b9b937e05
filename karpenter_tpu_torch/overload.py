"""Overload control: the part the solver wire reads.

Copy of karpenter_tpu/overload.py, cut to what solver/rpc.py consults:

- ``TickBudget`` (its remaining time) and the thread-local active
  budget (``active``, ``current``): the operator pushes a per-tick
  deadline around the tick body, and deep layers read it without
  parameter threading;
- ``clamp_timeout``: the solver client clamps each roundtrip's read
  budget to the active tick budget's remaining time, so a tick that is
  going to blow its deadline fails the wire early into the degrade
  ladder instead of timing out late;
- ``sheds_delta``: true while the brownout controller's rung 3 is
  active; the client then ships the full class tensors instead of a
  delta.

The brownout ladder itself (``BrownoutController``, its stage budgets and
its installer), the admission shedding and the stuck-tick watchdog come
with the port's controllers. Until then no controller is installed and
``sheds_delta`` answers False. With no active budget (the default) every consumer behaves as if this
module did not exist.
"""
from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from typing import Callable, Optional


class TickBudget:
    """One tick's deadline budget on a monotonic clock (two floats)."""

    __slots__ = ("deadline", "started", "_clock")

    def __init__(self, deadline: float, clock: Callable[[], float] = time.monotonic):
        self.deadline = float(deadline)
        self._clock = clock
        self.started = clock()

    def elapsed(self) -> float:
        return self._clock() - self.started

    def remaining(self) -> float:
        return self.deadline - self.elapsed()


_local = threading.local()


@contextmanager
def active(budget: Optional[TickBudget]):
    """Install `budget` as THIS thread's active tick budget for the
    duration (None = no budget)."""
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
    default, clamped to the active tick budget's REMAINING time (floored,
    so a nearly-blown budget never hands a zero timeout to a transport).
    No active budget = the default, untouched. A
    clamped timeout expiring surfaces as the same timeout every degrade
    ladder already handles -- the tick sheds the wire early."""
    budget = current()
    if budget is None:
        return default
    floor = max(0.05, 0.1 * budget.deadline)
    return min(default, max(floor, budget.remaining()))


# the installed brownout controller (any object with ``sheds_delta()``);
# None until the port's operator brings the ladder
_BROWNOUT = None


def sheds_delta() -> bool:
    """True while the brownout ladder's rung 3 is active (the solver
    client checks this per solve and ships full instead of delta)."""
    ctrl = _BROWNOUT
    return ctrl is not None and ctrl.sheds_delta()
