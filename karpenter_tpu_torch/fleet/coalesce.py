"""Cross-tenant dispatch coalescer: N clusters, one solver process.

The rpc sidecar already isolates tenants at the STAGING layer -- catalogs
stage under per-connection seqnums, class epochs under client-unique ids.
What it lacked was a dispatch policy: N operator replicas solving
concurrently each grabbed a handler thread and raced into the device,
so one storming cluster could queue everyone behind its solves and one
erroring cluster could burn every handler's retry budget.

This coalescer is that policy. Concurrent submissions batch into shared
dispatch WINDOWS drained by one dispatcher thread:

- **deterministic tenant ordering** -- a window's submissions dispatch
  sorted by (tenant id, per-tenant arrival seq), so device occupancy per
  window is a pure function of what was queued, never of thread timing;
  each tenant's solve is a pure function of its own tensors, which is
  why ``multi-tenant == isolated`` holds bit-exactly (differential sim
  replay, sim/fleet.py);
- **per-tenant deadline budgets** -- each tenant gets a wall budget per
  solve (`budget_s`); a submission still queued past its deadline is
  refused with a typed `TenantRefusal` instead of dispatched late. The
  refusal crosses the wire as an error reply, which the client's solve
  ladder surfaces as RuntimeError -- the same rung the existing overload
  ladder (breaker accounting + the in-process rung,
  ``TorchSolver._finish_remote``) already terminates;
- **per-tenant breaker/degrade** -- `breaker_threshold` consecutive
  dispatch failures open that tenant's breaker for `breaker_cooldown_s`;
  its submissions then refuse FAST (no queue slot, no device time) while
  every other tenant dispatches normally. One sick cluster never poisons
  another: a tenant's failure is recorded on ITS submission and its
  breaker only (tests/test_tenant.py drills a mid-coalesce sidecar kill
  and a one-tenant corrupt frame).

The dispatcher swallows NOTHING silently: every per-submission exception
is captured into that submission's outcome and re-raised in the
submitting thread (the LADDER_SEAMS entry for `_run_one` pins the
contract; `OperatorCrashed` is a BaseException and still propagates).

Copy of karpenter_tpu/fleet/coalesce.py, imports rewritten to the port's.
The coalescer adds no arithmetic: its closures are the sidecar's op
handlers, so on the card the dispatcher thread launches kernel A (the
FFD scan) and kernel B (the repack) for every tenant in turn. In the
port a refused tenant's terminal rung is the in-process kernels on the
card, not a host fallback (ROADMAP section C); the decisions are the same.
"""
from __future__ import annotations

import itertools
import threading
import time
from typing import Callable, Dict, List, Optional

from karpenter_tpu_torch import failpoints, metrics

# one dispatch window's coalescing wait: long enough that replicas whose
# ticks align land in one batch, short enough to be invisible against a
# multi-ms solve
DEFAULT_WINDOW_S = 0.0005
DEFAULT_BREAKER_THRESHOLD = 4
DEFAULT_BREAKER_COOLDOWN_S = 5.0


class TenantRefusal(RuntimeError):
    """A typed per-tenant refusal (deadline blown while queued, or the
    tenant's breaker is open). Crosses the wire as an error reply; the
    client's solve ladder raises it as RuntimeError into the caller's
    existing degrade rungs (breaker + the in-process rung)."""

    def __init__(self, tenant: str, reason: str):
        super().__init__(f"tenant {tenant or '<default>'} refused: {reason}")
        self.tenant = tenant
        self.reason = reason


class _TenantState:
    __slots__ = ("tenant", "failures", "open_until", "seq")

    def __init__(self, tenant: str):
        self.tenant = tenant
        self.failures = 0
        self.open_until = 0.0
        self.seq = itertools.count()


class _Submission:
    __slots__ = ("tenant", "seq", "fn", "deadline", "done", "result", "error")

    def __init__(self, tenant: str, seq: int, fn: Callable, deadline: Optional[float]):
        self.tenant = tenant
        self.seq = seq
        self.fn = fn
        self.deadline = deadline
        self.done = threading.Event()
        self.result = None
        self.error: Optional[BaseException] = None


class DispatchCoalescer:
    """Batch concurrent per-tenant solve closures into shared dispatch
    windows on one dispatcher thread. See the module docstring for the
    policy; `submit` is the only entry point handler threads use."""

    def __init__(
        self, *,
        window_s: float = DEFAULT_WINDOW_S,
        budget_s: float = 0.0,
        breaker_threshold: int = DEFAULT_BREAKER_THRESHOLD,
        breaker_cooldown_s: float = DEFAULT_BREAKER_COOLDOWN_S,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.window_s = float(window_s)
        # 0 = unbounded (deterministic tests and the default sidecar; the
        # fleet deployment sizes it from the tick deadline, docs/operations.md)
        self.budget_s = float(budget_s)
        self.breaker_threshold = int(breaker_threshold)
        self.breaker_cooldown_s = float(breaker_cooldown_s)
        self._clock = clock
        self._cv = threading.Condition()
        self._queue: List[_Submission] = []
        self._states: Dict[str, _TenantState] = {}
        self._closed = False
        self._thread: Optional[threading.Thread] = None
        # observability for the last drained window (bench's fleet stage)
        self.last_window = {"batch": 0, "tenants": 0}

    # -- tenant state ---------------------------------------------------------
    def _state(self, tenant: str) -> _TenantState:
        st = self._states.get(tenant)
        if st is None:
            st = self._states[tenant] = _TenantState(tenant)
        return st

    def tenant_open(self, tenant: str) -> bool:
        """True while the tenant's breaker is open (its submissions refuse
        fast). Reads under the condition lock for a consistent snapshot."""
        with self._cv:
            return self._state(tenant).open_until > self._clock()

    def describe(self) -> dict:
        with self._cv:
            now = self._clock()
            return {
                "queued": len(self._queue),
                "tenants": {
                    t: {
                        "failures": st.failures,
                        "breaker_open": st.open_until > now,
                    }
                    for t, st in sorted(self._states.items())
                },
                "last_window": dict(self.last_window),
            }

    # -- submission -----------------------------------------------------------
    def submit(self, tenant: str, fn: Callable, *, budget_s: Optional[float] = None):
        """Run `fn` inside a coalesced dispatch window; blocks until its
        window drains and returns fn's result (or re-raises its error in
        THIS thread). Raises TenantRefusal without queueing when the
        tenant's breaker is open."""
        tenant = str(tenant or "")
        budget = self.budget_s if budget_s is None else float(budget_s)
        with self._cv:
            if self._closed:
                raise TenantRefusal(tenant, "coalescer closed")
            st = self._state(tenant)
            now = self._clock()
            if st.open_until:
                if st.open_until > now:
                    metrics.TENANT_REFUSALS.inc(tenant=tenant, reason="breaker-open")
                    raise TenantRefusal(tenant, "breaker open")
                # cooldown elapsed: the breaker is CLOSED again -- clear the
                # state and its gauge here, not only on the next success, so
                # an idle (or still-flaky) tenant never reads as open while
                # its solves actually dispatch
                st.open_until = 0.0
                metrics.TENANT_BREAKER_STATE.set(0.0, tenant=tenant)
            sub = _Submission(
                tenant, next(st.seq), fn,
                (now + budget) if budget > 0 else None,
            )
            self._queue.append(sub)
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._loop, daemon=True, name="fleet-coalescer",
                )
                self._thread.start()
            self._cv.notify_all()
        sub.done.wait()
        if sub.error is not None:
            raise sub.error
        return sub.result

    def close(self) -> None:
        """Stop accepting work and fail anything still queued (the
        sidecar's stop path): queued submitters must unblock, not hang
        on a window that will never drain."""
        with self._cv:
            self._closed = True
            queued, self._queue = self._queue, []
            self._cv.notify_all()
        for sub in queued:
            sub.error = TenantRefusal(sub.tenant, "coalescer closed")
            sub.done.set()

    # -- the dispatcher -------------------------------------------------------
    def _loop(self) -> None:
        while True:
            with self._cv:
                while not self._queue and not self._closed:
                    self._cv.wait()
                if self._closed and not self._queue:
                    return
            # coalescing wait OUTSIDE the lock: submissions arriving in
            # this window join the batch
            if self.window_s > 0:
                time.sleep(self.window_s)
            with self._cv:
                batch, self._queue = self._queue, []
            if not batch:
                continue
            # deterministic tenant ordering: device occupancy per window
            # is a pure function of the queued set
            batch.sort(key=lambda s: (s.tenant, s.seq))
            self.last_window = {
                "batch": len(batch),
                "tenants": len({s.tenant for s in batch}),
            }
            metrics.TENANT_WINDOW_SIZE.observe(float(len(batch)))
            for i, sub in enumerate(batch):
                try:
                    self._run_one(sub)
                except BaseException as e:  # noqa: BLE001 -- sanctioned crash terminal
                    # SANCTIONED_CRASH_SWALLOWS site (checkers/errflow.py):
                    # a crash (OperatorCrashed and kin) TERMINATES the
                    # dispatcher here -- the sidecar's dispatcher has no
                    # run-loop driver above it to propagate to, and an
                    # unhandled daemon-thread death would silently wedge
                    # every queued and future submission instead. The
                    # propagation contract is behavioral: every remaining
                    # batch member fails with a typed refusal (its handler
                    # replies and that client degrades to its in-process
                    # rung), the coalescer CLOSES so future submits
                    # refuse fast, the crash is logged + counted, and the
                    # thread exits.
                    from karpenter_tpu_torch.logging import get_logger

                    for rest in batch[i + 1:]:
                        rest.error = TenantRefusal(
                            rest.tenant, "dispatcher crashed mid-window"
                        )
                        rest.done.set()
                    self.close()
                    metrics.HANDLED_ERRORS.inc(site="fleet.coalesce.dispatcher")
                    get_logger("fleet").error(
                        "tenant dispatcher crashed; coalescer closed "
                        "(tenants degrade to their in-process rungs)",
                        error=f"{type(e).__name__}: {e}"[:200],
                    )
                    return

    def _run_one(self, sub: _Submission) -> None:
        """One submission's dispatch, fault-isolated per tenant: every
        Exception becomes THIS submission's outcome (re-raised in its
        submitting thread) and this tenant's breaker accounting -- never
        an escape that kills the dispatcher or poisons the rest of the
        window. OperatorCrashed (BaseException) still propagates: a
        supervised crash must reach the run loop."""
        t0 = self._clock()
        try:
            # the tenant-dispatch chaos seam (LADDER_SEAMS): drills inject
            # dispatch-time faults here -- a mid-coalesce sidecar kill, a
            # wedged device -- and the soak asserts no cross-tenant drift
            failpoints.eval("fleet.dispatch")
            if sub.deadline is not None and self._clock() > sub.deadline:
                metrics.TENANT_REFUSALS.inc(tenant=sub.tenant, reason="deadline")
                raise TenantRefusal(sub.tenant, "deadline blown while queued")
            sub.result = sub.fn()
        except TenantRefusal as e:
            # deadline shedding is LOAD policy, not dispatch evidence: a
            # refusal caused by a congested neighbor must not trip the
            # victim's breaker (that would be exactly the cross-tenant
            # poisoning the breaker exists to prevent). The refusals
            # counter above already recorded it.
            sub.error = e
        except Exception as e:  # noqa: BLE001 -- captured into the outcome
            sub.error = e
            metrics.TENANT_DISPATCHES.inc(tenant=sub.tenant, outcome="error")
            self._record_failure(sub.tenant)
        except BaseException as e:
            # OperatorCrashed: the submitter gets a CONVERTED typed
            # refusal (its handler replies an error frame; its client
            # degrades to the in-process rung) while the original propagates to
            # _loop's sanctioned crash terminal, which closes the
            # coalescer
            sub.error = TenantRefusal(
                sub.tenant, f"dispatcher crashed: {type(e).__name__}"
            )
            metrics.TENANT_DISPATCHES.inc(tenant=sub.tenant, outcome="error")
            raise
        else:
            metrics.TENANT_DISPATCHES.inc(tenant=sub.tenant, outcome="ok")
            self._record_success(sub.tenant)
        finally:
            metrics.TENANT_DISPATCH_SECONDS.observe(
                max(self._clock() - t0, 0.0), tenant=sub.tenant
            )
            sub.done.set()

    def _record_failure(self, tenant: str) -> None:
        with self._cv:
            st = self._state(tenant)
            st.failures += 1
            if st.failures >= self.breaker_threshold:
                st.open_until = self._clock() + self.breaker_cooldown_s
                st.failures = 0
                metrics.TENANT_BREAKER_STATE.set(1.0, tenant=tenant)
                metrics.TENANT_BREAKER_TRIPS.inc(tenant=tenant)

    def _record_success(self, tenant: str) -> None:
        with self._cv:
            st = self._state(tenant)
            st.failures = 0
            if st.open_until:
                st.open_until = 0.0
            metrics.TENANT_BREAKER_STATE.set(0.0, tenant=tenant)
