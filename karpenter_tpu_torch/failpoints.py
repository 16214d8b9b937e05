"""Deterministic failpoint fault-injection framework.

Copy of karpenter_tpu/failpoints.py, whole: named sites compiled into the
production code paths, armed by environment variable or test fixture,
each seedable and countable, under the JAX package's site names and
environment variables so one runbook drills both packages:

    from karpenter_tpu_torch import failpoints
    failpoints.eval("convex.rounding")             # in production code

    FAILPOINTS.arm("convex.rounding", "error", "RuntimeError", times=1)
    KARPENTER_TPU_FAILPOINTS="rpc.convex.dispatch=error(RuntimeError):times=1"

The port's sites: ``solver.solve_begin`` / ``solver.solve_finish`` (the
two halves of a tick), ``rpc.convex.dispatch`` (the relaxation's
dispatch) and ``convex.rounding`` (the rounding); an armed fault there
costs the tick only its convex candidate (TorchSolver's FFD rung). The
wire's (solver/rpc.py, solver/shm.py), where the JAX package fires
them: ``rpc.client.connect``, ``rpc.send``, ``rpc.recv``, the byte-
stream sites ``rpc.frame.corrupt`` and ``rpc.shm.corrupt``,
``rpc.server.conn``, ``rpc.server.dispatch``, ``rpc.shm.attach`` and
``rpc.disrupt.dispatch``.

Actions:

- ``error(ExceptionName)`` -- raise (default ``ConnectionError``); cloud
  error types (``InsufficientCapacityError``, ...) resolve lazily from
  the port's ``karpenter_tpu_torch.errors``.
- ``latency(seconds)``     -- sleep before proceeding.
- ``corrupt``              -- flip one deterministic byte of a frame at a
  ``corrupt()`` site.
- ``drop``                 -- alias of ``error(ConnectionError)``.
- ``kill_after(N)``        -- pass through N evaluations, then raise on
  every one after.
- ``stall(seconds)``       -- a wedged stage: sleep the armed duration
  (default 60 s) in 10 ms slices so an async-raised ``OperatorCrashed``
  can land mid-stall.
- ``crash``                -- raise ``OperatorCrashed`` (a BaseException:
  no degrade rung may swallow it).

Modifiers (colon-separated after the action): ``times=M`` fire at most M
times; ``after=N`` skip the first N evaluations; ``p=F`` fire with
probability F from a per-site deterministic RNG (seeded by the registry
seed + site name, so a schedule replays bit-identically).

Disarmed cost is one module-attr read and one boolean check per site.
Every fire counts into ``karpenter_failpoints_fired_total{site,action}``
and the per-site ``hits``/``fires`` counters.
"""
from __future__ import annotations

import os
import random
import threading
import time
from typing import Dict, Optional

ENV = "KARPENTER_TPU_FAILPOINTS"
SEED_ENV = "KARPENTER_TPU_FAILPOINTS_SEED"

class OperatorCrashed(BaseException):
    """The `crash` action's payload: the operator process is GONE at this
    site. BaseException on purpose -- the controller stack's broad
    `except Exception` seams (launch fan-out, cloud-call wrapper, batcher
    executor) must not convert a process death into a handled cloud
    error; only the run loop that owns the operator may catch it."""


_BUILTIN_EXC = {
    "ConnectionError": ConnectionError,
    "ConnectionResetError": ConnectionResetError,
    "BrokenPipeError": BrokenPipeError,
    "OSError": OSError,
    "TimeoutError": TimeoutError,
    "RuntimeError": RuntimeError,
    "ValueError": ValueError,
    "KeyError": KeyError,
}


def _exception_class(name: Optional[str]):
    if not name:
        return ConnectionError
    if name in _BUILTIN_EXC:
        return _BUILTIN_EXC[name]
    # cloud error taxonomy resolves lazily (no import cycle with errors/)
    from karpenter_tpu_torch import errors

    cls = getattr(errors, name, None)
    if isinstance(cls, type) and issubclass(cls, BaseException):
        return cls
    raise ValueError(f"unknown failpoint exception type {name!r}")


class Failpoint:
    """One armed site: action + firing discipline + counters."""

    __slots__ = ("site", "action", "arg", "times", "after", "p",
                 "hits", "fires", "_rng", "_lock")

    def __init__(self, site: str, action: str, arg: Optional[str] = None, *,
                 times: Optional[int] = None, after: int = 0, p: float = 1.0,
                 seed: int = 0):
        if action not in ("error", "latency", "corrupt", "drop", "kill_after",
                          "crash", "stall"):
            raise ValueError(f"unknown failpoint action {action!r}")
        if action == "drop":
            action, arg = "error", (arg or "ConnectionError")
        if action == "kill_after":
            # pass N times, then fire forever: after=N, unbounded times
            action, after, times, arg = "error", int(arg or 0), None, None
        self.site = site
        self.action = action
        self.arg = arg
        self.times = times
        self.after = int(after)
        self.p = float(p)
        self.hits = 0   # evaluations while armed
        self.fires = 0  # times the action actually executed
        # seeded by (registry seed, site): a schedule replays identically
        # across processes regardless of PYTHONHASHSEED
        self._rng = random.Random(f"{seed}:{site}")
        self._lock = threading.Lock()

    @property
    def exhausted(self) -> bool:
        """True once the firing discipline can never fire again (a
        bounded ``times`` fully spent). Hot paths that pay a toll while a
        site COULD fire (e.g. the framing layer's joining copy) use this
        to stop paying once the drill is over."""
        return self.times is not None and self.fires >= self.times

    def _should_fire(self) -> bool:
        with self._lock:
            self.hits += 1
            if self.hits <= self.after:
                return False
            if self.times is not None and self.fires >= self.times:
                return False
            if self.p < 1.0 and self._rng.random() >= self.p:
                return False
            self.fires += 1
            return True

    def _corrupt_pos(self, span: int) -> int:
        with self._lock:
            return self._rng.randrange(span)


class FailpointRegistry:
    """Process-global site registry (the analogue of metrics.REGISTRY).

    ``armed`` is the fast-path flag: sites only pay a dict lookup when at
    least one failpoint is armed anywhere in the process."""

    def __init__(self, seed: int = 0):
        self._lock = threading.Lock()
        self._sites: Dict[str, Failpoint] = {}
        self.armed = False
        self.seed = seed
        # sites whose armed action kind mismatched the evaluation kind
        # (corrupt at an eval() site or vice versa) -- warned once each so
        # a misarmed drill is loud instead of silently never firing
        self._kind_warned: set = set()

    # -- arming ---------------------------------------------------------------
    def arm(self, site: str, action: str, arg: Optional[str] = None, *,
            times: Optional[int] = None, after: int = 0, p: float = 1.0) -> Failpoint:
        fp = Failpoint(site, action, arg, times=times, after=after, p=p,
                       seed=self.seed)
        with self._lock:
            self._sites[site] = fp
            self.armed = True
        return fp

    def arm_spec(self, text: str) -> None:
        """Arm from a spec string: ``site=action(arg):mod=value[;site2=...]``.

        Examples: ``rpc.client.connect=error(ConnectionError):times=5``,
        ``rpc.server.dispatch=latency(0.05):p=0.3``,
        ``rpc.frame.corrupt=corrupt:times=2``, ``rpc.server.conn=kill_after(3)``.
        """
        for pair in filter(None, (p.strip() for p in text.split(";"))):
            site, sep, spec = pair.partition("=")
            if not sep or not site.strip() or not spec.strip():
                raise ValueError(f"malformed failpoint spec {pair!r} "
                                 "(want site=action(arg):mod=value)")
            head, *mods = spec.strip().split(":")
            action, _, rest = head.partition("(")
            arg = rest[:-1] if rest.endswith(")") else (rest or None)
            kwargs: dict = {}
            for m in mods:
                k, msep, v = m.partition("=")
                if not msep or k not in ("times", "after", "p"):
                    raise ValueError(f"malformed failpoint modifier {m!r} in {pair!r}")
                kwargs[k] = float(v) if k == "p" else int(v)
            self.arm(site.strip(), action.strip(), arg or None, **kwargs)

    def arm_from_env(self, environ=os.environ) -> None:
        """Arm every site named in $KARPENTER_TPU_FAILPOINTS (seed from
        $KARPENTER_TPU_FAILPOINTS_SEED first, so sites built after it use
        it). A malformed spec fails LOUDLY -- a game-day drill armed with
        a typo'd site that silently never fires is worse than a crash."""
        seed = environ.get(SEED_ENV)
        if seed:
            self.seed = int(seed)
        spec = environ.get(ENV)
        if spec:
            self.arm_spec(spec)

    def disarm(self, site: str) -> None:
        with self._lock:
            self._sites.pop(site, None)
            self.armed = bool(self._sites)

    def reset(self) -> None:
        with self._lock:
            self._sites.clear()
            self._kind_warned.clear()
            self.armed = False

    # -- introspection (the chaos suite's assertions) -------------------------
    def get(self, site: str) -> Optional[Failpoint]:
        return self._sites.get(site)

    def hits(self, site: str) -> int:
        fp = self._sites.get(site)
        return fp.hits if fp is not None else 0

    def fires(self, site: str) -> int:
        fp = self._sites.get(site)
        return fp.fires if fp is not None else 0

    # -- site evaluation ------------------------------------------------------
    def eval(self, site: str) -> None:
        """Evaluate a control-flow site: sleep or raise per the armed
        action; no-op when the site is unarmed."""
        if not self.armed:
            return
        fp = self._sites.get(site)
        if fp is None:
            return
        if fp.action == "corrupt":
            self._warn_kind(site, "a control-flow site cannot apply 'corrupt'")
            return
        if not fp._should_fire():
            return
        self._record(fp)
        if fp.action == "latency":
            time.sleep(float(fp.arg or 0.01))
            return
        if fp.action == "stall":
            # sliced sleep: an async-raised OperatorCrashed (watchdog
            # escalation) lands at a bytecode boundary, so the wedge must
            # surface one every ~10 ms instead of parking in one sleep
            deadline = time.monotonic() + float(fp.arg or 60.0)
            while time.monotonic() < deadline:
                time.sleep(0.01)
            return
        if fp.action == "crash":
            raise OperatorCrashed(f"failpoint {site} crashed the operator")
        raise _exception_class(fp.arg)(f"failpoint {site} injected {fp.action}")

    def corrupt(self, site: str, data: bytes) -> bytes:
        """Evaluate a byte-stream site: flip one deterministic byte past
        the 4-byte length prefix (so the receiver's JSON/CRC integrity
        checks are what detects it, exactly as real bit-rot would land)."""
        if not self.armed:
            return data
        fp = self._sites.get(site)
        if fp is None or len(data) <= 4:
            return data
        if fp.action != "corrupt":
            self._warn_kind(site, f"a byte-stream site cannot apply {fp.action!r}")
            return data
        if not fp._should_fire():
            return data
        self._record(fp)
        pos = 4 + fp._corrupt_pos(len(data) - 4)
        mutated = bytearray(data)
        mutated[pos] ^= 0xFF
        return bytes(mutated)

    def _warn_kind(self, site: str, why: str) -> None:
        """A drill armed with the wrong action KIND for a site would
        otherwise never fire and never count -- exactly the silent no-op
        the arm_from_env docstring warns against. Warn loudly, once."""
        with self._lock:
            if site in self._kind_warned:
                return
            self._kind_warned.add(site)
        from karpenter_tpu_torch.logging import get_logger

        get_logger("failpoints").warning(
            "failpoint action kind mismatches its site; it will NEVER fire",
            site=site, reason=why,
        )

    @staticmethod
    def _record(fp: Failpoint) -> None:
        from karpenter_tpu_torch import metrics

        metrics.FAILPOINT_FIRES.inc(site=fp.site, action=fp.action)


# process-global registry; $KARPENTER_TPU_FAILPOINTS arms at import, the
# same env contract as the JAX package's
FAILPOINTS = FailpointRegistry()
FAILPOINTS.arm_from_env()


def eval(site: str) -> None:  # noqa: A001 - the site-evaluation verb
    if FAILPOINTS.armed:
        FAILPOINTS.eval(site)


def live(site: str) -> Optional[Failpoint]:
    """The Failpoint at `site` if it is armed and can still fire, else
    None -- the gate for hot paths that pay a standing toll (e.g. the
    framing layer's joining copy) only while a drill could actually
    land, and stop paying the moment it is spent."""
    if not FAILPOINTS.armed:
        return None
    fp = FAILPOINTS.get(site)
    return None if fp is None or fp.exhausted else fp


def corrupt(site: str, data: bytes) -> bytes:
    if FAILPOINTS.armed:
        return FAILPOINTS.corrupt(site, data)
    return data
