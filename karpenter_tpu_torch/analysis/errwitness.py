"""Runtime exception-escape witness: the dynamic half of the errflow checker.

Copy of karpenter_tpu/analysis/errwitness.py over the port: it taps the
port's four ladder base classes, judges swallows at handler sites under
karpenter_tpu_torch/ only, and shares the manifests of the port's
checkers/errflow.py. Beside the JAX package's witness in one process each
stays with its own package's frames; both arm ``sys.settrace`` on demand,
and a thread another tracer already traces (the other witness included)
keeps that tracer -- this witness stays dark there rather than fight.

The static pass (checkers/errflow.py) proves the RESOLVABLE call graph's
ladder contract -- but callbacks, injected functions, and duck-typed
receivers hide handler sites it cannot see, and a broad handler that is
lint-sanctioned because it logs can still be the wrong place for a
ladder-class exception to die. This module is the runtime complement: a
``sys.settrace``-based witness that watches every exception of a LADDER
class (``OperatorCrashed``, ``ShmError``, ``StaleSeqnumError``,
``CloudError`` -- matched by name anywhere in the MRO, so subclasses
count) propagate through package frames, and records the handler site
whenever one is SWALLOWED: caught in a package function that then
resumed normal execution, and garbage-collected without ever being
re-raised, converted (``raise X from e`` / implicit context), or handed
to a waiter. Every swallow counts into
``karpenter_errflow_swallowed_total{site}``; the session-end gate in
analysis/pytest_plugin.py asserts that no UNSANCTIONED site swallowed one
(sanctioned = the LADDER_SEAMS functions plus the
SANCTIONED_CRASH_SWALLOWS / SANCTIONED_ESCAPE_SITES manifests, shared
verbatim with the static checker).

Mechanics (CPython 3.10 trace semantics, pinned by tests):

- ``install()`` TAPS the four ladder base classes' ``__init__``; no
  tracing runs until one is constructed (construction immediately
  precedes raising). The tap arms ``sys.settrace`` on the constructing
  thread and back-fills ``f_trace`` onto the live repo frames; the
  thread disarms itself after a short fuse of call events with nothing
  in flight -- the witness's standing cost is ZERO, and each ladder
  exception pays a sub-millisecond tracing window. While armed, the
  local handler is returned only for frames under the repo (package +
  tests; the analysis package itself is skipped), and
  ``frame.f_trace_lines = False`` keeps it down to
  ``exception``/``return`` events.
- An ``exception`` event for a ladder-class instance opens (or re-binds)
  a RECORD keyed by the exception's identity: state ``propagating`` in
  that frame. A later event for the SAME frame decides its fate:
  a ``return`` whose line equals the exception line, lands on a
  ``raise`` statement, or inside a ``finally`` block is an UNWIND (the
  record keeps propagating -- the caller's events or GC resolve it);
  any other same-frame activity (a different line's return, a nested
  call, another exception) means the frame CAUGHT it -- state ``held``
  at that (file, function) site.
- A ``held`` record is not yet a swallow: a later ``raise`` of the same
  instance (an exception event anywhere, any thread -- the batcher's
  future fan-out re-raises in the waiter) or of an exception carrying
  it in its ``__cause__``/``__context__`` chain resolves it ESCAPED.
  Garbage collection is the verdict: a weakref callback on the instance
  turns a still-held record into a SWALLOW at its site, and drops a
  still-propagating one (it left traced code -- a test caught it).
  Records held by TEST frames resolve silently: pytest.raises is not a
  package swallow.
- ``finally``-block returns are invisible to this witness (the static
  ``errflow/return-in-finally`` rule owns that spelling), and Python
  scalar C-level handling is out of reach -- same division of labor as
  the torch witness vs the torchhost rules.

Controls mirror the lock witness: installed session-wide by
analysis/pytest_plugin.py, ``KARPENTER_TPU_ERRFLOW_WITNESS=0`` disables,
``=strict`` raises ``EscapeWitnessViolation`` from ``flush()`` (never
from inside a trace callback, where CPython would silently disarm
tracing and land the violation in an unrelated frame).
chip_smoke.py's phase `witness` keeps it on through a failpoint drill --
an armed drill is exactly when a wrong handler meets a ladder exception.
"""
from __future__ import annotations

import _thread
import ast
import sys
import threading
import weakref
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Set, Tuple

from karpenter_tpu_torch.analysis.base import PACKAGE_ROOT, REPO_ROOT

_PKG_PREFIX = str(PACKAGE_ROOT) + "/"
_REPO_PREFIX = str(REPO_ROOT) + "/"
_SKIP_PREFIX = str(PACKAGE_ROOT / "analysis") + "/"

# class names that make an exception LADDER-CLASS when any of them
# appears in the MRO (subclasses count; ConnectionError/OSError stay
# out -- generic transport errors are the static checker's domain, the
# witness watches the TYPED rungs and the crash)
LADDER_NAMES = frozenset({
    "OperatorCrashed", "ShmError", "StaleSeqnumError", "CloudError",
})

_SWALLOWED = None


def _swallowed_metric():
    """Lazy like the lock witness's: importing this module must not
    import karpenter_tpu_torch.metrics (the plugin imports witnesses
    before install(), and an eager metrics import would allocate the
    Registry locks unwitnessed). The JAX family's name, in the port's
    registry."""
    global _SWALLOWED
    if _SWALLOWED is None:
        from karpenter_tpu_torch import metrics

        _SWALLOWED = metrics.REGISTRY.counter(
            "karpenter_errflow_swallowed_total",
            "Ladder-class exceptions (OperatorCrashed/ShmError/"
            "StaleSeqnumError/CloudError subclasses) observed by the "
            "runtime escape witness being swallowed, by handler site "
            "(file:function). The session-end gate asserts no "
            "UNSANCTIONED site swallowed one during tier-1 or the "
            "chaos/overload soaks.",
            labels=("site",),
        )
    return _SWALLOWED


_register_metrics = _swallowed_metric

if "karpenter_tpu_torch.metrics" in sys.modules:
    _swallowed_metric()


class EscapeWitnessViolation(RuntimeError):
    """Raised in strict mode at the GC point of an unsanctioned swallow."""


@dataclass
class Swallow:
    site: str        # "rel/path.py:function"
    exc_type: str
    message: str
    raised_line: int  # line in the handler's frame where the exc surfaced
    sanctioned: bool

    def render(self) -> str:
        tag = "sanctioned" if self.sanctioned else "UNSANCTIONED"
        return (f"[{tag}] {self.site} swallowed {self.exc_type} "
                f"(surfaced at line {self.raised_line}): {self.message}")


@dataclass
class _Record:
    exc_id: int
    exc_type: str
    message: str
    state: str                    # "propagating" | "held"
    frame_id: Optional[int]       # binding frame while it is alive
    file: str = ""
    func: str = ""
    exc_line: int = 0             # f_lineno of the last exception event
    ref: Any = None               # weakref to the exception


@dataclass
class _State:
    guard: Any = field(default_factory=_thread.allocate_lock)   # a real lock, never witnessed
    records: Dict[int, _Record] = field(default_factory=dict)
    swallows: List[Swallow] = field(default_factory=list)
    strict: bool = False
    installed: bool = False
    # ladder classes whose __init__ carries the arming tap -> original
    patched: Dict[type, Any] = field(default_factory=dict)
    # per-file (raise-statement lines, finally-block lines) for the
    # unwind-vs-handled judgment
    lines_cache: Dict[str, Tuple[Set[int], Set[int]]] = field(default_factory=dict)
    ladder_memo: Dict[type, bool] = field(default_factory=dict)
    sanctioned: Optional[Set[Tuple[str, str]]] = None


_state = _State()
_gc_queue: "deque[int]" = deque()
# frame id -> record, for PROPAGATING records only: the per-call and
# per-return fast paths key off this tiny transient index (reads are
# lock-free under the GIL; an exception is in flight for microseconds,
# while HELD records -- which can live as long as the object they were
# recorded on -- never burden the hot path)
_by_frame: Dict[int, "_Record"] = {}


def _is_ladder(tp: type) -> bool:
    hit = _state.ladder_memo.get(tp)
    if hit is None:
        try:
            hit = any(c.__name__ in LADDER_NAMES for c in tp.__mro__)
        except Exception:  # noqa: BLE001 -- exotic metaclasses stay out
            hit = False
        _state.ladder_memo[tp] = hit
    return hit


def _file_lines(filename: str) -> Tuple[Set[int], Set[int]]:
    hit = _state.lines_cache.get(filename)
    if hit is not None:
        return hit
    raise_lines: Set[int] = set()
    finally_lines: Set[int] = set()
    try:
        with open(filename) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Raise):
                raise_lines.add(node.lineno)
            elif isinstance(node, ast.Try) and node.finalbody:
                lo = node.finalbody[0].lineno
                hi = max((getattr(n, "end_lineno", lo) or lo)
                         for n in node.finalbody)
                finally_lines.update(range(lo, hi + 1))
    except (OSError, SyntaxError, ValueError):
        pass
    _state.lines_cache[filename] = (raise_lines, finally_lines)
    return raise_lines, finally_lines


def _sanctioned_sites() -> Set[Tuple[str, str]]:
    """(rel, function) sites allowed to absorb a ladder-class exception:
    the LADDER_SEAMS functions themselves plus the two sanctioned-swallow
    manifests -- imported lazily so module import stays feather-light."""
    if _state.sanctioned is None:
        from karpenter_tpu_torch.analysis.checkers import errflow

        sites: Set[Tuple[str, str]] = set()
        for seam in errflow.LADDER_SEAMS:
            sites.add((seam.rel, seam.func))
        sites.update(errflow.SANCTIONED_CRASH_SWALLOWS)
        sites.update(errflow.SANCTIONED_ESCAPE_SITES)
        _state.sanctioned = sites
    return _state.sanctioned


def _rel(filename: str) -> str:
    if filename.startswith(_REPO_PREFIX):
        return filename[len(_REPO_PREFIX):]
    return filename


# -- record resolution --------------------------------------------------------


def _resolve_held(rec: _Record, *, swallowed: bool) -> Optional[Swallow]:
    """Caller holds the guard. Returns the Swallow to report (metric is
    incremented OUTSIDE the guard by the caller), or None."""
    _state.records.pop(rec.exc_id, None)
    if rec.frame_id is not None:
        _by_frame.pop(rec.frame_id, None)
        rec.frame_id = None
    if not swallowed:
        return None
    rel = _rel(rec.file)
    if not rel.startswith("karpenter_tpu_torch/"):
        return None  # a test (or harness) absorbed it: not a package swallow
    site_key = (rel, rec.func)
    sw = Swallow(
        site=f"{rel}:{rec.func}",
        exc_type=rec.exc_type,
        message=rec.message,
        raised_line=rec.exc_line,
        sanctioned=site_key in _sanctioned_sites(),
    )
    _state.swallows.append(sw)
    return sw


def _on_gc(exc_id: int) -> None:
    """Weakref callback: the exception was garbage-collected. GC can run
    at ANY allocation -- including while this thread holds the guard --
    so the callback only enqueues (deque.append is atomic, lock-free);
    the verdict happens in _drain_gc at the next trace event."""
    _gc_queue.append(exc_id)


def _drain_gc(strict_ok: bool = False) -> None:
    """Judge queued GC verdicts: a still-held record is a swallow, a
    still-propagating one left traced code (escaped). Runs on a real
    thread at trace events (strict_ok=False: raising from a trace
    callback would make CPython silently disarm tracing and land the
    violation in whatever unrelated frame is executing) and from
    flush()/swallows() (strict_ok=True: the strict raise happens here,
    AFTER every hit's metric increment, so the counter never diverges
    from the report)."""
    hits: List[Swallow] = []
    while _gc_queue:
        try:
            exc_id = _gc_queue.popleft()
        except IndexError:
            break
        with _state.guard:
            rec = _state.records.get(exc_id)
            if rec is None:
                continue
            sw = _resolve_held(rec, swallowed=(rec.state == "held"))
        if sw is not None:
            hits.append(sw)
    for sw in hits:
        _swallowed_metric().inc(site=sw.site)
    if strict_ok and _state.strict:
        bad = [sw for sw in hits if not sw.sanctioned]
        if bad:
            raise EscapeWitnessViolation(
                "\n".join(sw.render() for sw in bad))


def _mark_held(rec: _Record) -> None:
    """Caller holds the guard: the binding frame resumed execution, so
    it caught the exception. Held records leave the per-frame fast-path
    index -- only GC, a re-raise, or a conversion resolves them now."""
    rec.state = "held"
    if rec.frame_id is not None:
        _by_frame.pop(rec.frame_id, None)


def _chain_ids(exc: BaseException) -> Set[int]:
    out: Set[int] = set()
    seen = 0
    while exc is not None and seen < 8:
        out.add(id(exc))
        exc = exc.__cause__ if exc.__cause__ is not None else exc.__context__
        seen += 1
    return out


# -- trace callbacks ----------------------------------------------------------


def _on_exception(frame, exc: BaseException) -> None:
    exc_id = id(exc)
    fid = id(frame)
    with _state.guard:
        # a new exception in a frame where a DIFFERENT record was
        # propagating means that frame caught the old one first
        prior = _by_frame.get(fid)
        if prior is not None and prior.exc_id != exc_id:
            _mark_held(prior)
        # conversion / re-raise resolution through the cause chain
        chain = _chain_ids(exc)
        chain.discard(exc_id)
        for cid in chain:
            crec = _state.records.get(cid)
            if crec is not None:
                _resolve_held(crec, swallowed=False)  # escaped as a cause
        rec = _state.records.get(exc_id)
        if rec is not None:
            # the SAME exception surfacing again: re-raised or still
            # unwinding -- either way it is propagating in THIS frame now
            if rec.frame_id is not None:
                _by_frame.pop(rec.frame_id, None)
            rec.state = "propagating"
            rec.frame_id = fid
            rec.file = frame.f_code.co_filename
            rec.func = frame.f_code.co_name
            rec.exc_line = frame.f_lineno
            _by_frame[fid] = rec
            return
        rec = _Record(
            exc_id=exc_id, exc_type=type(exc).__name__,
            message=str(exc)[:200], state="propagating",
            frame_id=fid, file=frame.f_code.co_filename,
            func=frame.f_code.co_name, exc_line=frame.f_lineno,
        )
        try:
            rec.ref = weakref.ref(exc, lambda _r, i=exc_id: _on_gc(i))
        except TypeError:
            return  # not weakref-able: cannot judge its lifetime
        _state.records[exc_id] = rec
        _by_frame[fid] = rec


def _on_return(frame) -> None:
    fid = id(frame)
    with _state.guard:
        rec = _by_frame.get(fid)
        if rec is None:
            return
        _by_frame.pop(fid, None)
        rec.frame_id = None
        raise_lines, finally_lines = _file_lines(frame.f_code.co_filename)
        line = frame.f_lineno
        if line == rec.exc_line or line in raise_lines \
                or line in finally_lines:
            # unwinding through this frame: the caller's events (or GC)
            # decide; the frame binding dies with it
            return
        # the frame caught it and completed normally
        rec.state = "held"


def _on_call(frame) -> None:
    """A nested call while a record is propagating in the CALLER frame
    means the caller's handler is running: the exception was caught.
    EXCEPT when the caller is unwinding: a ``finally`` block's cleanup
    calls, a ``raise``-statement's constructor, and a ``with`` block's
    Python ``__exit__`` all run mid-unwind -- judged by the caller's
    current line (finally span / raise line / still on the exception
    line), the same tables _on_return uses."""
    caller = frame.f_back
    if caller is None:
        return
    rec = _by_frame.get(id(caller))
    if rec is None:
        return
    with _state.guard:
        rec = _by_frame.get(id(caller))
        if rec is None or rec.state != "propagating":
            return
        line = caller.f_lineno
        if line == rec.exc_line:
            return  # still on the raising line: a with-exit, not a handler
        raise_lines, finally_lines = _file_lines(caller.f_code.co_filename)
        if line in raise_lines or line in finally_lines:
            return  # unwind-path cleanup, not handler code
        _mark_held(rec)


# -- the arming tap -----------------------------------------------------------
#
# Tracing a 5-minute suite wholesale costs ~2.4x wall clock (a Python
# callback per interpreter-level call). The witness instead ARMS
# per-thread tracing only while a ladder-class exception is plausibly in
# flight: the four ladder base classes' __init__ is tapped, and
# constructing one (which immediately precedes raising one) enables
# sys.settrace on the constructing thread AND back-fills f_trace onto
# the live repo frames (frames predating settrace get no call event).
# Tracing disarms itself after _FUSE call events with no record in
# flight -- the witness's standing cost is zero, and each ladder
# exception pays a sub-millisecond tracing window. The known blind spot:
# a HELD instance re-raised on another thread long after the fuse burned
# (the batcher future fan-out) resolves at GC as a swallow -- those
# designed hand-off sites are exactly what SANCTIONED_ESCAPE_SITES
# carries.

_FUSE = 512
_tls = threading.local()


def _local_trace(frame, event, arg):
    if event == "exception":
        if isinstance(arg[1], BaseException) and _is_ladder(type(arg[1])):
            _tls.fuse = _FUSE
            _on_exception(frame, arg[1])
    elif event == "return" and _by_frame:
        _on_return(frame)
    if _gc_queue:
        _drain_gc()
    return _local_trace


def _global_trace(frame, event, arg):
    if event != "call":
        return None
    if _by_frame:
        _on_call(frame)
        _tls.fuse = _FUSE
    else:
        fuse = getattr(_tls, "fuse", 0) - 1
        _tls.fuse = fuse
        if fuse <= 0:
            sys.settrace(None)  # this thread disarms itself
            return None
    if _gc_queue:
        _drain_gc()
    fn = frame.f_code.co_filename
    if fn.startswith(_SKIP_PREFIX) or not fn.startswith(_REPO_PREFIX):
        return None
    frame.f_trace_lines = False
    return _local_trace


def _arm_thread() -> None:
    """Enable tracing on the CURRENT thread and back-fill f_trace onto
    the live repo frames (they predate settrace, so call events alone
    would never reach them). A foreign tracer (debugger, coverage) wins:
    the witness stays dark rather than fighting over sys.settrace."""
    _tls.fuse = _FUSE
    cur = sys.gettrace()
    if cur is not None and cur is not _global_trace:
        return
    if cur is None:
        sys.settrace(_global_trace)
    f = sys._getframe(2)
    depth = 0
    while f is not None and depth < 48:
        fn = f.f_code.co_filename
        if fn.startswith(_REPO_PREFIX) and not fn.startswith(_SKIP_PREFIX):
            if f.f_trace is None:
                f.f_trace = _local_trace
                f.f_trace_lines = False
        f = f.f_back
        depth += 1


def _on_construct(exc: BaseException) -> None:
    if _state.installed:
        _arm_thread()


def _make_tap(cls: type):
    orig = cls.__init__

    def __init__(self, *args, **kwargs):  # noqa: A002
        orig(self, *args, **kwargs)
        _on_construct(self)

    __init__._errwitness_tap = True  # type: ignore[attr-defined]
    __init__.__wrapped__ = orig      # type: ignore[attr-defined]
    return __init__, orig


# (module path, class name) of the ladder BASE classes; subclasses
# inherit the tapped __init__ unless they override without super() --
# the CloudError taxonomy and the Shm/Stale families all chain up
_TAP_CLASSES = (
    ("karpenter_tpu_torch.failpoints", "OperatorCrashed"),
    ("karpenter_tpu_torch.solver.shm", "ShmError"),
    ("karpenter_tpu_torch.solver.rpc", "StaleSeqnumError"),
    ("karpenter_tpu_torch.errors.errors", "CloudError"),
)


# -- public api ---------------------------------------------------------------


def install(strict: bool = False) -> None:
    """Tap the ladder exception classes (importing their modules -- call
    AFTER the lock witness is installed so their module-level locks stay
    witnessed). No tracing is active until a ladder-class exception is
    constructed; threads disarm themselves when the flight ends."""
    import importlib

    _state.strict = strict
    if _state.installed:
        return
    for modpath, clsname in _TAP_CLASSES:
        mod = importlib.import_module(modpath)
        cls = getattr(mod, clsname)
        if cls in _state.patched:
            continue
        tapped, orig = _make_tap(cls)
        cls.__init__ = tapped
        _state.patched[cls] = orig
    _state.installed = True


def uninstall() -> None:
    if not _state.installed:
        return
    _state.installed = False
    for cls, orig in _state.patched.items():
        cls.__init__ = orig
    _state.patched.clear()
    if sys.gettrace() is _global_trace:
        sys.settrace(None)


def installed() -> bool:
    return _state.installed


def reset() -> None:
    """Drop accumulated records/swallows (a fresh witness epoch; the
    installed trace stays)."""
    _gc_queue.clear()
    with _state.guard:
        _by_frame.clear()
        _state.records.clear()
        _state.swallows.clear()


def flush() -> None:
    """Force pending verdicts: collect garbage so dropped exceptions
    reach their weakref callbacks, then drain the verdict queue -- the
    session gate calls this before judging. In strict mode, this is
    where an unsanctioned swallow raises EscapeWitnessViolation."""
    import gc

    gc.collect()
    _drain_gc(strict_ok=True)


def swallows(unsanctioned_only: bool = False) -> List[Swallow]:
    _drain_gc(strict_ok=False)
    with _state.guard:
        out = list(_state.swallows)
    if unsanctioned_only:
        out = [s for s in out if not s.sanctioned]
    return out


def pending_count() -> int:
    with _state.guard:
        return len(_state.records)


def report() -> str:
    sws = swallows()
    bad = [s for s in sws if not s.sanctioned]
    head = (f"escape witness: {len(sws)} ladder-class swallow(s), "
            f"{len(bad)} unsanctioned, {pending_count()} pending record(s)")
    if not sws:
        return head
    return "\n".join([head] + [s.render() for s in sws])
