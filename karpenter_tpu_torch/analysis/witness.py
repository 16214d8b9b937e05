"""Runtime lock-order witness: the dynamic half of the lock checker.

Copy of karpenter_tpu/analysis/witness.py over the port: it wraps locks
allocated by frames under karpenter_tpu_torch/, counts into the port's
registry under the JAX family's name, and lives beside the JAX package's
witness in one process (the port's tests import both packages):

- its real locks are the interpreter's own factories
  (``_thread.allocate_lock``, ``_thread.RLock``), never whatever
  ``threading.Lock`` is when this module is imported -- which may be the
  other package's witness factory;
- ``install()`` chains: an allocation this witness does not own goes to
  the factory it replaced (the other witness's, or the interpreter's);
- its factory's frames carry threading.py's file name, so any witness
  walking the stack for the allocating frame skips them as it skips
  threading.py's own (Condition's RLock); it skips the other witness's
  factory frames (any ``analysis/witness.py``) alike;
- so either install order leaves each witness wrapping exactly its own
  package's locks, and neither report holds the other's sites.

The static pass (checkers/locks.py) certifies the ACQUISITION-SITE graph
cycle-free, but it resolves callees conservatively -- callbacks, injected
functions, and cross-thread handoffs contribute edges it cannot see. This
module is the runtime complement: a debug wrapper around
``threading.Lock``/``threading.RLock`` that records the actual
acquisition order per thread and reports an INVERSION the moment two
sites are ever taken in both orders -- the Python race detector for
interleavings the chaos schedules cannot force. A deadlock needs both
orders to run CONCURRENTLY; the witness needs them to run at all, in any
test, ever. That is why the port's threaded tests run under it
(analysis/pytest_plugin.py installs it session-wide and asserts a
zero-inversion session) and why chip_smoke.py's phase `witness` runs the
tick, the warm-up ladder beside live ticks, the sidecar and a drill on
the card under it.

Mechanics:

- ``install()`` monkeypatches the ``threading.Lock``/``RLock`` factories.
  Only locks allocated FROM PACKAGE CODE are wrapped (the creating frame
  must live under karpenter_tpu_torch/); stdlib, torch, the JAX package's
  and test-harness locks pass through untouched. Locks are identified by allocation site
  (file:line), merging per-instance locks of one class attribute into
  one node -- the same over-approximation the static graph uses, so the
  two passes speak the same language.
- Each BLOCKING acquire while other witnessed locks are held notes the
  edge (held-site -> acquired-site) with the stack that first observed
  it, then checks the reverse edge: present means two code paths order
  these sites both ways -- an inversion, recorded (and raised under
  ``strict``). Try-acquires (``blocking=False`` or a timeout) are the
  sanctioned out-of-order pattern and contribute no edges.
- A blocking re-acquire of a non-reentrant ``Lock`` already held by the
  calling thread is a CERTAIN self-deadlock: the witness always raises
  ``LockOrderInversion`` instead of letting the suite hang.

Every inversion occurrence increments
``karpenter_lockwitness_inversions_total``; ``report()`` renders the
deduplicated pairs with both stacks for the session-end assert.
"""
from __future__ import annotations

import _thread
import os
import sys
import threading
import traceback
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from karpenter_tpu_torch.analysis.base import PACKAGE_ROOT, REPO_ROOT

_INVERSIONS = None


def _inversions_metric():
    """The witness's one metric family, created lazily: importing this
    module must NOT import karpenter_tpu_torch.metrics -- the plugin
    imports the witness BEFORE install() patches the lock factories, and
    an eager metrics import would allocate the Registry and per-metric
    locks unwitnessed (exactly the scrape-vs-observe seam the witness
    exists to watch). The JAX family's name, in the port's registry."""
    global _INVERSIONS
    if _INVERSIONS is None:
        from karpenter_tpu_torch import metrics

        _INVERSIONS = metrics.REGISTRY.counter(
            "karpenter_lockwitness_inversions_total",
            "Lock-order inversions observed by the runtime witness (two lock "
            "allocation sites acquired in both orders; a potential deadlock "
            "the static lock-graph pass could not prove absent). Asserted "
            "zero by tier-1 and the chaos soaks.",
        )
    return _INVERSIONS


_register_metrics = _inversions_metric

# inversions seen before the family existed: registering it from inside an
# acquire could take the registry's own (witnessed) lock while this thread
# holds it -- the family is created, and these counted, outside lock paths
_pending = [0]


def _count_inversion() -> None:
    if _INVERSIONS is None:
        _pending[0] += 1
        return
    busy = getattr(_tls, "busy", False)
    _tls.busy = True        # the counter's own lock adds no edge
    try:
        _INVERSIONS.inc()
    finally:
        _tls.busy = busy


def _flush_pending() -> None:
    n, _pending[0] = _pending[0], 0
    if n:
        _inversions_metric().inc(n)

# when metrics is already loaded its locks predate any install() anyway,
# so registering eagerly costs no witness coverage
if "karpenter_tpu_torch.metrics" in sys.modules:
    _inversions_metric()

# the interpreter's own factories (threading.Lock IS _thread.allocate_lock,
# threading.RLock returns a _thread.RLock)
_REAL_LOCK = _thread.allocate_lock
_REAL_RLOCK = _thread.RLock
_PKG_PREFIX = str(PACKAGE_ROOT) + "/"
# the analysis package is tooling: its bookkeeping locks are not the port's
_TOOLING_PREFIX = str(PACKAGE_ROOT / "analysis") + "/"
_SKIP_FILES = (__file__, threading.__file__)
# another package's lock witness chained over or under this one
_FOREIGN_WITNESS_SUFFIX = os.sep + os.path.join("analysis", "witness.py")


class LockOrderInversion(RuntimeError):
    """Raised in strict mode (and always for a certain self-deadlock)."""


@dataclass(frozen=True)
class Inversion:
    first: str        # site acquired first on THIS thread (still held)
    second: str       # site being acquired now
    stack: str        # where the inverted acquire happened
    prior_stack: str  # where the reverse edge was first observed

    def render(self) -> str:
        return (
            f"lock-order inversion: {self.second} acquired while holding "
            f"{self.first}, but the opposite order was observed earlier\n"
            f"--- this acquire ({self.first} -> {self.second}):\n{self.stack}"
            f"--- first observation of {self.second} -> {self.first}:\n"
            f"{self.prior_stack}"
        )


@dataclass
class _State:
    # bookkeeping guarded by a REAL (unwitnessed) lock; edges/inversions
    # are tiny (site pairs, not acquisitions). Any: the factory is the
    # interpreter's own, opaque to the checker
    guard: Any = field(default_factory=_REAL_LOCK)
    edges: Dict[Tuple[str, str], str] = field(default_factory=dict)  # -> first stack
    inversions: List[Inversion] = field(default_factory=list)
    seen_pairs: set = field(default_factory=set)
    strict: bool = False
    installed: bool = False
    wrapped: int = 0
    # the factories install() replaced, called for every allocation this
    # witness does not own
    replaced: Any = None
    sites: Dict[str, str] = field(default_factory=dict)    # site -> kind


_state = _State()
_tls = threading.local()


def _held() -> list:
    held = getattr(_tls, "held", None)
    if held is None:
        held = _tls.held = []
    return held


def _caller_site() -> Optional[str]:
    """Allocation site of the frame that called the lock factory:
    repo-relative file:line, or None when the caller is not package code."""
    f = sys._getframe(2)
    while f is not None:
        fn = f.f_code.co_filename
        if fn not in _SKIP_FILES and not fn.endswith(_FOREIGN_WITNESS_SUFFIX):
            if fn.startswith(_PKG_PREFIX) and not fn.startswith(_TOOLING_PREFIX):
                rel = fn[len(str(REPO_ROOT)) + 1:]
                return f"{rel}:{f.f_lineno}"
            return None
        f = f.f_back
    return None


def _stack() -> str:
    return "".join(traceback.format_stack(limit=14)[:-3])


class _WitnessLock:
    """Wraps one real Lock/RLock; quacks like it (including for
    threading.Condition, whose RLock fast-path methods reach the real
    lock through ``__getattr__``)."""

    def __init__(self, real, site: str, kind: str):
        self._real = real
        self.site = site
        self.kind = kind  # "Lock" | "RLock"

    # -- the instrumented surface --------------------------------------------
    def acquire(self, blocking: bool = True, timeout: float = -1):
        held = _held()
        reentrant = any(h is self for h in held)
        if blocking and timeout == -1:
            if reentrant and self.kind == "Lock":
                # a non-reentrant lock re-acquired by its own holder can
                # only deadlock: report instead of hanging the suite
                inv = Inversion(self.site, self.site, _stack(),
                                "(same thread still holds this lock)")
                with _state.guard:
                    _state.inversions.append(inv)
                _count_inversion()
                raise LockOrderInversion(inv.render())
            if held and not reentrant:
                # nothing held -> no edge possible -> no bookkeeping (the
                # overwhelmingly common case stays one real acquire)
                self._note(held)
        ok = self._real.acquire(blocking, timeout) if timeout != -1 \
            else self._real.acquire(blocking)
        if ok:
            held.append(self)
        return ok

    def release(self):
        held = _held()
        for i in range(len(held) - 1, -1, -1):
            if held[i] is self:
                del held[i]
                break
        self._real.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def locked(self):
        return self._real.locked()

    def __getattr__(self, name):
        return getattr(self._real, name)

    def __repr__(self):
        return f"<WitnessLock {self.kind} {self.site} of {self._real!r}>"

    # -- edge bookkeeping -----------------------------------------------------
    def _note(self, held: list) -> None:
        if getattr(_tls, "busy", False):
            return
        _tls.busy = True
        try:
            hits: List[Inversion] = []
            with _state.guard:
                for h in held:
                    if h.site == self.site:
                        continue  # sibling instances of one attr: unordered
                    edge = (h.site, self.site)
                    if edge not in _state.edges:
                        _state.edges[edge] = _stack()
                    rev = (self.site, h.site)
                    prior = _state.edges.get(rev)
                    if prior is not None:
                        inv = Inversion(h.site, self.site, _stack(), prior)
                        pair = tuple(sorted((h.site, self.site)))
                        if pair not in _state.seen_pairs:
                            _state.seen_pairs.add(pair)
                            _state.inversions.append(inv)
                        hits.append(inv)
            for inv in hits:
                _count_inversion()
            if hits and _state.strict:
                raise LockOrderInversion(hits[0].render())
        finally:
            _tls.busy = False


def _factory(kind: str, real_factory, chained):
    """The patched factory: a lock allocated by the port's code is a real
    lock wrapped; any other allocation is the replaced factory's."""
    def make(*args, **kwargs):
        site = _caller_site()
        if site is None or not _state.installed:
            return chained(*args, **kwargs)
        _state.wrapped += 1
        _state.sites.setdefault(site, kind)
        return _WitnessLock(real_factory(), site, kind)

    # frames of this factory read as threading.py's: a witness chained
    # over this one skips them as it skips Condition's, and finds the
    # allocating frame
    make.__code__ = make.__code__.replace(co_filename=threading.__file__)
    make.__name__ = kind
    make._port_lock_witness = True  # type: ignore[attr-defined]
    return make


def install(strict: bool = False) -> None:
    """Patch the threading lock factories, chaining over whatever they
    are now. Locks created BEFORE install stay unwitnessed (install early
    -- analysis/pytest_plugin.py does it before any karpenter_tpu_torch
    module import, so module-level locks are covered)."""
    _state.strict = strict
    if _state.installed:
        return
    _state.installed = True
    if _state.replaced is None:
        _state.replaced = (threading.Lock, threading.RLock)
        threading.Lock = _factory("Lock", _REAL_LOCK, _state.replaced[0])
        threading.RLock = _factory("RLock", _REAL_RLOCK, _state.replaced[1])


def uninstall() -> None:
    """Stop wrapping. The factories install() replaced come back when this
    witness's are still the installed ones; when another witness chained
    over it meanwhile, this one stays in the chain and passes every
    allocation through."""
    _state.installed = False
    if _state.replaced is not None and getattr(threading.Lock, "_port_lock_witness", False):
        threading.Lock, threading.RLock = _state.replaced
        _state.replaced = None


def reset() -> None:
    """Drop accumulated edges/inversions (a fresh witness epoch; the
    installed patch stays)."""
    with _state.guard:
        _state.edges.clear()
        _state.inversions.clear()
        _state.seen_pairs.clear()


def installed() -> bool:
    return _state.installed


def inversions() -> List[Inversion]:
    _flush_pending()
    with _state.guard:
        return list(_state.inversions)


def edge_count() -> int:
    with _state.guard:
        return len(_state.edges)


def wrapped_count() -> int:
    return _state.wrapped


def sites() -> Dict[str, str]:
    """Every allocation site wrapped so far -> "Lock" | "RLock"."""
    return dict(sorted(_state.sites.items()))


def report() -> str:
    invs = inversions()
    if not invs:
        return (f"lock witness: 0 inversions "
                f"({edge_count()} ordered edges over {wrapped_count()} "
                f"witnessed locks)")
    out = [f"lock witness: {len(invs)} inversion pair(s):"]
    out.extend(inv.render() for inv in invs)
    return "\n".join(out)
