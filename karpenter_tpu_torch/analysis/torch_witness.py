"""Runtime rebuild/re-capture and host-sync witness: the dynamic half of the torch discipline checker.

Counterpart of karpenter_tpu/analysis/jax_witness.py, with its surface
(``install``, ``hot()``, ``aot_phase()``, ``reset``, ``hot_violations``,
``stats``, ``report``, strict mode) over the port. The JAX witness has two
halves; each becomes its torch form:

- **Retraces become rebuilds and re-captures after warm-up.** The port
  compiles nothing per shape: its cold work is a kernel library built
  (nvcc) or loaded (ctypes) -- solver/kernels/build.py's ``build`` and
  ``_load_counted``, the rejected-library rebuild included -- and a CUDA
  graph captured by the warm-up ladder (solver/aot.py ``capture``). Both
  call into this module (``note_library``, ``note_capture``). Inside a
  ``hot()`` section -- after the caller declared warm-up complete -- a
  library build or load on any thread outside ``aot_phase()``, and a
  capture on any thread outside ``aot_phase()``, is a VIOLATION, recorded
  with its stack and counted into ``karpenter_jaxwitness_retraces_total``
  (the JAX family's name, in the port's registry). The ladder's own work
  runs inside ``aot_phase()`` beside live ticks by design and is booked
  apart (``aot_builds``, ``aot_captures``).
- **Host transfers are analysis/sync_witness.py.** ``hot()`` enters the
  sync witness's ``hot()`` too (torch's sync debug mode, the same
  ``SANCTIONED_FETCH`` manifest the static torchhost rules read), and
  ``aot_phase()`` IS the sync witness's: one thread-local marker for both
  halves. Every unsanctioned synchronizing site inside a hot section is a
  violation, counted into ``karpenter_jaxwitness_host_transfers_total``
  when the outermost section ends.

Importing this module imports nothing of torch (the lock witness must be
installed before the port's modules allocate their locks).
``KARPENTER_TPU_JAX_WITNESS`` controls it under the pytest plugin with
the JAX package's meanings: ``0`` off, ``1`` on, ``strict`` raises at the
offending build, load or capture (and at a hot section's end for syncs).
"""
from __future__ import annotations

import _thread
import sys
import threading
import traceback
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from karpenter_tpu_torch.analysis import sync_witness

_REBUILDS = None
_TRANSFERS = None


def _rebuilds_metric():
    """Lazy like the lock witness's: importing this module must not import
    karpenter_tpu_torch.metrics."""
    global _REBUILDS
    if _REBUILDS is None:
        from karpenter_tpu_torch import metrics

        _REBUILDS = metrics.REGISTRY.counter(
            "karpenter_jaxwitness_retraces_total",
            "Cold work inside a declared-warm hot section: a kernel library "
            "built or loaded, or a CUDA graph captured, outside the warm-up "
            "ladder's aot phase (the port's counterpart of a retrace). "
            "Asserted zero by the port's witnessed tests and chip_smoke.py.",
        )
    return _REBUILDS


def _transfers_metric():
    global _TRANSFERS
    if _TRANSFERS is None:
        from karpenter_tpu_torch import metrics

        _TRANSFERS = metrics.REGISTRY.counter(
            "karpenter_jaxwitness_host_transfers_total",
            "Synchronizing CUDA calls inside a hot section from OUTSIDE the "
            "sanctioned-fetch manifest (analysis/sync_witness.py), counted "
            "when the outermost section ends. Asserted zero by the port's "
            "witnessed tests and chip_smoke.py.",
        )
    return _TRANSFERS


def _register_metrics():
    _rebuilds_metric()
    _transfers_metric()


if "karpenter_tpu_torch.metrics" in sys.modules:
    _register_metrics()


class TorchWitnessViolation(RuntimeError):
    """Raised in strict mode at the offending build, load or capture."""


@dataclass(frozen=True)
class Rebuild:
    label: str        # hot-section label
    kind: str         # "build" | "load" | "capture"
    what: str         # library name or captured entry
    thread: str
    stack: str

    def render(self) -> str:
        return (f"{self.kind} of {self.what} inside hot section {self.label!r} "
                f"on thread {self.thread}, outside the warm-up ladder's aot "
                f"phase\n{self.stack}")


@dataclass(frozen=True)
class Transfer:
    site: str
    count: int

    def render(self) -> str:
        return (f"unsanctioned synchronizing call inside a hot section at "
                f"{self.site} ({self.count}x)")


@dataclass
class _State:
    guard: Any = field(default_factory=_thread.allocate_lock)   # a real lock, never witnessed
    installed: bool = False
    strict: bool = False
    hot_depth: int = 0
    hot_labels: List[str] = field(default_factory=list)
    rebuilds: List[Rebuild] = field(default_factory=list)
    builds_total: int = 0
    loads_total: int = 0
    captures_total: int = 0
    aot_builds: int = 0
    aot_captures: int = 0
    # the sync witness's unsanctioned total when the outermost hot section
    # began: its end counts the difference into the transfers family
    sync_base: int = 0


_state = _State()


def _in_aot() -> bool:
    return getattr(sync_witness._tls, "aot_depth", 0) > 0


def _stack() -> str:
    return "".join(traceback.format_stack(limit=12)[:-2])


def _note(kind: str, what: str) -> None:
    if not _state.installed:
        return
    hit: Optional[Rebuild] = None
    aot = _in_aot()
    with _state.guard:
        if kind == "capture":
            _state.captures_total += 1
            _state.aot_captures += aot
        else:
            if kind == "build":
                _state.builds_total += 1
            else:
                _state.loads_total += 1
            _state.aot_builds += aot
        if _state.hot_depth > 0 and not aot:
            hit = Rebuild(label=_state.hot_labels[-1] if _state.hot_labels else "?",
                          kind=kind, what=what, thread=threading.current_thread().name,
                          stack=_stack())
            _state.rebuilds.append(hit)
    if hit is not None:
        _rebuilds_metric().inc()
        if _state.strict:
            raise TorchWitnessViolation(hit.render())


def note_library(name: str, kind: str) -> None:
    """solver/kernels/build.py: library `name` was built ("build", nvcc) or
    loaded ("load", ctypes) on the calling thread."""
    _note(kind, name)


def note_capture(what: str) -> None:
    """solver/aot.py: a CUDA graph of `what` is about to be captured on the
    calling thread."""
    _note("capture", what)


def install(strict: bool = False) -> None:
    """Arm the witness (idempotent). The build and capture seams call in
    on their own, so nothing is patched: install needs no torch."""
    _state.strict = strict
    _state.installed = True


def uninstall() -> None:
    _state.installed = False


def installed() -> bool:
    return _state.installed


def _unsanctioned_total() -> int:
    return sum(sync_witness.stats()["unsanctioned"].values())


class _HotSection:
    def __init__(self, label: str):
        self.label = label

    def __enter__(self) -> "_HotSection":
        section = sync_witness.hot(self.label)
        section.__enter__()
        with _state.guard:
            _state.hot_depth += 1
            _state.hot_labels.append(self.label)
            outermost = _state.hot_depth == 1
        if outermost:
            _state.sync_base = _unsanctioned_total()
        self._sync = section
        return self

    def __exit__(self, *exc: Any) -> bool:
        with _state.guard:
            _state.hot_depth -= 1
            if _state.hot_labels:
                _state.hot_labels.pop()
            outermost = _state.hot_depth == 0
        new = 0
        if outermost:
            new = max(0, _unsanctioned_total() - _state.sync_base)
        self._sync.__exit__(*exc)
        if new:
            _transfers_metric().inc(new)
            if _state.strict and _state.installed and exc[0] is None:
                raise TorchWitnessViolation(
                    f"{new} unsanctioned synchronizing call(s) inside hot section "
                    f"{self.label!r}: {sync_witness.stats()['unsanctioned']}")
        return False


def hot(label: str = "hot") -> _HotSection:
    """Declare warm-up complete: until exit, ANY library build or load and
    any graph capture outside ``aot_phase()`` (process-wide -- a sidecar
    thread included), and every unsanctioned synchronizing call, is a
    recorded violation."""
    return _HotSection(label)


def aot_phase():
    """Mark the CALLING THREAD as the warm-up ladder's until exit: its
    builds, loads and captures are booked apart, its syncs as the sync
    witness's ``aot_exempt``. The same marker as sync_witness.aot_phase()."""
    return sync_witness.aot_phase()


def reset() -> None:
    """Drop accumulated events, this witness's and the sync witness's (a
    fresh epoch; the installed state stays)."""
    with _state.guard:
        _state.rebuilds.clear()
        _state.builds_total = _state.loads_total = _state.captures_total = 0
        _state.aot_builds = _state.aot_captures = 0
    sync_witness.reset()
    _state.sync_base = 0


def hot_rebuilds() -> List[Rebuild]:
    with _state.guard:
        return list(_state.rebuilds)


def hot_transfers() -> List[Transfer]:
    return [Transfer(site, n) for site, n in sync_witness.stats()["unsanctioned"].items()]


def hot_violations() -> List[Any]:
    return hot_rebuilds() + hot_transfers()


def stats() -> Dict[str, Any]:
    sync = sync_witness.stats()
    with _state.guard:
        return {
            "builds_total": _state.builds_total,
            "loads_total": _state.loads_total,
            "captures_total": _state.captures_total,
            "aot_builds": _state.aot_builds,
            "aot_captures": _state.aot_captures,
            "hot_rebuilds": len(_state.rebuilds),
            "hot_transfers": sum(sync["unsanctioned"].values()),
            "unsanctioned_sites": sync["unsanctioned"],
            "sanctioned_fetches": sync["sanctioned_fetches"],
            "aot_exempt_syncs": sync["aot_exempt"],
            "hot": _state.hot_depth,
        }


def report() -> str:
    st = stats()
    if not st["hot_rebuilds"] and not st["hot_transfers"]:
        return (f"torch witness: 0 hot-section rebuilds or captures, 0 unsanctioned "
                f"hot syncs ({st['builds_total']} builds, {st['loads_total']} loads, "
                f"{st['captures_total']} captures, {st['aot_captures']} on the ladder; "
                f"{st['sanctioned_fetches']} sanctioned fetches)")
    out = [f"torch witness: {st['hot_rebuilds']} rebuild(s)/capture(s), "
           f"{st['hot_transfers']} unsanctioned sync(s) in hot sections:"]
    out.extend(r.render() for r in hot_rebuilds())
    out.extend(t.render() for t in hot_transfers())
    return "\n".join(out)
