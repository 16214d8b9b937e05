"""Runtime host-sync witness: every synchronizing CUDA call inside a hot section, by site.

Counterpart of the host-transfer half of karpenter_tpu/analysis/
jax_witness.py (``_note_transfer``, ``hot()``). The port's tick is
designed to wait for the card at a handful of fetches -- one fused
buffer (or its dense refetch), the pre-pass's takes, the bound's [R]
totals, the relaxation's outputs, the sweep's leftover totals and each
replacement pass's results, and on the sidecar each op's reply --
and nowhere else. This witness checks
that on a running tick:

- inside ``hot(label)`` the witness sets ``torch.cuda.set_sync_debug_mode
  ("warn")``, under which torch warns at the synchronizing CUDA calls it
  detects (a device-to-host copy, a pageable host-to-device copy,
  ``.item()``; torch calls the mode a prototype that does not catch
  every one), and captures those warnings;
- each one is attributed to the first frame of the port's package on
  the stack (``file:line``), and is **sanctioned** when the stack passes
  through a function of ``SANCTIONED_FETCH``;
- ``stats()`` reports the sanctioned count and the unsanctioned sites
  with their counts. The witness records; it does not fail the tick.

The retrace half of the JAX witness has no counterpart: the port compiles
nothing per shape (the kernels build once per process). Its ``aot_phase()``
has one: the warm-up ladder (solver/aot.py) captures CUDA graphs on its own
thread, and ``torch.cuda.graph`` synchronizes on entry; a synchronizing
call made by a thread inside ``aot_phase()`` is booked apart
(``aot_exempt`` in ``stats()``), never as one of the tick's unsanctioned
sites.

On a host without CUDA the debug mode is not set; a caller may still
raise the same warning itself (``SYNC_MESSAGE``) -- the tests do, from a
patched ``Tensor.cpu`` -- to drive the bookkeeping on the CPU.
Importing this module imports nothing of torch.
"""
from __future__ import annotations

import os
import sys
import threading
import warnings
from typing import Any, Dict, Optional, Tuple

# the port's designed host barriers: (path from the repository root,
# function name). A synchronizing call with one of these on its stack is
# the tick's own wait for the card.
SANCTIONED_FETCH = frozenset({
    ("karpenter_tpu_torch/solver/ffd.py", "fetch_fused"),
    # the dense refetch when the sparse take overflows, and the
    # existing-node pre-pass's [C, N] takes: the same seams the JAX
    # package's manifest blesses (analysis/checkers/jax_discipline.py)
    ("karpenter_tpu_torch/solver/ffd.py", "solve_dense_tuple"),
    ("karpenter_tpu_torch/solver/service.py", "_pack_existing"),
    ("karpenter_tpu_torch/solver/bound.py", "fetch_bound"),
    ("karpenter_tpu_torch/solver/convex/relax.py", "fetch_relax"),
    # the sweep: kernel B's [S] leftover totals, then one fetch of each
    # replacement pass's (best, best_od, best_k)
    ("karpenter_tpu_torch/solver/disrupt/engine.py", "_dispatch_local"),
    ("karpenter_tpu_torch/solver/disrupt/engine.py", "replace"),
    # the sidecar's ops: each fetches its reply's tensors once, as the JAX
    # manifest's rpc entries (solve_delta reaches _op_solve_compact)
    ("karpenter_tpu_torch/solver/rpc.py", "_op_solve"),
    ("karpenter_tpu_torch/solver/rpc.py", "_op_solve_compact"),
    ("karpenter_tpu_torch/solver/rpc.py", "_op_solve_disrupt"),
    ("karpenter_tpu_torch/solver/rpc.py", "_op_solve_convex"),
    # the mesh (fleet/shard.py, parallel/mesh.py): the engine's one
    # designed host barrier, and a multi-process mesh's all-gather
    ("karpenter_tpu_torch/fleet/shard.py", "fetch"),
    ("karpenter_tpu_torch/parallel/mesh.py", "_fetch_multiprocess"),
})

# what torch's sync debug mode warns (c10/cuda: warn_or_error_on_sync)
SYNC_MESSAGE = "called a synchronizing CUDA operation"

_PKG_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_REPO_PREFIX = os.path.dirname(_PKG_ROOT) + os.sep
_PKG_PREFIX = _PKG_ROOT + os.sep
_MAX_PKG_FRAMES = 16


class _State:
    def __init__(self):
        self.guard = threading.Lock()
        self.hot_depth = 0
        self.hot_labels: list = []
        self.sanctioned = 0
        self.unsanctioned: Dict[str, int] = {}
        self.aot_exempt = 0
        self.saved: Optional[Tuple[Any, Any, Optional[int]]] = None


_state = _State()
# per thread: inside aot_phase() (the warm-up ladder's work)
_tls = threading.local()


def _site_and_sanctioned() -> Tuple[str, bool]:
    """(first package frame as file:line, stack passes through a
    SANCTIONED_FETCH function)."""
    site = "<outside-package>"
    f = sys._getframe(2)
    pkg_frames = 0
    while f is not None and pkg_frames < _MAX_PKG_FRAMES:
        fn = f.f_code.co_filename
        if fn != __file__ and fn.startswith(_PKG_PREFIX):
            rel = fn[len(_REPO_PREFIX):].replace(os.sep, "/")
            if site == "<outside-package>":
                site = f"{rel}:{f.f_lineno}"
            if (rel, f.f_code.co_name) in SANCTIONED_FETCH:
                return site, True
            pkg_frames += 1
        f = f.f_back
    return site, False


def note_sync() -> None:
    """Book one synchronizing call at the caller's stack."""
    site, sanctioned = _site_and_sanctioned()
    with _state.guard:
        if _state.hot_depth <= 0:
            return
        if getattr(_tls, "aot_depth", 0) > 0:
            _state.aot_exempt += 1
        elif sanctioned:
            _state.sanctioned += 1
        else:
            _state.unsanctioned[site] = _state.unsanctioned.get(site, 0) + 1


def _sync_debug_mode(mode):
    """Set torch's sync debug mode and return the previous one; None
    (nothing set) when this host has no CUDA."""
    import torch

    if not torch.cuda.is_available():
        return None
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode(mode)
    return prev


class _HotSection:
    def __init__(self, label: str):
        self.label = label

    def __enter__(self) -> "_HotSection":
        with _state.guard:
            _state.hot_depth += 1
            _state.hot_labels.append(self.label)
            outermost = _state.hot_depth == 1
        if outermost:
            catcher = warnings.catch_warnings()
            catcher.__enter__()
            forward = warnings.showwarning

            def showwarning(message, category, filename, lineno, file=None, line=None):
                if SYNC_MESSAGE in str(message):
                    note_sync()
                else:
                    forward(message, category, filename, lineno, file, line)

            # every sync, not once per location
            warnings.filterwarnings("always", message=".*" + SYNC_MESSAGE)
            warnings.showwarning = showwarning
            _state.saved = (catcher, forward, _sync_debug_mode("warn"))
        return self

    def __exit__(self, *exc: Any) -> bool:
        with _state.guard:
            _state.hot_depth -= 1
            if _state.hot_labels:
                _state.hot_labels.pop()
            outermost = _state.hot_depth == 0
            saved, _state.saved = (_state.saved, None) if outermost else (None, _state.saved)
        if saved is not None:
            catcher, _forward, prev_mode = saved
            if prev_mode is not None:
                _sync_debug_mode(prev_mode)
            catcher.__exit__(None, None, None)
        return False


def hot(label: str = "hot") -> _HotSection:
    """Declare warmup over: until exit, every synchronizing CUDA call on
    this process is booked, sanctioned or by site."""
    return _HotSection(label)


class _AotPhase:
    def __enter__(self) -> "_AotPhase":
        _tls.aot_depth = getattr(_tls, "aot_depth", 0) + 1
        return self

    def __exit__(self, *exc: Any) -> bool:
        _tls.aot_depth -= 1
        return False


def aot_phase() -> _AotPhase:
    """The calling thread's synchronizing calls until exit are the
    warm-up ladder's (jax_witness.aot_phase): booked as ``aot_exempt``,
    never as a hot section's unsanctioned sites."""
    return _AotPhase()


def reset() -> None:
    with _state.guard:
        _state.sanctioned = 0
        _state.unsanctioned.clear()
        _state.aot_exempt = 0


def stats() -> Dict[str, Any]:
    """{"sanctioned_fetches": n, "unsanctioned": {site: count},
    "aot_exempt": n, "hot": depth}: the unsanctioned sites sorted by
    count, most first."""
    with _state.guard:
        return {
            "sanctioned_fetches": _state.sanctioned,
            "aot_exempt": _state.aot_exempt,
            "unsanctioned": dict(sorted(_state.unsanctioned.items(),
                                        key=lambda kv: (-kv[1], kv[0]))),
            "hot": _state.hot_depth,
        }
