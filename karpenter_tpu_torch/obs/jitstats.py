"""Per-entry device cost attribution: which entry costs what, per tick.

Counterpart of karpenter_tpu/obs/jitstats.py, under its metric families
(metrics.py), names, help texts and labels. `install()` wraps every
registered device entry -- `JIT_ENTRY_FUNCTIONS` below, the port's own
registry (a copy in spirit of karpenter_tpu/analysis/checkers/
jax_discipline.py's `JIT_ENTRY_FUNCTIONS`: the JAX package's entries the
port has, plus the two kernel wrappers) -- in a probe that

- counts the call and its wall time into the entry's row. Kernels run
  asynchronously, so this is host ENQUEUE time (the prologue's torch ops,
  the launch, the epilogue's); the device timeline is the profiler
  capture's job (obs/profiler.py) -- the column is `dispatch_ms` for
  that reason;
- attributes compiles: in the port a "compile" is a kernel library
  loaded (from the store) or built (nvcc) inside the call. Both are
  booked per thread (solver/kernels/build.py `thread_compile_totals`),
  so a delta across one probe call belongs to that entry; a load on the
  warm-up ladder's thread never lands on a tick's row.

Every call site calls through the module attribute, so the probe sees
every dispatch. An armed dispatch of the warm-up ladder (solver/aot.py)
replays a captured CUDA graph, or on the CPU calls the entry's original,
and is not a probed call: the JAX package's AOT executables bypass its
probes alike. The ladder's own captures land on the `aot` columns
(`note_aot`), never on the hot-path compile columns.

`table()` adds `cache_size` to each installed entry: for a kernel
wrapper, 1 once its library is loaded in this process; for any other
entry, the CUDA graphs (or CPU closures) armed for it.
Cost: two clock reads and a few counter bumps per dispatch.
"""
from __future__ import annotations

import importlib
import os
import sys
import threading
import time
from typing import Any, Dict

from karpenter_tpu_torch.metrics import (  # noqa: F401  -- the JAX module's names
    COMPILE_CACHE_BYTES, COMPILE_CACHE_HITS, COMPILE_CACHE_MISSES, JIT_AOT_COMPILE_SECS,
    JIT_AOT_COMPILES, JIT_COMPILE_SECS, JIT_COMPILES, JIT_DISPATCH_SECS, JIT_DISPATCHES,
)

# module -> device entry names: the JAX package's jit entries the port has
# (ffd_solve, ffd_solve_compact, ffd_solve_fused, disrupt_repack,
# disrupt_replace, fractional_price_bound, convex_relax) under the same
# module paths, and the kernel wrappers (the Pallas entries' places)
JIT_ENTRY_FUNCTIONS: Dict[str, tuple] = {
    "karpenter_tpu_torch.solver.ffd": ("ffd_solve", "ffd_solve_compact", "ffd_solve_fused"),
    "karpenter_tpu_torch.solver.disrupt.kernel": ("disrupt_repack", "disrupt_replace"),
    "karpenter_tpu_torch.solver.bound": ("fractional_price_bound",),
    "karpenter_tpu_torch.solver.convex.relax": ("convex_relax",),
    "karpenter_tpu_torch.solver.kernels.ffd_scan": ("fused_scan",),
    "karpenter_tpu_torch.solver.kernels.disrupt_repack": ("disrupt_repack", "disrupt_repack_leftover"),
}

# (module, function) probed and booked on another entry's row: the sweep's
# leftover-only repack runs kernel B as `disrupt_repack` does, and the JAX
# package serves the sweep by `disrupt_repack` itself
BOOKED_AS: Dict[tuple, str] = {
    ("karpenter_tpu_torch.solver.disrupt.kernel", "disrupt_repack_leftover"):
        "karpenter_tpu_torch.solver.disrupt.kernel.disrupt_repack",
    ("karpenter_tpu_torch.solver.kernels.disrupt_repack", "disrupt_repack_leftover"):
        "karpenter_tpu_torch.solver.kernels.disrupt_repack.disrupt_repack",
}

# kernel wrapper entry -> the library its kernel lives in
_KERNEL_LIBRARIES = {
    "karpenter_tpu_torch.solver.kernels.ffd_scan.fused_scan": "ffd_scan",
    "karpenter_tpu_torch.solver.kernels.disrupt_repack.disrupt_repack": "disrupt_repack",
}

_lock = threading.Lock()
# entry -> [dispatches, dispatch_secs, compiles, compile_secs]
_table: Dict[str, list] = {}
# entry family -> [aot compiles, aot compile secs] (the warm-up ladder)
_aot_table: Dict[str, list] = {}
# modname -> {fn_name: original}; non-empty = installed
_originals: Dict[str, Dict[str, Any]] = {}


def _probe(entry: str, fn):
    from karpenter_tpu_torch.solver.kernels import build

    thread_totals = build.thread_compile_totals

    def probed(*args: Any, **kwargs: Any):
        t0 = time.perf_counter()
        # THIS thread's loads and builds: a concurrent one (the warm-up
        # ladder, a sidecar handler) lands in its own thread's ledger
        n0, s0 = thread_totals()
        try:
            return fn(*args, **kwargs)
        finally:
            dt = time.perf_counter() - t0
            n1, s1 = thread_totals()
            d_n, d_s = n1 - n0, s1 - s0
            with _lock:
                row = _table.setdefault(entry, [0, 0.0, 0, 0.0])
                row[0] += 1
                row[1] += dt
                row[2] += d_n
                row[3] += d_s
            JIT_DISPATCHES.inc(entry=entry)
            JIT_DISPATCH_SECS.inc(dt, entry=entry)
            if d_n:
                JIT_COMPILES.inc(d_n, entry=entry)
                JIT_COMPILE_SECS.inc(d_s, entry=entry)

    probed._karpenter_jit_probe = True  # type: ignore[attr-defined]
    probed.__wrapped__ = fn  # type: ignore[attr-defined]
    probed.__name__ = getattr(fn, "__name__", entry)
    probed.__doc__ = getattr(fn, "__doc__", None)
    return probed


def install() -> int:
    """Wrap every registered entry with the dispatch probe; returns the
    number of probes installed. Idempotent. Imports the solver modules --
    callers are the operator (which already built a solver) and scripts."""
    installed = 0
    targets = [(modname, fn_name) for modname, fns in JIT_ENTRY_FUNCTIONS.items() for fn_name in fns]
    targets += [key for key in BOOKED_AS if key not in targets]
    for modname, fn_name in targets:
        mod = importlib.import_module(modname)
        saved = _originals.setdefault(modname, {})
        if fn_name in saved:
            continue
        fn = getattr(mod, fn_name, None)
        if fn is None or getattr(fn, "_karpenter_jit_probe", False):
            continue
        saved[fn_name] = fn
        setattr(mod, fn_name, _probe(BOOKED_AS.get((modname, fn_name), f"{modname}.{fn_name}"), fn))
        installed += 1
    return installed


def original(modname: str, fn_name: str):
    """The pre-probe function of an installed entry, or None -- the
    warm-up ladder (solver/aot.py) arms THIS, so its armed dispatches are
    not probed calls."""
    return _originals.get(modname, {}).get(fn_name)


def note_aot(entry: str, secs: float) -> None:
    """Attribute one warm-up-ladder task to `entry`'s AOT row (the
    phase="aot" seam: solver/aot.py calls this per ladder task)."""
    with _lock:
        row = _aot_table.setdefault(entry, [0, 0.0])
        row[0] += 1
        row[1] += secs
    JIT_AOT_COMPILES.inc(entry=entry)
    JIT_AOT_COMPILE_SECS.inc(secs, entry=entry)


def update_cache_bytes(path: str) -> int:
    """Walk the versioned store directory and publish its size (called at
    startup and by /debug/aot scrapes, never per tick)."""
    total = 0
    for dirpath, _dirnames, filenames in os.walk(path):
        for name in filenames:
            try:
                total += os.path.getsize(os.path.join(dirpath, name))
            except OSError:
                continue
    COMPILE_CACHE_BYTES.set(float(total))
    return total


def cache_stats() -> Dict[str, float]:
    """{hits, misses, bytes} of the kernel-library store."""
    return {
        "hits": COMPILE_CACHE_HITS.value(),
        "misses": COMPILE_CACHE_MISSES.value(),
        "bytes": COMPILE_CACHE_BYTES.value(),
    }


def uninstall() -> None:
    for modname, saved in _originals.items():
        mod = sys.modules.get(modname)
        if mod is None:
            continue
        for fn_name, fn in saved.items():
            setattr(mod, fn_name, fn)
    _originals.clear()


def installed() -> bool:
    return bool(_originals)


def reset() -> None:
    with _lock:
        _table.clear()
        _aot_table.clear()


def entry_cache_sizes() -> Dict[str, int]:
    """Per installed entry: what it has resident -- a kernel wrapper's
    loaded library (0 or 1), any other entry's armed graphs."""
    from karpenter_tpu_torch.solver.kernels import build

    sizes: Dict[str, int] = {}
    aot_mod = sys.modules.get("karpenter_tpu_torch.solver.aot")
    armed = aot_mod.armed_by_entry() if aot_mod is not None else {}
    for modname, saved in list(_originals.items()):
        for fn_name in saved:
            if (modname, fn_name) in BOOKED_AS:
                continue    # its row's own entry says what the row holds
            entry = f"{modname}.{fn_name}"
            lib = _KERNEL_LIBRARIES.get(entry)
            sizes[entry] = int(lib in build._LIBS) if lib else armed.get(fn_name, 0)
    return sizes


def table() -> Dict[str, Dict[str, Any]]:
    """The accounting table, per entry: {dispatches, dispatch_ms,
    compiles, compile_ms, cache_size} plus {aot_compiles, aot_compile_ms}
    for the ladder's entry families ({} while probes are not installed
    and nothing was recorded)."""
    with _lock:
        rows = {k: list(v) for k, v in _table.items()}
        aot_rows = {k: list(v) for k, v in _aot_table.items()}
    if not rows and not aot_rows and not _originals:
        return {}
    sizes = entry_cache_sizes()
    out: Dict[str, Dict[str, Any]] = {}
    for entry, (dispatches, d_secs, compiles, c_secs) in sorted(rows.items()):
        out[entry] = {
            "dispatches": dispatches,
            "dispatch_ms": round(d_secs * 1e3, 3),
            "compiles": compiles,
            "compile_ms": round(c_secs * 1e3, 3),
        }
        if entry in sizes:
            out[entry]["cache_size"] = sizes[entry]
    # the warm-up ladder's tasks ride along under their own columns
    for entry, (n, secs) in sorted(aot_rows.items()):
        row = out.setdefault(entry, {"dispatches": 0, "dispatch_ms": 0.0,
                                     "compiles": 0, "compile_ms": 0.0})
        row["aot_compiles"] = n
        row["aot_compile_ms"] = round(secs * 1e3, 3)
    # installed entries never dispatched still show what they hold
    for entry, size in sorted(sizes.items()):
        out.setdefault(entry, {"dispatches": 0, "dispatch_ms": 0.0,
                               "compiles": 0, "compile_ms": 0.0, "cache_size": size})
    return out
