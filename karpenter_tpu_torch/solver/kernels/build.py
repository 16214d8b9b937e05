"""Build and load the hand-written CUDA kernels: the versioned library store.

Each source in karpenter_tpu_torch/csrc/*.cu becomes its own shared
library with a plain C interface, compiled by nvcc for sm_90a (the H100)
at first use and loaded with ctypes. `build()` starts one nvcc per
source, all at once.

The store (counterpart of karpenter_tpu/solver/aot.py's `prepare_cache`,
`fingerprint`, `resolve_root` and `sweep_stale`):

    <root>/<fingerprint>/<name>-<source hash>.so        the library
    <root>/<fingerprint>/<name>-<source hash>.so.json   its manifest

- the root is `$KARPENTER_TPU_COMPILE_CACHE` when it is set, else
  karpenter_tpu_torch/build/ (so `python3 chip_smoke.py` alone builds
  from the checkout's sources);
- the fingerprint pins the runtime a library was built for: the torch
  version, `torch.version.cuda`, nvcc's release, the card's name and
  compute capability, and a hash of NVCC_FLAGS; each library name still
  carries the hash of its sources, so an edit rebuilds;
- `prepare_cache()` (server start) sweeps sibling fingerprint
  directories, counted in karpenter_aot_swept_dirs_total;
- a library built and renamed into place counts as serialized
  (karpenter_aot_serialized_total), one loaded without nvcc as loaded
  (karpenter_aot_loaded_total) and as a compile-cache hit, a build as a
  compile-cache miss;
- a library whose manifest is missing or names another fingerprint, or
  that ctypes cannot load, counts karpenter_aot_fallbacks_total{reason=
  "deserialize"}, is unlinked and is rebuilt: the kernel still runs. A
  library that cannot be written into the store counts {reason=
  "serialize"} and is loaded from a private directory instead.

Each load or build is attributed to the calling thread
(`thread_compile_totals`), so the per-entry table (obs/jitstats.py) books
it on the dispatch that paid for it.

Never built with --use_fast_math: the kernels must divide with IEEE
rounding, and -fmad=false keeps each multiply and add rounded apart, as
the reference computes them.
"""
from __future__ import annotations

import ctypes
import hashlib
import json
import os
import re
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Dict, Optional, Sequence, Tuple

PKG_ROOT = Path(__file__).resolve().parents[2]
CSRC = PKG_ROOT / "csrc"
BUILD_DIR = PKG_ROOT / "build"
SOURCES = ("ffd_scan", "disrupt_repack")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-fmad=false", "-Xptxas", "-v",
)
CACHE_ENV = "KARPENTER_TPU_COMPILE_CACHE"   # store root (versioned under it)
MANIFEST_SUFFIX = ".json"
_MANIFEST_VERSION = 1

# name -> {"seconds": wall seconds of its nvcc, "ptxas": ptxas -v lines}
# for libraries built by this process (absent when loaded from the store)
BUILD_LOG: Dict[str, dict] = {}
_LIBS: Dict[str, ctypes.CDLL] = {}
_lock = threading.RLock()
_store_dir: Optional[Path] = None     # set by prepare_cache / use_store
_fingerprint: Optional[str] = None
_tls = threading.local()


def nvcc_path() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is installed")
    return found


# -- the store's layout --------------------------------------------------------


def _nvcc_release() -> str:
    """nvcc's "release X.Y, VX.Y.Z" tail, or "none" without a toolkit."""
    try:
        out = subprocess.run([nvcc_path(), "--version"], capture_output=True, text=True,
                             timeout=60).stdout
    except (RuntimeError, OSError, subprocess.SubprocessError):
        return "none"
    m = re.search(r"release ([^\s,]+), V(\S+)", out)
    return m.group(2) if m else "unknown"


def fingerprint() -> str:
    """The store's version key: libraries are valid only for one (torch,
    CUDA runtime, nvcc, card, flags) tuple -- any element changing
    invalidates them wholesale. Filesystem-safe; memoized per process."""
    global _fingerprint
    if _fingerprint is None:
        import torch

        if torch.cuda.is_available():
            major, minor = torch.cuda.get_device_capability(0)
            card = f"{torch.cuda.get_device_name(0)}-sm{major}{minor}"
        else:
            card = "nocuda"
        flags = hashlib.sha256(" ".join(NVCC_FLAGS).encode()).hexdigest()[:8]
        raw = (f"torch{torch.__version__}-cuda{torch.version.cuda}-nvcc{_nvcc_release()}"
               f"-{card}-flags{flags}")
        _fingerprint = re.sub(r"[^A-Za-z0-9._-]", "_", raw)
    return _fingerprint


def default_root() -> str:
    return str(BUILD_DIR)


def resolve_root(cache_dir: str = "") -> str:
    """Store-root resolution: explicit arg > $KARPENTER_TPU_COMPILE_CACHE
    > karpenter_tpu_torch/build/."""
    return cache_dir or os.environ.get(CACHE_ENV) or default_root()


def sweep_stale(root: str, keep: str) -> int:
    """Remove every versioned sibling directory except `keep` (server
    start, as the shm segment sweep). Only directories go: loose files at
    the root are inert. Returns the number removed."""
    from karpenter_tpu_torch import metrics

    removed = 0
    try:
        names = sorted(os.listdir(root))
    except OSError:
        return 0
    for name in names:
        path = os.path.join(root, name)
        if name != keep and os.path.isdir(path):
            shutil.rmtree(path, ignore_errors=True)
            metrics.AOT_SWEPT_DIRS.inc()
            removed += 1
    return removed


def prepare_cache(cache_dir: str = "") -> Optional[str]:
    """Make <root>/<fingerprint>/ the process's store, sweep its stale
    siblings and return it; None when the root is unwritable (the store
    is an optimization and never aborts startup: libraries then build
    into the default directory on first use)."""
    root = resolve_root(cache_dir)
    fp = fingerprint()
    home = os.path.join(root, fp)
    try:
        os.makedirs(home, exist_ok=True)
    except OSError:
        return None
    sweep_stale(root, fp)
    use_store(home)
    return home


def use_store(path: str) -> None:
    """Point this process's library lookups and builds at `path`."""
    global _store_dir
    with _lock:
        _store_dir = Path(path)


def store_dir() -> Path:
    """The directory libraries load from and build into: the prepared
    store, else <resolve_root()>/<fingerprint>."""
    with _lock:
        if _store_dir is not None:
            return _store_dir
    return Path(resolve_root()) / fingerprint()


def source_hash(name: str) -> str:
    h = hashlib.sha256()
    for path in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _library_path(name: str) -> Path:
    return store_dir() / f"{name}-{source_hash(name)}.so"


def _manifest(path: Path) -> Path:
    return path.with_name(path.name + MANIFEST_SUFFIX)


def store_stats(path=None) -> Dict[str, int]:
    """{"artifacts": libraries in the store, "bytes": their size on disk}."""
    path = Path(path) if path is not None else store_dir()
    artifacts = total = 0
    try:
        for p in sorted(path.iterdir()):
            if p.suffix == ".so":
                artifacts += 1
                try:
                    total += p.stat().st_size
                except OSError:
                    pass
    except OSError:
        pass
    return {"artifacts": artifacts, "bytes": total}


# -- per-thread attribution ----------------------------------------------------


def thread_compile_totals() -> Tuple[int, float]:
    """(loads and builds, their seconds) made by the calling thread: a
    delta across one dispatch belongs to that dispatch."""
    return getattr(_tls, "n", 0), getattr(_tls, "secs", 0.0)


def note_compile(secs: float) -> None:
    _tls.n = getattr(_tls, "n", 0) + 1
    _tls.secs = getattr(_tls, "secs", 0.0) + secs


# -- build and load ------------------------------------------------------------


class LibraryRejected(RuntimeError):
    """A library in the store failed its manifest check or ctypes refused
    it; the loader counts it, unlinks it and rebuilds."""


def _reject(path: Path, why: str) -> None:
    from karpenter_tpu_torch import metrics
    from karpenter_tpu_torch.logging import get_logger

    metrics.AOT_FALLBACKS.inc(reason="deserialize")
    get_logger("aot").warning("kernel library rejected; rebuilding it", library=path.name,
                              error=why[:200])
    for p in (path, _manifest(path)):
        try:
            os.unlink(p)
        except OSError:
            pass


def load_one(name: str, path: Path) -> ctypes.CDLL:
    """The library at `path`, after its manifest check; LibraryRejected
    when the manifest is missing, of another version or fingerprint, or
    when ctypes cannot load the file."""
    try:
        doc = json.loads(_manifest(path).read_text())
    except (OSError, ValueError) as e:
        raise LibraryRejected(f"unreadable manifest: {e}") from e
    if not isinstance(doc, dict) or doc.get("v") != _MANIFEST_VERSION:
        raise LibraryRejected(f"manifest version {doc.get('v') if isinstance(doc, dict) else '?'}"
                              f" != {_MANIFEST_VERSION}")
    if doc.get("fingerprint") != fingerprint():
        raise LibraryRejected(f"fingerprint {doc.get('fingerprint')!r} != {fingerprint()!r}")
    if doc.get("name") != name:
        raise LibraryRejected(f"manifest names {doc.get('name')!r}, not {name!r}")
    try:
        return ctypes.CDLL(str(path))
    except OSError as e:
        raise LibraryRejected(f"ctypes: {e}") from e


def load_store(names: Sequence[str] = SOURCES) -> Tuple[int, int]:
    """Load every library of `names` present in the store, without nvcc
    (the restart path). Returns (loaded, rejected): a rejected library is
    counted and unlinked, and builds again on first use."""
    loaded = rejected = 0
    for name in names:
        with _lock:
            if name in _LIBS:
                continue
            path = _library_path(name)
            if not path.exists():
                continue
            try:
                _load_counted(name, path)
                loaded += 1
            except LibraryRejected as e:
                _reject(path, str(e))
                rejected += 1
    return loaded, rejected


def _load_counted(name: str, path: Path) -> ctypes.CDLL:
    from karpenter_tpu_torch import metrics

    t0 = time.perf_counter()
    lib = load_one(name, path)
    _LIBS[name] = lib
    note_compile(time.perf_counter() - t0)
    if name not in BUILD_LOG:
        # built by an earlier process: the store saved this one its nvcc
        metrics.AOT_LOADED.inc(entry=name)
        metrics.COMPILE_CACHE_HITS.inc()
    return lib


def build(names: Sequence[str] = SOURCES) -> Dict[str, Path]:
    """Compile every library in `names` that is not in the store yet, one
    nvcc per source, all started together. Returns name -> library path."""
    from karpenter_tpu_torch import metrics

    paths = {name: _library_path(name) for name in names}
    todo = [name for name in names if not paths[name].exists()]
    if not todo:
        return paths
    nvcc = nvcc_path()
    out_dir = paths[todo[0]].parent
    try:
        out_dir.mkdir(parents=True, exist_ok=True)
        probe = tempfile.mkstemp(suffix=".so", dir=out_dir)
        os.close(probe[0])
        os.unlink(probe[1])
    except OSError:
        # the store cannot take the library: build into a private
        # directory, counted; the next process builds again
        metrics.AOT_FALLBACKS.inc(reason="serialize")
        out_dir = Path(tempfile.mkdtemp(prefix="karpenter-kernels-"))
        paths.update({name: out_dir / paths[name].name for name in todo})
    procs = {}
    for name in todo:
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, time.perf_counter(), subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (tmp, t0, proc) in procs.items():
        out, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{out}")
            continue
        metrics.COMPILE_CACHE_MISSES.inc()
        note_compile(seconds)
        BUILD_LOG[name] = {
            "seconds": seconds,
            "ptxas": [ln.strip() for ln in out.splitlines() if "ptxas" in ln or "Used" in ln],
        }
        # manifest first, then the library: a reader that sees the library
        # sees its manifest. Renamed into place: two processes building one
        # source race benignly
        manifest = {"v": _MANIFEST_VERSION, "fingerprint": fingerprint(), "name": name,
                    "source_hash": source_hash(name), "nvcc_seconds": seconds}
        try:
            mtmp = tmp + MANIFEST_SUFFIX
            with open(mtmp, "w") as f:
                json.dump(manifest, f)
            os.replace(mtmp, _manifest(paths[name]))
            os.replace(tmp, paths[name])
            metrics.AOT_SERIALIZED.inc(entry=name)
        except OSError:
            metrics.AOT_FALLBACKS.inc(reason="serialize")
            paths[name] = Path(tmp)
            _manifest(paths[name]).write_text(json.dumps(manifest))
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return paths


def library(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu: from the store when it is
    there and sound, else built (a rejected one is counted, unlinked and
    rebuilt)."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    with _lock:
        lib = _LIBS.get(name)
        if lib is not None:
            return lib
        path = _library_path(name)
        if path.exists():
            try:
                return _load_counted(name, path)
            except LibraryRejected as e:
                _reject(path, str(e))
        # a library just built that fails its own check raises
        return _load_counted(name, build([name])[name])


def check(err: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launch entry."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
