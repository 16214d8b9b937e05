"""Build and load the hand-written CUDA kernels.

Each source in karpenter_tpu_torch/csrc/*.cu becomes its own shared
library with a plain C interface, compiled by nvcc for sm_90a (the H100)
at first use and loaded with ctypes. Libraries land in
karpenter_tpu_torch/build/, named by a hash of the sources and flags, so
an edit rebuilds and an unchanged tree loads what is there. `build()`
starts one nvcc per source, all at once.

Never built with --use_fast_math: the kernels must divide with IEEE
rounding, and -fmad=false keeps each multiply and add rounded apart, as
the reference computes them.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, Sequence

PKG_ROOT = Path(__file__).resolve().parents[2]
CSRC = PKG_ROOT / "csrc"
BUILD_DIR = PKG_ROOT / "build"
SOURCES = ("ffd_scan", "disrupt_repack")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-fmad=false", "-Xptxas", "-v",
)

# name -> {"seconds": wall seconds of its nvcc, "ptxas": ptxas -v lines}
# for libraries built by this process (absent when loaded from the cache)
BUILD_LOG: Dict[str, dict] = {}
_LIBS: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is installed")
    return found


def _library_path(name: str) -> Path:
    h = hashlib.sha256()
    for path in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names: Sequence[str] = SOURCES) -> Dict[str, Path]:
    """Compile every library in `names` that is not built yet, one nvcc
    per source, all started together. Returns name -> library path."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {name: _library_path(name) for name in names}
    todo = [name for name in names if not paths[name].exists()]
    if not todo:
        return paths
    nvcc = nvcc_path()
    procs = {}
    for name in todo:
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
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
        # rename into place: two processes building one source race benignly
        os.replace(tmp, paths[name])
        BUILD_LOG[name] = {
            "seconds": seconds,
            "ptxas": [ln.strip() for ln in out.splitlines() if "ptxas" in ln or "Used" in ln],
        }
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return paths


def library(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = _LIBS[name] = ctypes.CDLL(str(build([name])[name]))
    return lib


def check(err: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launch entry."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
