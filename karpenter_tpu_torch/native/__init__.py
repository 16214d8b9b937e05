"""Native (C) components of the port's host side.

Copy of karpenter_tpu/native/__init__.py. The scheduling tick's hottest
host loop -- bucketing 50k pending pods into equivalence classes every
tick -- runs as a CPython extension (_grouping.c, byte-identical to the
JAX package's). It is built on first import with the system compiler (no
pip, no network): one translation unit against the running interpreter's
headers, cached as a shared object under karpenter_tpu_torch/build/native/
(never next to the source) and rebuilt only when the source changes.
When no compiler is available, or $KARPENTER_TPU_NO_NATIVE is set,
`grouping` is None and encode.group_pods runs the pure-Python loop: the
same classes in the same order, the JAX package's host behaviour.

`grouping` is the imported module or None; see encode.group_pods and
IncrementalGrouper.group for the call sites and tests/test_torch_native.py
for equivalence coverage. The extension loads under its own spec name,
karpenter_tpu_torch.native._grouping, so it lives beside the JAX package's
in one process, each with its own interned strings.
"""
from __future__ import annotations

import hashlib
import os
import subprocess
import sys
import sysconfig

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "_grouping.c")
BUILD_DIR = os.path.join(os.path.dirname(_DIR), "build", "native")
SPEC_NAME = "karpenter_tpu_torch.native._grouping"


def _build() -> str | None:
    """Compile _grouping.c into BUILD_DIR; returns the .so path or None.
    The object name carries a source hash and the interpreter tag, so
    stale builds are never loaded and concurrent builders converge on the
    same file."""
    try:
        with open(_SRC, "rb") as f:
            digest = hashlib.sha256(f.read()).hexdigest()[:12]
    except OSError:
        return None
    tag = f"cp{sys.version_info.major}{sys.version_info.minor}"
    so_path = os.path.join(BUILD_DIR, f"_grouping_{tag}_{digest}.so")
    if os.path.exists(so_path):
        return so_path
    cc = os.environ.get("CC", "cc")
    include = sysconfig.get_path("include")
    cflags = ["-O2", "-fPIC", "-shared", "-fno-strict-aliasing"]
    tmp = so_path + f".tmp{os.getpid()}"
    try:
        os.makedirs(BUILD_DIR, exist_ok=True)
        subprocess.run(
            [cc, *cflags, f"-I{include}", _SRC, "-o", tmp],
            check=True, capture_output=True, timeout=120,
        )
        os.replace(tmp, so_path)  # atomic: concurrent builders race safely
        return so_path
    except (OSError, subprocess.SubprocessError):
        try:
            os.unlink(tmp)
        except OSError:
            pass
        return None


def _load():
    if os.environ.get("KARPENTER_TPU_NO_NATIVE"):
        return None
    so_path = _build()
    if so_path is None:
        return None
    import importlib.util

    spec = importlib.util.spec_from_file_location(SPEC_NAME, so_path)
    if spec is None or spec.loader is None:
        return None
    try:
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod
    except Exception:  # noqa: BLE001 - the pure-Python loop on any load failure
        return None


grouping = _load()
