#!/usr/bin/env python3
"""Time kernel B's two build-time forks against each other on one NVIDIA GPU.

    python3 hack/torch_repack_forks.py [--rounds 10]   (repository root; one card)

karpenter_tpu_torch/csrc/disrupt_repack.cu stages feasibility with
16-byte loads packed to bits when N % 16 == 0 (warp ballots otherwise),
and fixes R = 9 at compile time (run-time R otherwise). This builds four
variants of the source -- each fork on and off -- with the kernels' own
nvcc flags into karpenter_tpu_torch/build/forks/, checks each against
`repack_reference`, and times them in turns (in order, then reversed,
`--rounds` times; CUDA events around 10 back-to-back launches, median of
10) on the provisioning solve's pre-pass operands (tick 2 of
chip_smoke.py: S=1, C=128, N=1024, R=9) and on a random S=64 world of
the same C and N, both through the block kernel alone (`sweep=False`:
the wrapper gives several sets to the sweep kernel first). Prints one JSON line per phase; the last holds the
medians, ranges and the card's `nvidia-smi` name and power limit.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from karpenter_tpu_torch import workload  # noqa: E402
from karpenter_tpu_torch.apis import NodePool  # noqa: E402
from karpenter_tpu_torch.solver import encode  # noqa: E402
from karpenter_tpu_torch.solver.disrupt import kernel as disrupt_kernel  # noqa: E402
from karpenter_tpu_torch.solver.kernels import build  # noqa: E402
from karpenter_tpu_torch.solver.kernels import disrupt_repack as kb  # noqa: E402
from karpenter_tpu_torch.solver.service import TorchSolver  # noqa: E402

SEED = 20_260_101   # chip_smoke.py's worlds
VEC16 = ("const int vec16 = N % 16 == 0 && ((uintptr_t)feas & 15u) == 0;", "const int vec16 = 0;")
RT9 = ("const int rt9 = R == 9;", "const int rt9 = 0;")
VARIANTS = {"vec16+R9": [], "ballot+R9": [VEC16], "vec16+runtimeR": [RT9], "ballot+runtimeR": [VEC16, RT9]}


def emit(doc: dict) -> None:
    print(json.dumps(doc), flush=True)


def cuda_ms(fn, reps: int = 10, warmup: int = 3, batch: int = 10) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(batch):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / batch)
    return statistics.median(times)


def block(ops):
    """Kernel B's full entry through the block kernel alone."""
    return kb._launch(*ops, sweep=False)


def build_variants() -> dict:
    """name -> loaded library, one nvcc per variant, all started together."""
    src = (build.CSRC / "disrupt_repack.cu").read_text()
    out_dir = build.BUILD_DIR / "forks"
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "block_ops.cuh").write_text((build.CSRC / "block_ops.cuh").read_text())
    procs = {}
    for name, edits in VARIANTS.items():
        text = src
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: the fork's line is not in disrupt_repack.cu: {old}")
            text = text.replace(old, new)
        stem = name.replace("+", "_")
        (out_dir / f"{stem}.cu").write_text(text)
        lib = out_dir / f"{stem}.so"
        procs[name] = (lib, subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(lib), str(out_dir / f"{stem}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (path, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc exited {proc.returncode}\n{log}")
        lib = ctypes.CDLL(str(path))
        lib.disrupt_repack_launch.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
        lib.disrupt_repack_launch.restype = ctypes.c_int
        lib.disrupt_repack_max_r.argtypes = []
        lib.disrupt_repack_max_r.restype = ctypes.c_int
        libs[name] = lib
    return libs


def operands(dev) -> dict:
    """case -> kernel B's operands."""
    items = workload.build_catalog_items()
    pool = NodePool("default")
    solver = TorchSolver(g_max=1024, device=dev)
    pods1 = workload.synth_pods(np.random.default_rng(SEED), workload.ZONES, 50_000, salt=1)
    pods2 = workload.synth_pods(np.random.default_rng(SEED + 1), workload.ZONES, 10_000, salt=2)
    nodes = workload.nodes_from_result(solver.solve(pool, items, pods1))
    classes2 = encode.group_pods(pods2, extra_requirements=pool.requirements())
    tick2 = disrupt_kernel.repack_from_numpy(*solver._repack_operands(classes2, nodes), dev)
    C, N = tick2[1].shape
    rng = np.random.default_rng(7)
    s64 = disrupt_kernel.repack_from_numpy(
        rng.integers(0, 64, (N, encode.R)).astype(np.float32), rng.random((C, N)) < 0.7,
        rng.integers(0, 5, (C, encode.R)).astype(np.float32), rng.integers(0, 40, (64, C)),
        rng.random((64, N)) < 0.2, dev)
    return {f"tick2 S=1 C={C} N={N}": tick2, f"random S=64 C={C} N={N}": s64}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_repack_forks: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    dev = torch.device("cuda")
    libs = build_variants()
    cases = operands(dev)
    equal = {}
    for name, lib in libs.items():
        kb._library = lambda lib=lib: lib
        for case, ops in cases.items():
            equal[f"{name} {case}"] = all(
                torch.equal(a, b) for a, b in zip(block(ops), kb.repack_reference(*ops)))
    emit({"phase": "equal", "equal": equal})
    if not all(equal.values()):
        raise AssertionError("a variant differs from the plain version")
    raw = {case: {name: [] for name in libs} for case in cases}
    order = list(libs.items())
    for _ in range(args.rounds):
        for name, lib in order + order[::-1]:
            kb._library = lambda lib=lib: lib
            for case, ops in cases.items():
                raw[case][name].append(cuda_ms(lambda: block(ops)))
    summary = {case: {name: {"median": statistics.median(v), "min": min(v), "max": max(v), "runs": len(v)}
                      for name, v in per.items()} for case, per in raw.items()}
    emit({"phase": "times", "timing": "CUDA events around 10 back-to-back launches, median of 10; "
          "variants in turns, in order then reversed", "summary": summary, "nvidia_smi": smi})
    return 0


if __name__ == "__main__":
    sys.exit(main())
