#!/usr/bin/env python3
"""Time kernel A built from this checkout against kernel A built from another source, on one NVIDIA GPU.

    python3 hack/ffd_scan_versions.py --baseline PATH [--candidate NAME=PATH ...]
                                   [--rounds 5]   (repository root; one card)

PATH is another version of karpenter_tpu_torch/csrc/ffd_scan.cu (for
example a parent commit's: `git show HEAD~1:karpenter_tpu_torch/csrc/
ffd_scan.cu > kernel-compare/ffd_scan_base.cu`) whose C entry takes no
wide-group scratch (the version before the wide steps). Each
`--candidate` is a variant of the checkout's source with its C entry
(an edit to try). All are built, one nvcc each, all at once, with the
kernels' own nvcc flags into karpenter_tpu_torch/build/versions/,
checked exact against `fused_scan_reference` on every case, and timed in
turns (baseline, checkout, the candidates, then the reverse, `--rounds`
times; CUDA
events around 10 back-to-back launches, median of 10) on the operands of
chip_smoke.py's worlds at full width: solve ticks 1 and 2 (price), tick 1
under the fit objective, the zone-spread ticks 1 and 2 through
schedule(), the merged catalogs (K=1280 lean, K=1920 scratch), and the
every-type world of `cases.every_type` (K=640, fit), and tick 1's first
16 rows with one real class (the operator's wave scans). Every version
runs through the checkout's wrapper (the baseline's library behind a shim
that drops the scratch pointer). Each version's host enqueue time a call
(200 calls, no sync between) and its device time alone (the stream held
by a spin kernel while the host enqueues 10 calls) are taken too. Prints
one JSON line
per phase; the last holds, per case, each version's median and range,
microseconds a real class step, the surviving types of the groups opened
(median, most) and the card's `nvidia-smi` name and power limit.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from karpenter_tpu_torch import workload  # noqa: E402
from karpenter_tpu_torch.apis import NodePool  # noqa: E402
from karpenter_tpu_torch.apis import labels as wk  # noqa: E402
from karpenter_tpu_torch.scheduling import Requirement  # noqa: E402
from karpenter_tpu_torch.solver import encode, ffd, packing  # noqa: E402
from karpenter_tpu_torch.solver.kernels import build, cases  # noqa: E402
from karpenter_tpu_torch.solver.kernels import ffd_scan as ka  # noqa: E402
from karpenter_tpu_torch.solver.oracle import Scheduler, SchedulingResult  # noqa: E402
from karpenter_tpu_torch.solver.service import TorchSolver  # noqa: E402

SEED = 20_260_101   # chip_smoke.py's worlds
G_MAX = 1024


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


def build_versions(sources: dict) -> dict:
    """name -> (loaded library, its ptxas -v lines); one nvcc per source,
    all started together. The baseline's entry takes 17 pointers, the
    others' 18 (the wide-group scratch)."""
    out_dir = build.BUILD_DIR / "versions"
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "block_ops.cuh").write_text((build.CSRC / "block_ops.cuh").read_text())
    procs = {}
    for name, path in sources.items():
        src = out_dir / f"ffd_scan_{name}.cu"
        src.write_text(Path(path).read_text())
        lib_path = out_dir / f"ffd_scan_{name}.so"
        procs[name] = (lib_path, subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(lib_path), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    out = {}
    for name, (lib_path, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc exited {proc.returncode}\n{log}")
        lib = ctypes.CDLL(str(lib_path))
        n_ptr = 17 if name == "baseline" else 18
        lib.ffd_scan_launch.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        lib.ffd_scan_launch.restype = ctypes.c_int
        out[name] = (lib, [ln.strip() for ln in log.splitlines() if "ptxas" in ln])
    return out




class _Baseline:
    """The baseline's library behind the checkout's own wrapper: its C
    entry takes no wide-group scratch, so that pointer is dropped."""

    def __init__(self, lib):
        self.lib = lib

    def ffd_scan_launch(self, *args):
        return self.lib.ffd_scan_launch(*args[:17], *args[18:])


def launch_with(lib, ops, objective: str):
    """Kernel A through the checkout's wrapper (its checks, its outputs),
    `lib` swapped in for the checkout's library."""
    library = ka._library
    ka._library = lambda: lib
    try:
        return ka._launch(*ops, g_max=G_MAX, objective=objective)
    finally:
        ka._library = library


def operands(dev) -> dict:
    """case -> (kernel A's operands, objective)."""
    items = workload.build_catalog_items()
    pool = NodePool("default")
    zones = set(workload.ZONES)
    rec = []
    scan = ka.fused_scan

    def recording(*ops, **kw):
        rec.append(ops)
        return scan(*ops, **kw)

    def sched(pools, existing=(), pods_by_node=None):
        return Scheduler(nodepools=pools, instance_types={p.name: items for p in pools},
                         existing_nodes=existing, pods_by_node=pods_by_node, zones=zones)

    solver = TorchSolver(g_max=G_MAX, device=dev)
    entry = solver._catalog(items)
    pods1 = workload.synth_pods(np.random.default_rng(SEED), workload.ZONES, 50_000, salt=1)
    pods2 = workload.synth_pods(np.random.default_rng(SEED + 1), workload.ZONES, 10_000, salt=2)
    nodes = workload.nodes_from_result(solver.solve(pool, items, pods1))
    classes1 = encode.group_pods(pods1, extra_requirements=pool.requirements())
    classes2 = encode.group_pods(pods2, extra_requirements=pool.requirements())
    cs1 = solver._encode(pool, entry, classes1, np.zeros(len(classes1), dtype=np.int64))
    placed2 = solver._pack_existing(classes2, nodes, SchedulingResult())
    cs2 = solver._encode(pool, entry, classes2, placed2)

    def scan_ops(cs, objective):
        inp = ffd.make_inputs_staged(entry.staged, cs, packed_masks=True)
        return ffd.scan_operands(inp, entry.offsets, entry.words, objective)

    out = {"tick 1": (scan_ops(cs1, "price"), "price"), "tick 2": (scan_ops(cs2, "price"), "price"),
           "tick 1, fit objective": (scan_ops(cs1, "fit"), "fit")}
    spot_od = [NodePool(name, weight=w, requirements=[Requirement(wk.CAPACITY_TYPE_LABEL, "In", [name])])
               for name, w in ((wk.CAPACITY_TYPE_SPOT, 100), (wk.CAPACITY_TYPE_ON_DEMAND, 10))]
    sp1 = workload.synth_pods(np.random.default_rng(SEED), workload.ZONES, 50_000, salt=1, spread=16)
    sp2 = workload.synth_pods(np.random.default_rng(SEED + 1), workload.ZONES, 10_000, salt=2,
                              spread=16)
    ka.fused_scan = recording
    try:
        s1 = solver.schedule(sched([pool]), sp1)
        out["spread t1"] = (rec[-1], "price")
        solver.schedule(sched([pool], workload.nodes_from_result(s1), workload.pods_by_node(s1)), sp2)
        out["spread t2"] = (rec[-1], "price")
        solver.schedule(sched(spot_od), pods1)
        out["merged K=1280"] = (rec[-1], "price")
        solver.schedule(sched(spot_od + [NodePool("default")]), pods1)
        out["merged 3 pools K=1920"] = (rec[-1], "price")
    finally:
        ka.fused_scan = scan
    out["every type K=640"] = (cases.every_type(scan_ops(cs1, "fit")), "fit")
    # a 16-row scan with one real class (as the operator's wave ticks give
    # kernel A): the launch's fixed costs
    one = tuple(t[:16].clone() for t in out["tick 1"][0][:9]) + out["tick 1"][0][9:]
    one[1][1:] = 0
    one[2][1:] = 0
    out["one real class C=16"] = (one, "price")
    return out


def device_ms(fn, batch: int = 10, hold_cycles: int = 20_000_000) -> float:
    """Milliseconds a launch on the device alone: the stream is held by a
    spin kernel while the host enqueues the batch, so the batch runs back
    to back whatever the host's cost a call."""
    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(hold_cycles)
    a.record()
    for _ in range(batch):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / batch


def enqueue_us(fn, calls: int = 200) -> float:
    """Host microseconds a call, the card kept busy behind them (no sync
    inside)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) * 1e6 / calls


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--baseline", type=Path, required=True)
    ap.add_argument("--candidate", action="append", default=[], metavar="NAME=PATH")
    ap.add_argument("--rounds", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ffd_scan_versions: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    dev = torch.device("cuda")
    build.build(["ffd_scan"])
    candidates = dict(c.split("=", 1) for c in args.candidate)
    libs = build_versions({"baseline": args.baseline, **candidates})
    emit({"phase": "build", "ptxas": {"checkout": build.BUILD_LOG.get("ffd_scan", {}).get("ptxas"),
                                      **{name: lines for name, (_, lines) in libs.items()}}})
    versions = {"baseline": lambda ops, obj: launch_with(_Baseline(libs["baseline"][0]), ops, obj),
                "checkout": lambda ops, obj: ka.fused_scan(*ops, g_max=G_MAX, objective=obj)}
    for name in candidates:
        versions[name] = lambda ops, obj, lib=libs[name][0]: launch_with(lib, ops, obj)
    worlds = operands(dev)
    equal, shape = {}, {}
    for case, (ops, obj) in worlds.items():
        want = ka.fused_scan_reference(*ops, g_max=G_MAX, objective=obj)
        for name, fn in versions.items():
            equal[f"{name} {case}"] = all(torch.equal(a, b) for a, b in zip(fn(ops, obj), want))
        k = ops[9].shape[0]
        n = packing.unpack_rows(want[3][: int(want[2])], k).sum(1)
        shape[case] = {"C": ops[0].shape[0], "K": k, "layout": ka.layout(G_MAX, k, ops[0].shape[1]),
                       "real_classes": len(cases.real_classes(ops)),
                       "group_types_median_max": (float(n.float().median()), int(n.max()))}
    emit({"phase": "equal", "equal": equal, "shapes": shape})
    if not all(equal.values()):
        raise AssertionError("a version differs from the plain version")
    raw = {case: {name: [] for name in versions} for case in worlds}
    host = {case: {name: [] for name in versions} for case in worlds}
    dev_only = {case: {name: [] for name in versions} for case in worlds}
    for _ in range(args.rounds):
        for name in list(versions) + list(versions)[::-1]:
            for case, (ops, obj) in worlds.items():
                raw[case][name].append(cuda_ms(lambda: versions[name](ops, obj)))
                host[case][name].append(enqueue_us(lambda: versions[name](ops, obj)))
                dev_only[case][name].append(device_ms(lambda: versions[name](ops, obj)))
    summary = {}
    for case, per in raw.items():
        real = shape[case]["real_classes"]
        summary[case] = {**shape[case], **{
            name: {"median_ms": statistics.median(v), "min_ms": min(v), "max_ms": max(v), "runs": len(v),
                   "us_per_real_step": statistics.median(v) * 1e3 / real,
                   "enqueue_us_median": statistics.median(host[case][name]),
                   "device_only_ms_median": statistics.median(dev_only[case][name])}
            for name, v in per.items()}}
    emit({"phase": "times", "timing": "CUDA events around 10 back-to-back launches, median of 10; "
          "versions in turns, in order then reversed", "summary": summary,
          "nvidia_smi": smi})
    return 0


if __name__ == "__main__":
    sys.exit(main())
