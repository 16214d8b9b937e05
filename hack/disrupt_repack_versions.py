#!/usr/bin/env python3
"""Time kernel B built from this checkout against kernel B built from another source, on one NVIDIA GPU.

    python3 hack/disrupt_repack_versions.py --baseline OLD.cu [--candidate NAME=PATH ...]
                                           [--rounds 5]   (repository root; one card)

OLD.cu is an earlier karpenter_tpu_torch/csrc/disrupt_repack.cu (for
example the parent commit's: `git show HEAD~1:karpenter_tpu_torch/csrc/
disrupt_repack.cu > kernel-compare/disrupt_repack_base.cu`) whose C entry
takes the same arguments but writes the takes always and reads its
scratch as headroom only (the version before the leftover-only entry).
Each `--candidate` is a variant of the checkout's source (an edit to
try, such as a smaller cap on the sweep kernel's sets a block). All are built, one nvcc each, all at once, with the kernels' own
nvcc flags into karpenter_tpu_torch/build/versions/, checked exact
against `repack_reference`, and timed in turns (the versions in order,
then reversed, `--rounds` times; CUDA events around 10 back-to-back
launches, median of 10) on the operands of chip_smoke.py's worlds:

- the pre-pass of solve tick 2 (S=1, C=128, N=1024), the same with
  1,000 more of every resource on every node and at least one pod a
  feasible class (every feasible class steps), that on its first 64
  nodes, and the pre-pass of the zone-spread wave (S=1, zone-pinned
  rows);
- the sweeps as DisruptEngine launches them: `bench-sweep`, the 50k
  tick's `rampdown-sweep` under `default` and `spot-od`, `steady-sweep`
  (S=512), the ramp-down sweep over 500 candidates (S=1024), and the first
  64 sets of the spot-od sweep (a mesh shard's);
- dense random worlds (C=128, N=1024; every class of every set holds pods):
  S=64 with long walks (headroom 0-63, 0-39 pods a pair, as
  hack/torch_repack_forks.py's S=64 world), S=64 with walks of about one
  piece (headroom 0-1,999, 0-2 pods), and S=512 with long walks.

Versions: `baseline` (its full entry, as the sweep ran it); `checkout`
(the entry the path launches: the full one at S=1, the leftover-only one
on a sweep); at S=1 `checkout sweep kernel` (the full entry through the
sweep kernel, which the wrapper picks only for several sets); on the
sweeps `checkout full` (the full entry), `checkout block` (the
leftover-only entry through the block kernel alone) and `checkout sweep
alone` (through the sweep kernel with no hand-off to the block kernel);
each candidate through the checkout's wrapper. Each version's device time alone
(the stream held by a spin kernel while the host enqueues 10 calls) and
its host enqueue time a call (200 calls, no sync between) are taken too:
a call whose enqueue outlasts its kernel is timed by the host in the
events column. Prints one JSON line per phase; the last holds, per case,
each version's medians and range, the case's (set, class) density and
the card's `nvidia-smi` name and power limit.
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
from karpenter_tpu_torch.solver import encode  # noqa: E402
from karpenter_tpu_torch.solver.disrupt import DisruptEngine  # noqa: E402
from karpenter_tpu_torch.solver.disrupt import kernel as disrupt_kernel  # noqa: E402
from karpenter_tpu_torch.solver.kernels import build  # noqa: E402
from karpenter_tpu_torch.solver.kernels import disrupt_repack as kb  # noqa: E402
from karpenter_tpu_torch.solver.oracle import Scheduler  # noqa: E402
from karpenter_tpu_torch.solver.service import TorchSolver  # noqa: E402

SEED = 20_260_101   # chip_smoke.py's worlds
DENSE = {  # name -> (S, headroom below, pods a pair below)
    "random S=64 dense, long walks": (64, 64, 40),
    "random S=64 dense, short walks": (64, 2000, 3),
    "random S=512 dense, long walks": (512, 64, 40),
}


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


def device_ms(fn, batch: int = 10, hold_cycles: int = 20_000_000) -> float:
    """Milliseconds a call on the device alone: the stream is held by a
    spin kernel while the host enqueues the batch."""
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
    """Host microseconds a call, the card kept busy behind them."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) * 1e6 / calls


def build_versions(sources: dict) -> dict:
    """name -> (loaded library, its ptxas -v lines); one nvcc per source,
    all started together."""
    out_dir = build.BUILD_DIR / "versions"
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "block_ops.cuh").write_text((build.CSRC / "block_ops.cuh").read_text())
    procs = {}
    for name, path in sources.items():
        src = out_dir / f"disrupt_repack_{name}.cu"
        src.write_text(Path(path).read_text())
        lib_path = out_dir / f"disrupt_repack_{name}.so"
        procs[name] = (lib_path, subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(lib_path), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    out = {}
    for name, (lib_path, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc exited {proc.returncode}\n{log}")
        lib = ctypes.CDLL(str(lib_path))
        # the baseline's entry has no spill pointer and no sweep_sets argument
        n_ptr, n_int = (8, 7) if name == "baseline" else (9, 8)
        lib.disrupt_repack_launch.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int + [ctypes.c_void_p]
        lib.disrupt_repack_launch.restype = ctypes.c_int
        lib.disrupt_repack_max_r.argtypes = []
        lib.disrupt_repack_max_r.restype = ctypes.c_int
        out[name] = (lib, [ln.strip() for ln in log.splitlines() if "ptxas" in ln])
    return out


def baseline_launch(lib, ops):
    """The earlier kernel as its own wrapper launched it: takes always
    written, headroom resident in shared memory (every case here fits),
    one node a thread, its chunk formula (R + 1 words a staged class)."""
    headroom0, feas, req, member, excl = ops
    S, N = excl.shape
    C, R = req.shape
    nw = (N + 31) // 32
    chunk = min(C, 256)
    while chunk > 1 and 4 * (N * (R + 1) + chunk * (nw + R + 1) + (chunk + 31) // 32 + 96) > kb.SMEM_LIMIT:
        chunk //= 2
    leftover = torch.empty((S, C), dtype=torch.int32, device=req.device)
    takes = torch.empty((S, C, N), dtype=torch.int32, device=req.device)
    threads = min(1024, max(32, (N + 31) // 32 * 32))
    err = lib.disrupt_repack_launch(
        headroom0.data_ptr(), req.data_ptr(), feas.data_ptr(), member.data_ptr(), excl.data_ptr(),
        leftover.data_ptr(), takes.data_ptr(), None, S, C, N, R, threads, chunk, 1,
        torch.cuda.current_stream().cuda_stream)
    build.check(err, "disrupt_repack baseline")
    return leftover, takes


def with_library(lib, fn):
    """fn() through the checkout's wrapper with `lib` swapped in."""
    library = kb._library
    kb._library = lambda: lib
    try:
        return fn()
    finally:
        kb._library = library


def operands(dev) -> dict:
    """case -> kernel B's operands, as the path launches them."""
    items = workload.build_catalog_items()
    pool = NodePool("default")
    solver = TorchSolver(g_max=1024, device=dev)
    pods1 = workload.synth_pods(np.random.default_rng(SEED), workload.ZONES, 50_000, salt=1)
    pods2 = workload.synth_pods(np.random.default_rng(SEED + 1), workload.ZONES, 10_000, salt=2)
    tick1 = solver.solve(pool, items, pods1)
    nodes = workload.nodes_from_result(tick1)
    classes2 = encode.group_pods(pods2, extra_requirements=pool.requirements())
    out = {"tick 2 pre-pass": disrupt_kernel.repack_from_numpy(
        *solver._repack_operands(classes2, nodes), dev)}
    # the same pre-pass with room for every class on every node it may use:
    # every feasible class with pods steps (no step is proven a no-op)
    h, f, q, m, x = out["tick 2 pre-pass"]
    out["tick 2 pre-pass, every feasible class steps"] = (
        h + 1000.0, f, q, torch.where(f.any(1)[None, :], torch.clamp_min(m, 1), m), x)
    # the same on its first 64 nodes (the size of chip_smoke.py's kube world)
    f64 = f[:, :64].contiguous()
    out["tick 2 pre-pass, 64 nodes, every feasible class steps"] = (
        (h[:64] + 1000.0).contiguous(), f64, q, torch.where(f64.any(1)[None, :], torch.clamp_min(m, 1), m),
        x[:, :64].contiguous())
    rec = []
    full, left = kb.disrupt_repack, kb.disrupt_repack_leftover

    def rec_full(*ops):
        rec.append(ops)
        return full(*ops)

    def rec_left(*ops):
        rec.append(ops)
        return left(*ops)

    kb.disrupt_repack, kb.disrupt_repack_leftover = rec_full, rec_left
    try:
        zones = set(workload.ZONES)
        sp1 = workload.synth_pods(np.random.default_rng(SEED), workload.ZONES, 50_000, salt=1, spread=16)
        sp2 = workload.synth_pods(np.random.default_rng(SEED + 1), workload.ZONES, 10_000, salt=2,
                                  spread=16)
        s1 = solver.schedule(Scheduler(nodepools=[pool], instance_types={pool.name: items},
                                       zones=zones), sp1)
        del rec[:]
        solver.schedule(Scheduler(nodepools=[pool], instance_types={pool.name: items},
                                  existing_nodes=workload.nodes_from_result(s1),
                                  pods_by_node=workload.pods_by_node(s1), zones=zones), sp2)
        out["spread t2 pre-pass"] = rec[0]
        sweeps = {
            "bench-sweep": (workload.bench_sweep_spec(), "default"),
            "rampdown-sweep default": (workload.rampdown_sweep_spec(
                tick1, np.random.default_rng(SEED + 3)), "default"),
            "rampdown-sweep spot-od": (workload.rampdown_sweep_spec(
                tick1, np.random.default_rng(SEED + 3)), "spot-od"),
            "steady-sweep spot-od": (workload.rampdown_sweep_spec(
                tick1, np.random.default_rng(SEED + 3), keep=1.0), "spot-od"),
            "rampdown-sweep 500 candidates": (workload.rampdown_sweep_spec(
                tick1, np.random.default_rng(SEED + 3), n_cand=500), "spot-od"),
        }
        engine = DisruptEngine(solver=solver)
        for name, (spec, kind) in sweeps.items():
            nodes_s, sets_s = workload.sweep_world(spec)
            pools, ovh = workload.sweep_pools(kind)
            del rec[:]
            engine.evaluate(nodes_s, sets_s, pools=pools, catalogs={p.name: items for p in pools},
                            daemon_overhead=ovh)
            out[name] = rec[0]
    finally:
        kb.disrupt_repack, kb.disrupt_repack_leftover = full, left
    out["mesh shard (64 sets of spot-od)"] = (
        *out["rampdown-sweep spot-od"][:3], *(t[:64].contiguous() for t in out["rampdown-sweep spot-od"][3:]))
    C, N = 128, 1024
    for name, (S, h_max, m_max) in DENSE.items():
        rng = np.random.default_rng(7)
        out[name] = disrupt_kernel.repack_from_numpy(
            rng.integers(0, h_max, (N, encode.R)).astype(np.float32), rng.random((C, N)) < 0.7,
            rng.integers(0, 5, (C, encode.R)).astype(np.float32), rng.integers(0, m_max, (S, C)),
            rng.random((S, N)) < 0.2, dev)
    return out


def density(ops) -> dict:
    spans = kb.class_spans(ops[0], ops[1], ops[2])
    m = ops[3].to(torch.int64)
    step = (m < spans[:, 0]) | (m > spans[:, 1])
    real = (ops[3] != 0).any(1)
    return {"S": int(ops[3].shape[0]), "C": int(ops[3].shape[1]), "N": int(ops[4].shape[1]),
            "feasible_classes": int(ops[1].any(1).sum()), "sets_with_pods": int(real.sum()),
            "stepping_pairs": int(step.sum()), "stepping_share_of_s_by_c": int(step.sum()) / step.numel(),
            "stepping_classes_a_set_max": int(step.sum(1).max())}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--baseline", type=Path, required=True)
    ap.add_argument("--candidate", action="append", default=[], metavar="NAME=PATH")
    ap.add_argument("--rounds", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("disrupt_repack_versions: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    dev = torch.device("cuda")
    build.build(["disrupt_repack"])
    candidates = dict(c.split("=", 1) for c in args.candidate)
    libs = build_versions({"baseline": args.baseline, **candidates})
    emit({"phase": "build", "ptxas": {"checkout": build.BUILD_LOG.get("disrupt_repack", {}).get("ptxas"),
                                      **{name: lines for name, (_, lines) in libs.items()}}})
    worlds = operands(dev)

    def versions_of(ops):
        """name -> (call, the entry's outputs compared: "full" or "leftover")."""
        sweep = ops[3].shape[0] > 1
        out = {"baseline": (lambda: baseline_launch(libs["baseline"][0], ops), "full")}
        if sweep:
            out["checkout"] = (lambda: kb.disrupt_repack_leftover(*ops), "leftover")
            out["checkout full"] = (lambda: kb.disrupt_repack(*ops), "full")
            out["checkout block"] = (lambda: kb._launch(*ops, with_takes=False, sweep=False)[0],
                                     "leftover")
            out["checkout sweep alone"] = (lambda: kb._launch(*ops, with_takes=False, sweep=True)[0],
                                           "leftover")
        else:
            out["checkout"] = (lambda: kb.disrupt_repack(*ops), "full")
            out["checkout sweep kernel"] = (lambda: kb._launch(*ops, sweep=True), "full")
        for name in candidates:
            lib = libs[name][0]
            if sweep:
                out[name] = (lambda lib=lib: with_library(lib, lambda: kb.disrupt_repack_leftover(*ops)),
                             "leftover")
            else:
                out[name] = (lambda lib=lib: with_library(lib, lambda: kb.disrupt_repack(*ops)), "full")
        return out

    equal, shapes, calls = {}, {}, {}
    for case, ops in worlds.items():
        want = kb.repack_reference(*ops)
        calls[case] = versions_of(ops)
        for name, (fn, kind) in calls[case].items():
            got = fn()
            got = got if kind == "full" else (got,)
            equal[f"{name} {case}"] = all(torch.equal(a, b) for a, b in zip(got, want))
        shapes[case] = density(ops)
    emit({"phase": "equal", "equal": equal, "shapes": shapes})
    if not all(equal.values()):
        raise AssertionError("a version differs from the plain version")
    raw = {case: {name: [] for name in per} for case, per in calls.items()}
    alone = {case: {name: [] for name in per} for case, per in calls.items()}
    host = {case: {name: [] for name in per} for case, per in calls.items()}
    for _ in range(args.rounds):
        for case, per in calls.items():
            names = list(per)
            for name in names + names[::-1]:
                raw[case][name].append(cuda_ms(per[name][0]))
                alone[case][name].append(device_ms(per[name][0]))
                host[case][name].append(enqueue_us(per[name][0]))
    summary = {case: {**shapes[case], **{
        name: {"median_ms": statistics.median(v), "min_ms": min(v), "max_ms": max(v), "runs": len(v),
               "device_only_ms_median": statistics.median(alone[case][name]),
               "enqueue_us_median": statistics.median(host[case][name])}
        for name, v in per.items()}} for case, per in raw.items()}
    emit({"phase": "times", "timing": "CUDA events around 10 back-to-back launches, median of 10; "
          "versions in turns, in order then reversed", "summary": summary, "nvidia_smi": smi})
    return 0


if __name__ == "__main__":
    sys.exit(main())
