#!/usr/bin/env python3
"""Does the warm-up ladder's mesh tasks make the first tick after a reshard faster?

    python3 hack/mesh_warm_probe.py [--pods 50000] [--device cuda] [--pads 16,32]
    (repository root; --device cpu --pods 800 --pads 16,32 checks it on the host)

`AotManager._mesh_tasks` (karpenter_tpu_torch/solver/aot.py) warm-calls
the sharded fused solve and bound of the current layout (tier 0) and of
every shrunk layout of the degrade ladder (tier 1) before any device is
lost. This runs, in fresh child processes, one `TorchSolver(mesh=
MeshSolveEngine(make_mesh(8, devices=[dev] * 8)))` with `enable_aot`
drained before tick 1, in two variants: `tasks` (the ladder as shipped)
and `none` (the same ladder with `_mesh_tasks` returning no task). Each
child solves tick 1 of the 627-type catalog (K=640, g_max 1024, the
price objective) twice on 8 shards, then loses shard 7, then 6-3, then
2 and 1 (`mark_device_lost`: 8 -> 4 -> 2 -> unsharded) and solves the same tick
twice at each rung; every solve is timed on the host clock ending in a
device sync. Children run none, tasks, tasks, none. Prints one JSON line
per child and, last, the medians per variant beside the card's
`nvidia-smi` name and power limit.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
SEED = 20_260_101
G_MAX = 1024
# shards lost before each rung: 8, then 7 healthy (4 shards), 3 (2), 1 (unsharded)
RUNGS = ((), (7,), (6, 5, 4, 3), (2, 1))


def child(variant: str, pods_n: int, device: str, pads) -> dict:
    import numpy as np
    import torch

    sys.path.insert(0, str(REPO))
    from karpenter_tpu_torch import workload
    from karpenter_tpu_torch.apis import NodePool
    from karpenter_tpu_torch.fleet import MeshSolveEngine
    from karpenter_tpu_torch.parallel.mesh import make_mesh
    from karpenter_tpu_torch.solver import aot
    from karpenter_tpu_torch.solver.service import TorchSolver

    if variant == "none":
        aot.AotManager._mesh_tasks = lambda self, entry, pads: []
    dev = torch.device(device)
    items = workload.build_catalog_items()
    pods = workload.synth_pods(np.random.default_rng(SEED), workload.ZONES, pods_n, salt=1)
    pool = NodePool("default")
    engine = MeshSolveEngine(make_mesh(8, devices=[dev] * 8))
    solver = TorchSolver(g_max=G_MAX, mesh=engine)
    mgr = solver.enable_aot(None, duty=1.0, pads=pads)
    t0 = time.perf_counter()
    solver._catalog(items)
    drained = mgr.drain(600)
    drain_s = time.perf_counter() - t0
    mesh_tasks = sum(len(d["tasks"]) for d in solver.describe_aot()["mesh_tasks"])

    def timed() -> float:
        t = time.perf_counter()
        solver.solve(pool, items, pods)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        return (time.perf_counter() - t) * 1e3

    rungs = []
    try:
        for lost in RUNGS:
            for idx in lost:
                engine.mark_device_lost(idx, reason="probe")
            first, second = timed(), timed()
            rungs.append({"shards": engine.describe()["devices"], "first_ms": first,
                          "second_ms": second})
    finally:
        mgr.stop(timeout_s=60.0)
    return {"variant": variant, "drained": drained, "drain_s": drain_s,
            "mesh_tasks": mesh_tasks, "rungs": rungs}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--pods", type=int, default=50_000)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--pads", default="", help="class-count buckets to warm "
                    "(default: TorchSolver.WARM_C_PADS)")
    ap.add_argument("--child", default=None)
    args = ap.parse_args()
    if args.child:
        pads = tuple(int(p) for p in args.pads.split(",")) if args.pads else None
        print(json.dumps(child(args.child, args.pods, args.device, pads)), flush=True)
        return 0
    docs = []
    for variant in ("none", "tasks", "tasks", "none"):
        r = subprocess.run([sys.executable, __file__, "--child", variant, "--pods",
                            str(args.pods), "--device", args.device, "--pads", args.pads],
                           cwd=REPO,
                           capture_output=True, text=True, timeout=900)
        if r.returncode != 0:
            print(r.stdout[-2000:], r.stderr[-4000:], file=sys.stderr)
            return 1
        doc = json.loads(r.stdout.strip().splitlines()[-1])
        print(json.dumps(doc), flush=True)
        docs.append(doc)
    try:
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip()
    except OSError:
        card = "not measured (no nvidia-smi)"
    summary = {}
    for variant in ("none", "tasks"):
        runs = [d for d in docs if d["variant"] == variant]
        summary[variant] = {
            "drain_s": [d["drain_s"] for d in runs],
            "rungs": [{"shards": runs[0]["rungs"][i]["shards"],
                       "first_ms": statistics.median(d["rungs"][i]["first_ms"] for d in runs),
                       "second_ms": statistics.median(d["rungs"][i]["second_ms"] for d in runs)}
                      for i in range(len(RUNGS))]}
    print(json.dumps({"summary": summary, "card": card, "device": args.device,
                      "pods": args.pods, "note": "median of 2 children a variant; host clock "
                      "ending in a device sync"}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
