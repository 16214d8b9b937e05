"""Multi-process mesh dry run: one mesh whose shards live in several processes.

    python -m karpenter_tpu_torch.parallel.dryrun --ranks 2 --device cpu
    python -m karpenter_tpu_torch.parallel.dryrun --ranks 2

The card is the default (one card a rank); with fewer cards than ranks
it exits 2 and names the card count, as `parse_mesh_spec` refuses a
mesh larger than the machine.

The port's counterpart of the JAX package's `dryrun_multichip(8,
n_processes=N)`: N worker processes join one torch.distributed world
through `parallel.mesh.init_distributed` (the JAX package's three
variables; `gloo` on the CPU, `nccl` on cards -- one card a rank, since
NCCL refuses two ranks on one GPU), build one 8-shard mesh whose shards
are split rank-major over the world, and run the sharded dense solve,
the sharded bound and the sharded repack on the same seeded inputs. Each
rank builds its own shards from its full host copy, the shards' results
all-gather before the local read, and every rank compares them with its
own unsharded result. Prints one JSON line; exits 0 when every rank saw
byte-identical results.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import time
from typing import List, Optional

SHARDS = 8


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _world_inputs(device):
    """A seeded small world: the generated catalog at K=640, 120 pods of
    the workload generator, and a repack pool of 16 sets."""
    import numpy as np

    from karpenter_tpu_torch import workload
    from karpenter_tpu_torch.apis import NodePool
    from karpenter_tpu_torch.solver import encode, ffd

    catalog = encode.encode_catalog(workload.build_catalog_items(), k_pad=640)
    pods = workload.synth_pods(np.random.default_rng(7), workload.ZONES, 120, salt=7)
    classes = encode.group_pods(pods, extra_requirements=NodePool("default").requirements())
    cs = encode.encode_classes(classes, catalog)
    staged, offsets, words = ffd.stage_catalog(catalog, device)
    inp = ffd.make_inputs_staged(staged, cs, packed_masks=True)
    rng = np.random.default_rng(3)
    N, C, S, R = 16, 8, 16, encode.R
    repack = (
        rng.integers(0, 9000, (N, R)).astype(np.float32), rng.random((C, N)) < 0.8,
        rng.integers(1, 600, (C, R)).astype(np.float32),
        rng.integers(0, 6, (S, C)).astype(np.int32), rng.random((S, N)) < 0.2,
    )
    return inp, offsets, words, cs.count.astype(np.float32), repack


def worker(rank: int, world: int, port: int, device_kind: str, out_path: str) -> int:
    os.environ["JAX_COORDINATOR_ADDRESS"] = f"127.0.0.1:{port}"
    os.environ["JAX_NUM_PROCESSES"] = str(world)
    os.environ["JAX_PROCESS_ID"] = str(rank)
    import torch
    import torch.distributed as dist

    from karpenter_tpu_torch.parallel import mesh as mesh_mod
    from karpenter_tpu_torch.solver import bound, ffd
    from karpenter_tpu_torch.solver.disrupt import kernel as disrupt_kernel

    torch.set_num_threads(1)
    if device_kind == "cuda":
        torch.cuda.set_device(rank)
        dev = torch.device("cuda", rank)
    else:
        dev = torch.device("cpu")
    mesh_mod.init_distributed()
    per = SHARDS // world
    mesh = mesh_mod.make_mesh(SHARDS, devices=[dev] * SHARDS,
                              ranks=[r for r in range(world) for _ in range(per)])
    inp, offsets, words, placed, repack = _world_inputs(dev)
    kw = dict(g_max=64, word_offsets=offsets, words=words, objective="price")
    t0 = time.perf_counter()
    sharded = mesh_mod.sharded_solve(mesh, inp, **kw)
    placed_t = torch.from_numpy(placed).to(dev)
    totals = mesh_mod.sharded_price_bound(mesh, inp, placed_t, word_offsets=offsets,
                                          words=words)
    left, takes = mesh_mod.sharded_repack(mesh, *repack)
    seconds = time.perf_counter() - t0
    single = ffd.ffd_solve(inp, **kw)
    totals1 = bound.fractional_price_bound(inp, placed_t, word_offsets=offsets, words=words)
    ops = disrupt_kernel.repack_from_numpy(*repack, dev)
    left1, takes1 = disrupt_kernel.disrupt_repack(*ops)
    checks = {
        "multiprocess": mesh_mod._is_multiprocess(mesh),
        "solve": all(torch.equal(a.cpu(), b.cpu()) for a, b in zip(single, sharded)),
        "bound": torch.equal(totals1.cpu(), totals.cpu()),
        "repack": torch.equal(left1.cpu(), left.cpu()) and torch.equal(takes1.cpu(), takes.cpu()),
    }
    local = mesh_mod._local_positions(mesh)
    dist.barrier()
    dist.destroy_process_group()
    with open(out_path, "w") as f:
        json.dump({"rank": rank, "checks": checks, "seconds": seconds,
                   "local_shards": local}, f)
    return 0 if all(checks.values()) else 1


def run(ranks: int, device_kind: Optional[str] = None, timeout_s: float = 100.0) -> dict:
    """Spawn `ranks` workers over one world and collect their reports;
    every worker is stopped before this returns. `device_kind` None is
    the card; a world of more ranks than cards raises ValueError."""
    if SHARDS % ranks:
        raise ValueError(f"{SHARDS} shards do not split over {ranks} ranks")
    device_kind = device_kind or "cuda"
    if device_kind == "cuda":
        import torch

        have = torch.cuda.device_count()
        if have < ranks:
            raise ValueError(
                f"a {ranks}-rank dry run needs {ranks} cards (one a rank); "
                f"{have} cuda available"
            )
    port = _free_port()
    tmp = tempfile.mkdtemp(prefix="kt-dryrun-")
    procs: List[subprocess.Popen] = []
    repo = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env = dict(os.environ)
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    t0 = time.perf_counter()
    try:
        for r in range(ranks):
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "karpenter_tpu_torch.parallel.dryrun", "--worker",
                 str(r), str(ranks), str(port), device_kind, os.path.join(tmp, f"{r}.json")],
                env=env, cwd=repo, stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
        deadline = time.monotonic() + timeout_s
        rcs, logs = [], []
        for p in procs:
            try:
                out, _ = p.communicate(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                p.kill()
                out, _ = p.communicate()
            rcs.append(p.returncode)
            logs.append(out.decode(errors="replace")[-2000:])
        reports = []
        for r in range(ranks):
            path = os.path.join(tmp, f"{r}.json")
            if os.path.exists(path):
                with open(path) as f:
                    reports.append(json.load(f))
        ok = (all(rc == 0 for rc in rcs) and len(reports) == ranks
              and all(all(rep["checks"].values()) for rep in reports))
        doc = {"ranks": ranks, "device": device_kind, "shards": SHARDS, "ok": ok,
               "rcs": rcs, "reports": reports, "wall_s": time.perf_counter() - t0}
        if not ok:
            doc["logs"] = logs
        return doc
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(tmp, ignore_errors=True)


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv[:1] == ["--worker"]:
        rank, world, port = (int(v) for v in argv[1:4])
        return worker(rank, world, port, argv[4], argv[5])
    parser = argparse.ArgumentParser(prog="karpenter-tpu-torch-dryrun")
    parser.add_argument("--ranks", type=int, default=2)
    parser.add_argument("--device", choices=("cpu", "cuda"), default="cuda")
    parser.add_argument("--timeout", type=float, default=100.0)
    args = parser.parse_args(argv)
    try:
        doc = run(args.ranks, args.device, args.timeout)
    except ValueError as e:
        print(f"karpenter-tpu-torch-dryrun: {e}", file=sys.stderr)
        return 2
    print(json.dumps(doc, sort_keys=True), flush=True)
    return 0 if doc["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
