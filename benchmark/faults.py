"""Faults planted under the timed path, for the correctness check to
catch: a step that leaves its state unchanged, half of the batch left
out, an answer altered where it is produced, and in the merged route of
several NodePools a node opened in the wrong pool or sized without its
pool's daemonset reserve. One card, so no exchange between chips to
leave out.

    python3 benchmark/faults.py --workload np1-50k.wave \\
        --faults none full_repack_unchanged --seeds 1 2 3 --seconds 10

Runs the cell on the card as run.py does, once a seed for each fault
(`none`: nothing planted), and prints one JSON line a run: whether it came
out correct and each number the check compared. The benchmark's own runs
do not run it; benchmark/tests/test_bench_faults.py plants the same faults
under test-sized cells on the CPU.
"""
import argparse
import contextlib
import io
import json
import sys
from pathlib import Path
from unittest import mock

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
sys.path.insert(0, str(HERE.parent))


def _scan_unchanged(orig):
    import torch

    def scan(*ops, **kw):
        take, unplaced, n_open, gmask, gzc = orig(*ops, **kw)
        return (torch.zeros_like(take), ops[6].clone(), torch.zeros_like(n_open),
                torch.zeros_like(gmask), torch.zeros_like(gzc))
    return scan


def _scan_altered(orig):
    def scan(*ops, **kw):
        take, unplaced, n_open, gmask, gzc = orig(*ops, **kw)
        take, unplaced = take.clone(), unplaced.clone()
        c, g = (take > 1).nonzero()[0].tolist()
        take[c, g] -= 1
        unplaced[c] += 1
        return take, unplaced, n_open, gmask, gzc
    return scan


def _schedule_half(orig):
    def schedule(self, scheduler, pods):
        return orig(self, scheduler, list(pods)[: len(pods) // 2])
    return schedule


def _full_repack_unchanged(orig):
    """Kernel B's full entry (the pre-pass onto standing nodes, whichever
    route runs it) places nothing: every pod left over, no takes."""
    import torch

    def dispatch(self, headroom, feas, req, member, excl):
        left, takes = orig(self, headroom, feas, req, member, excl)
        return member.to(left.dtype).clone(), torch.zeros_like(takes)
    return dispatch


def _repack_unchanged(orig):
    def leftover(headroom, feas, req, member, excl):
        return member.clone()
    return leftover


def _evaluate_half(orig):
    def evaluate(self, nodes, sets, *a, **kw):
        return orig(self, nodes, list(sets)[: len(sets) // 2], *a, **kw)
    return evaluate


def _replace_altered(orig):
    def replace(*a, **kw):
        best, best_od, best_k = orig(*a, **kw)
        return best + 0.5, best_od, best_k
    return replace


def _pools_reversed(orig):
    """The merged route opens each class in the lightest pool that admits
    it, not the heaviest."""
    def open_allowed_mask(classes, admitted_all, *a, **kw):
        return orig(classes, [list(reversed(adm)) for adm in admitted_all], *a, **kw)
    return open_allowed_mask


def _reserve_dropped(orig):
    """The merged catalog's columns leave out their pools' daemonset reserves."""
    def build_merged(pools, catalogs, overheads=()):
        return orig(pools, catalogs)
    return build_merged


def targets() -> dict:
    """fault -> (owner, attribute, wrapper of the original)."""
    from karpenter_tpu_torch.solver import multipool
    from karpenter_tpu_torch.solver.disrupt import engine, kernel
    from karpenter_tpu_torch.solver.kernels import ffd_scan
    from karpenter_tpu_torch.solver.service import TorchSolver

    return {
        "scan_unchanged": (ffd_scan, "fused_scan", _scan_unchanged),
        "scan_altered": (ffd_scan, "fused_scan", _scan_altered),
        "batch_half": (TorchSolver, "schedule", _schedule_half),
        "full_repack_unchanged": (TorchSolver, "_dispatch_disrupt_repack",
                                  _full_repack_unchanged),
        "repack_unchanged": (kernel, "disrupt_repack_leftover", _repack_unchanged),
        "sets_half": (engine.DisruptEngine, "evaluate", _evaluate_half),
        "replace_altered": (kernel, "disrupt_replace", _replace_altered),
        "pools_reversed": (multipool, "open_allowed_mask", _pools_reversed),
        "reserve_dropped": (multipool, "build_merged", _reserve_dropped),
    }


@contextlib.contextmanager
def planted(fault: str):
    """The program with `fault` planted (`none`: as it is)."""
    if fault == "none":
        yield
        return
    owner, name, wrap = targets()[fault]
    with mock.patch.object(owner, name, wrap(getattr(owner, name))):
        yield


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--faults", nargs="+", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    args = ap.parse_args(argv)

    import harness

    harness.program.load(harness.cache_dirs())
    for seed in args.seeds:
        for fault in args.faults:
            log = io.StringIO()
            with planted(fault):
                doc = harness.run(args.workload, seed, args.seconds, False, "cuda", out=log)
            print(json.dumps({"workload": args.workload, "fault": fault, "seed": seed,
                              "correct": doc["correct"], "attempted": doc["attempted"],
                              "checks": {k: v["value"] for k, v in doc["checks"].items()}}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
