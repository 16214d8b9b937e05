"""The benchmark's command: one run of one cell of BENCHMARK.json.

    python3 benchmark/run.py --workload np1-50k.wave --seed 7 --seconds 20 --trace 0

Prints the run's result as one JSON object on the last line of standard
output, and each number the correctness check compared beside its limit
on the last lines of standard error. Runs on a CUDA card only: without
one, or with fewer cards than the cell asks for, it exits 2 and prints
no result.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
sys.path.insert(0, str(HERE.parent))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import harness
    import torch

    cell, _, _ = harness.cell_files(harness.manifest(), args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {cell['chips']} CUDA card(s); {have} available",
              file=sys.stderr)
        return 2
    doc = harness.run(args.workload, args.seed, args.seconds, bool(args.trace), "cuda", t0=T0)
    for name, v in doc["checks"].items():
        print(f"check {name}: {v['value']!r} (limit {v['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(doc), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
