"""The correctness check's control: the plain reference put in the
program's place and computed in bfloat16, the precision next below the
float32 the configurations state, judged by the same check against the
float32 reference. A check that passes the control cannot tell a
lower-precision program from a sound one.

    python3 benchmark/control.py --workload np1-50k.wave --seeds 1 2 3

Prints, for each seed, the largest reading of each number the check
compares over every call input of the run (one JSON line a seed). The
benchmark's own runs do not run it.
"""
import argparse
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))


def readings(workload: str, seed: int, doc=None) -> dict:
    import harness
    from gen import traffic
    from reference import common

    _, config, mix = harness.cell_files(doc or harness.manifest(), workload)
    inputs = traffic.build(mix, config, seed)
    driver = harness.DRIVERS[mix["kind"]](inputs, config, None)
    out: dict = {}
    for i in range(driver.n_calls):
        want = driver.reference(i)
        got = driver.reference(i, precision=common.Precision("bfloat16"))
        for k, v in driver.compare(got, want, i).items():
            out[k] = max(out.get(k, 0.0), v)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    for seed in args.seeds:
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control": readings(args.workload, seed)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
