"""`python -m karpenter_tpu_torch sim ...`: the simulation subsystem's CLI.

    sim generate diurnal-small -o trace.jsonl     # compile one scenario
    sim generate --all -o tests/golden/scenarios  # regenerate the corpus
    sim replay trace.jsonl --backend host         # one backend + KPIs
    sim replay --differential trace.jsonl         # host vs wire vs pipelined
    sim replay trace.jsonl --device cpu           # the plain versions, no card
    sim shrink trace.jsonl -o sim-artifacts       # minimize a failing trace
    sim fleet --tenants 3 --device cpu            # N tenants, one sidecar,
                                                  # per-tenant golden digests

Every command prints exactly one JSON line on stdout (the bench/CI
contract) and returns a nonzero exit code on divergence or invariant
violation. Recording a live run is the binary's job:
`python -m karpenter_tpu_torch --sim-record out.jsonl`.

Copy of karpenter_tpu/sim/cli.py, imports rewritten to the port's, with
the `generate`, `replay`, `shrink` and `fleet` verbs. The replay's and the
shrinker's engines run on the card unless `--device cpu` is given.
`generate` needs no engine. The `fleet` verb replays N tenants through
one shared coalescing sidecar (sim/fleet.py), each against the pinned
multi-cluster-storm digests and its isolated replay; it has no `--mesh`,
and no `--update-digests`: the pinned file belongs to the JAX package.
The `corpus` verb waits for A11b (ROADMAP): it re-replays through the
`mesh` backend.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional


def _trace_seed(events: List[dict], override: Optional[int]) -> int:
    if override is not None:
        return override
    for ev in events:
        if ev.get("ev") == "header" and "seed" in ev:
            return int(ev["seed"])
    return 0


def _trace_backends(events: List[dict]):
    """The header's differential backend restriction, or None for the
    default trio. Scenarios whose main phase consolidates pin the
    synchronous backends (sim/scenario.ScenarioBuilder.backends)."""
    for ev in events:
        if ev.get("ev") == "header" and isinstance(ev.get("backends"), list):
            return tuple(str(b) for b in ev["backends"])
    return None


def _cmd_generate(args) -> int:
    from karpenter_tpu_torch.sim.scenario import (
        CORPUS_SCENARIOS, DEFAULT_SEED, STANDARD_SCENARIOS, build_scenario,
    )
    from karpenter_tpu_torch.sim.trace import write_trace

    seed = args.seed if args.seed is not None else DEFAULT_SEED
    names = (
        list(CORPUS_SCENARIOS) if args.all
        else [args.scenario] if args.scenario
        else None
    )
    if not names:
        print(json.dumps({"error": "name a scenario or pass --all",
                          "scenarios": sorted(STANDARD_SCENARIOS)}))
        return 2
    written = {}
    for name in names:
        events = build_scenario(name, seed=seed)
        if args.all or (args.out and os.path.isdir(args.out)):
            out = os.path.join(args.out or ".", f"{name}.jsonl")
        else:
            out = args.out or f"{name}.jsonl"
        os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
        written[name] = {"path": out, "events": write_trace(out, events)}
    print(json.dumps({"generated": written}, sort_keys=True))
    return 0


def _cmd_replay(args) -> int:
    from karpenter_tpu_torch.sim.replay import (
        InvariantViolation, differential, replay,
    )
    from karpenter_tpu_torch.sim.trace import read_trace

    events = read_trace(args.trace)
    seed = _trace_seed(events, args.seed)
    if args.differential:
        from karpenter_tpu_torch.sim.replay import BACKENDS

        res = differential(events, seed=seed,
                           backends=_trace_backends(events) or BACKENDS,
                           device=args.device)
        out = {
            "trace": args.trace, "mode": "differential", "seed": seed,
            "ok": res.ok,
            "digests": {b: r.digest for b, r in res.results.items()},
            "ticks": {b: r.ticks for b, r in res.results.items()},
            "kpis": {b: r.kpis for b, r in res.results.items()},
            "divergences": [
                {"kind": d.kind, "backends": list(d.backends), "detail": d.detail}
                for d in res.divergences
            ],
            "errors": res.errors,
        }
        print(json.dumps(out, sort_keys=True))
        return 0 if res.ok else 1
    try:
        r = replay(events, backend=args.backend, seed=seed, device=args.device)
    except InvariantViolation as e:
        print(json.dumps({
            "trace": args.trace, "backend": args.backend, "seed": seed,
            "ok": False, "invariant_violation": str(e),
        }, sort_keys=True))
        return 1
    if args.log_out:
        with open(args.log_out, "w") as f:
            f.write("\n".join(r.decision_log) + "\n")
    print(json.dumps({
        "trace": args.trace, "backend": args.backend, "seed": seed,
        "ok": True, "digest": r.digest, "ticks": r.ticks,
        "events_applied": r.events_applied, "kpis": r.kpis,
    }, sort_keys=True))
    return 0


def _cmd_shrink(args) -> int:
    from karpenter_tpu_torch.sim.shrink import (
        differential_failing, invariant_failing, shrink_to_repro,
    )
    from karpenter_tpu_torch.sim.trace import read_trace

    events = read_trace(args.trace)
    seed = _trace_seed(events, args.seed)
    failing = (
        differential_failing(seed, device=args.device) if args.mode == "differential"
        else invariant_failing(args.backend, seed, device=args.device)
    )
    name = os.path.splitext(os.path.basename(args.trace))[0]
    path = shrink_to_repro(events, failing, args.out_dir, name,
                           max_probes=args.max_probes)
    if path is None:
        print(json.dumps({"trace": args.trace, "shrunk": None,
                          "note": "trace does not fail; nothing to shrink"},
                         sort_keys=True))
        return 1
    print(json.dumps({
        "trace": args.trace, "shrunk": path,
        "original_events": len(events), "shrunk_events": len(read_trace(path)),
    }, sort_keys=True))
    return 0


def _cmd_fleet(args) -> int:
    """N tenants through one shared coalescing sidecar (sim/fleet.py):
    per-tenant digests must equal their isolated replays AND the goldens
    pinned in multi-cluster-storm.digests.json. The fleet gate. The
    pinned file is read, never written: it belongs to the JAX package."""
    from karpenter_tpu_torch.sim.fleet import replay_fleet
    from karpenter_tpu_torch.sim.scenario import DEFAULT_SEED

    seed = args.seed if args.seed is not None else DEFAULT_SEED
    res = replay_fleet(args.tenants, base_seed=seed, device=args.device)
    digest_path = os.path.join(args.dir, "multi-cluster-storm.digests.json")
    golden = {}
    if os.path.exists(digest_path):
        with open(digest_path) as f:
            golden = json.load(f)
    rc = 0 if res.ok else 1
    report = {
        "tenants": args.tenants, "seed": seed, "mesh": False,
        "digests": res.digests,
        "divergences": list(res.divergences),
    }
    drift = {
        t: {"golden": golden.get(t), "got": d}
        for t, d in res.digests.items()
        if golden.get(t) not in (None, d)
    }
    if drift:
        rc = 1
        report["drift"] = drift
        report["note"] = "per-tenant decision digest drifted from golden"
    print(json.dumps({"fleet": report, "ok": rc == 0}, sort_keys=True))
    return rc


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="karpenter-tpu-torch sim",
        description="trace replay through the port's operator stack",
    )
    sub = parser.add_subparsers(dest="cmd", required=True)
    device_help = ("where the engines run: the card by default; "
                   "'cpu' runs the kernels' plain versions on the host")

    gen = sub.add_parser("generate", help="compile a scenario to a JSONL trace")
    gen.add_argument("scenario", nargs="?")
    gen.add_argument("--all", action="store_true",
                     help="generate the whole committed-corpus set")
    gen.add_argument("--seed", type=int, default=None)
    gen.add_argument("-o", "--out", default=None,
                     help="output file (or directory with --all)")
    gen.set_defaults(fn=_cmd_generate)

    rep = sub.add_parser("replay", help="replay a trace through the operator stack")
    rep.add_argument("trace")
    rep.add_argument("--backend",
                     choices=("host", "wire", "pipelined", "delta", "tcp",
                              "mesh", "packed", "convex"),
                     default="host")
    rep.add_argument("--differential", action="store_true",
                     help="replay through host+wire+pipelined and compare")
    rep.add_argument("--seed", type=int, default=None,
                     help="override the trace header's seed")
    rep.add_argument("--log-out", default="",
                     help="write the decision log to this file")
    rep.add_argument("--device", choices=("cuda", "cpu"), default=None,
                     help=device_help)
    rep.set_defaults(fn=_cmd_replay)

    shr = sub.add_parser("shrink", help="delta-debug a failing trace to a minimal repro")
    shr.add_argument("trace")
    shr.add_argument("--mode", choices=("differential", "invariant"),
                     default="differential")
    shr.add_argument("--backend",
                     choices=("host", "wire", "pipelined", "delta", "tcp",
                              "mesh", "packed", "convex"),
                     default="host", help="backend for --mode invariant")
    shr.add_argument("--seed", type=int, default=None)
    shr.add_argument("--max-probes", type=int, default=2_000)
    shr.add_argument("-o", "--out-dir", default="sim-artifacts")
    shr.add_argument("--device", choices=("cuda", "cpu"), default=None,
                     help=device_help)
    shr.set_defaults(fn=_cmd_shrink)

    flt = sub.add_parser(
        "fleet",
        help="multi-tenant replay: N engines sharing one coalescing "
        "sidecar, per-tenant golden digests (multi-tenant == isolated); "
        "no --mesh (ROADMAP A11b) and no --update-digests (the pinned "
        "file belongs to the JAX package)",
    )
    flt.add_argument("--tenants", type=int, default=3)
    flt.add_argument("--seed", type=int, default=None)
    flt.add_argument("--dir", default="tests/golden/scenarios",
                     help="where multi-cluster-storm.digests.json is read from")
    flt.add_argument("--device", choices=("cuda", "cpu"), default=None,
                     help=device_help)
    flt.set_defaults(fn=_cmd_fleet)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
