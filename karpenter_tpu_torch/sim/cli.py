"""`python -m karpenter_tpu_torch sim ...`: the simulation subsystem's CLI.

    sim generate diurnal-small -o trace.jsonl     # compile one scenario
    sim generate --all -o tests/golden/scenarios  # regenerate the corpus
    sim replay trace.jsonl --backend host         # one backend + KPIs
    sim replay --differential trace.jsonl         # host vs wire vs pipelined
    sim replay trace.jsonl --device cpu           # the plain versions, no card
    sim shrink trace.jsonl -o sim-artifacts       # minimize a failing trace
    sim fleet --tenants 3 --device cpu            # N tenants, one sidecar,
                                                  # per-tenant golden digests
    sim corpus --device cpu                       # every committed scenario,
                                                  # differential + golden digests

Every command prints exactly one JSON line on stdout (the bench/CI
contract) and returns a nonzero exit code on divergence or invariant
violation. Recording a live run is the binary's job:
`python -m karpenter_tpu_torch --sim-record out.jsonl`.

Copy of karpenter_tpu/sim/cli.py, imports rewritten to the port's, with
the `generate`, `replay`, `shrink`, `corpus` and `fleet` verbs. The
replay's and the shrinker's engines run on the card unless `--device cpu`
is given. `generate` needs no engine. The `fleet` verb replays N tenants
through one shared coalescing sidecar (sim/fleet.py; `--mesh` shards it
over 8 shards of the device), each against the pinned
multi-cluster-storm digests and its isolated replay. The `corpus` verb
replays every committed scenario differentially against digests.json and
quality.json, then its legs: `delta`, `mesh` and `packed` on the first
scenario, `mesh` on mesh-device-loss (where the device events reshard),
`convex` on binpack-adversarial-convex (dominance). Neither verb writes a
pinned file -- no `--update-digests`, no `--update-quality`: the goldens
belong to the JAX package -- and a failing scenario is shrunk into
`--artifacts`.
"""
from __future__ import annotations

import argparse
import glob
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


def _cmd_corpus(args) -> int:
    """Replay every committed scenario differentially, verify the golden
    host-backend digests and the quality bounds, and shrink+archive any
    failure. The CI gate. The pinned files are read, never written."""
    from karpenter_tpu_torch.sim.replay import differential
    from karpenter_tpu_torch.sim.shrink import differential_failing, shrink_to_repro
    from karpenter_tpu_torch.sim.trace import read_trace

    traces = sorted(
        p for p in glob.glob(os.path.join(args.dir, "*.jsonl"))
        if not p.endswith("-shrunk.jsonl")
    )
    digest_path = os.path.join(args.dir, "digests.json")
    golden = {}
    if os.path.exists(digest_path):
        with open(digest_path) as f:
            golden = json.load(f)
    # solution-quality regression gate (obs/quality.py KPIs): per-scenario
    # optimality-gap upper bounds pinned next to the digests. Decision
    # digests prove behavior didn't CHANGE; these bounds catch a solver
    # change making the ANSWERS worse while every digest stays green.
    quality_path = os.path.join(args.dir, "quality.json")
    quality_gold = {}
    if os.path.exists(quality_path):
        with open(quality_path) as f:
            quality_gold = json.load(f)
    quality_violations = {}
    report = {}
    new_digests = {}
    host_kpis_by_name = {}
    backends_by_path = {}
    rc = 0
    for path in traces:
        name = os.path.splitext(os.path.basename(path))[0]
        events = read_trace(path)
        seed = _trace_seed(events, None)
        backends_by_path[path] = _trace_backends(events)
        from karpenter_tpu_torch.sim.replay import BACKENDS

        res = differential(events, seed=seed,
                           backends=_trace_backends(events) or BACKENDS,
                           device=args.device)
        host_digest = res.results["host"].digest if "host" in res.results else None
        entry = {
            "ok": res.ok,
            "digest": host_digest,
            "divergences": [
                {"kind": d.kind, "backends": list(d.backends), "detail": d.detail}
                for d in res.divergences
            ],
        }
        new_digests[name] = host_digest
        if not res.ok:
            rc = 1
            entry["shrunk"] = shrink_to_repro(
                events, differential_failing(seed, device=args.device), args.artifacts, name)
        elif golden.get(name) not in (None, host_digest):
            rc = 1
            entry["ok"] = False
            entry["golden_digest"] = golden.get(name)
            entry["note"] = "decision digest drifted from golden"
        host_kpis = res.results["host"].kpis if "host" in res.results else {}
        host_kpis_by_name[name] = host_kpis
        gap_keys = ("optimality_gap_p50", "optimality_gap_final")
        entry["quality"] = {
            k: host_kpis.get(k, 0.0)
            for k in gap_keys + ("stranded_cpu_fraction",
                                 "stranded_memory_fraction",
                                 "fragmentation_index")
        }
        gate = quality_gold.get(name)
        if gate:
            for k in gap_keys:
                cap = gate.get(k + "_max")
                observed = host_kpis.get(k, 0.0)
                if cap is not None and observed > cap:
                    quality_violations.setdefault(name, {})[k] = {
                        "observed": observed, "max": cap,
                    }
        report[name] = entry
    # delta-path gate (incremental-tick engine): one scenario re-replayed
    # through the wire sidecar with delta class shipping + incremental
    # grouping FORCED on; its decision digest must equal the committed
    # host golden bit-for-bit, or the corpus gate fails
    if traces and rc == 0:
        from karpenter_tpu_torch.sim.replay import InvariantViolation, replay

        # anchor on the first trace NOT restricted to the host backend:
        # host-only scenarios (e.g. binpack-adversarial-convex) pin that
        # restriction because their point is a quality comparison, not
        # cross-backend bit-identity, and forcing the wire-shaped legs
        # through one would gate on a digest the scenario never promised
        path = next((p for p in traces
                     if backends_by_path.get(p) != ("host",)), traces[0])
        name = os.path.splitext(os.path.basename(path))[0]
        events = read_trace(path)
        seed = _trace_seed(events, None)
        want = new_digests.get(name) or golden.get(name)
        try:
            dres = replay(events, backend="delta", seed=seed, device=args.device)
            entry = {"ok": dres.digest == want, "digest": dres.digest}
            if not entry["ok"]:
                rc = 1
                entry["golden_digest"] = want
                entry["note"] = "delta-path digest diverged from golden"
        except InvariantViolation as e:
            rc = 1
            entry = {"ok": False, "note": f"delta-path invariant violation: {e}"}
        report[f"delta:{name}"] = entry
        # mesh-path gate (fleet subsystem): the same scenario re-replayed
        # with the production solve SHARDED over the device mesh (the
        # virtual 8-device host mesh in CI); its digest must equal the
        # committed host golden bit-for-bit -- sharded == unsharded,
        # asserted the way host == wire is
        try:
            mres = replay(events, backend="mesh", seed=seed, device=args.device)
            mentry = {"ok": mres.digest == want, "digest": mres.digest}
            if not mentry["ok"]:
                rc = 1
                mentry["golden_digest"] = want
                mentry["note"] = "mesh-path digest diverged from golden"
        except InvariantViolation as e:
            rc = 1
            mentry = {"ok": False, "note": f"mesh-path invariant violation: {e}"}
        report[f"mesh:{name}"] = mentry
        # packed-path gate (bit-packed masks, solver/packing.py): the
        # same scenario re-replayed with the open/join masks shipped as
        # uint32 words end to end; its digest must equal the committed
        # host golden bit-for-bit -- packed == full-width, asserted the
        # way sharded == unsharded is
        try:
            pres = replay(events, backend="packed", seed=seed, device=args.device)
            pentry = {"ok": pres.digest == want, "digest": pres.digest}
            if not pentry["ok"]:
                rc = 1
                pentry["golden_digest"] = want
                pentry["note"] = "packed-path digest diverged from golden"
        except InvariantViolation as e:
            rc = 1
            pentry = {"ok": False, "note": f"packed-path invariant violation: {e}"}
        report[f"packed:{name}"] = pentry
    # device-loss mesh gate (fleet fault tolerance): the one scenario
    # that actually loses and regains devices is replayed through the
    # mesh backend, where the events BITE (topology epoch bump ->
    # reshard onto survivors -> shrunk-mesh solves -> re-promotion);
    # its digest must equal the committed host golden bit-for-bit --
    # the whole degrade ladder is decision-invisible, asserted the way
    # sharded == unsharded is for the healthy mesh
    loss = [p for p in traces
            if os.path.splitext(os.path.basename(p))[0] == "mesh-device-loss"]
    if loss and rc == 0:
        from karpenter_tpu_torch.sim.replay import InvariantViolation, replay

        events = read_trace(loss[0])
        seed = _trace_seed(events, None)
        want = (new_digests.get("mesh-device-loss")
                or golden.get("mesh-device-loss"))
        try:
            lres = replay(events, backend="mesh", seed=seed, device=args.device)
            lentry = {"ok": lres.digest == want, "digest": lres.digest}
            if not lentry["ok"]:
                rc = 1
                lentry["golden_digest"] = want
                lentry["note"] = ("device-loss mesh digest diverged from "
                                  "golden: the degrade ladder changed a "
                                  "decision")
        except InvariantViolation as e:
            rc = 1
            lentry = {"ok": False,
                      "note": f"device-loss mesh invariant violation: {e}"}
        report["mesh:mesh-device-loss"] = lentry
    # convex-tier gate (solver/convex): the adversarial bin-packing
    # scenario is re-replayed with the convex global-solve tier forced
    # on. Unlike the bit-identical legs above, convex is ALLOWED to
    # change decisions -- the gate asserts DOMINANCE instead: fleet
    # $/pod-hour strictly below the host replay's, final optimality gap
    # no worse, and byte-determinism via its own digest pinned under
    # "convex:binpack-adversarial-convex" in digests.json
    adv = [p for p in traces
           if os.path.splitext(os.path.basename(p))[0]
           == "binpack-adversarial-convex"]
    if adv and rc == 0:
        from karpenter_tpu_torch.sim.replay import InvariantViolation, replay

        events = read_trace(adv[0])
        seed = _trace_seed(events, None)
        hk = host_kpis_by_name.get("binpack-adversarial-convex", {})
        key = "convex:binpack-adversarial-convex"
        try:
            cres = replay(events, backend="convex", seed=seed, device=args.device)
            centry = {
                "digest": cres.digest,
                "cost_per_pod_hour": cres.kpis.get("cost_per_pod_hour"),
                "host_cost_per_pod_hour": hk.get("cost_per_pod_hour"),
                "optimality_gap_final": cres.kpis.get("optimality_gap_final"),
                "host_optimality_gap_final": hk.get("optimality_gap_final"),
            }
            wins = (
                cres.kpis.get("cost_per_pod_hour", float("inf"))
                < hk.get("cost_per_pod_hour", 0.0)
                and cres.kpis.get("optimality_gap_final", float("inf"))
                <= hk.get("optimality_gap_final", 0.0)
            )
            centry["ok"] = wins
            if not wins:
                rc = 1
                centry["note"] = ("convex tier failed to dominate the host "
                                  "replay on the adversarial corpus")
            new_digests[key] = cres.digest
            if wins and golden.get(key) not in (None, cres.digest):
                rc = 1
                centry["ok"] = False
                centry["golden_digest"] = golden.get(key)
                centry["note"] = "convex decision digest drifted from golden"
        except InvariantViolation as e:
            rc = 1
            centry = {"ok": False,
                      "note": f"convex-tier invariant violation: {e}"}
        report[key] = centry
    if quality_violations:
        # the regression diff is a ready-made artifact: the sim-corpus CI
        # job uploads args.artifacts on failure, so the observed-vs-bound
        # table arrives alongside any shrunk repro
        rc = 1
        os.makedirs(args.artifacts, exist_ok=True)
        diff_path = os.path.join(args.artifacts, "quality-regression.json")
        with open(diff_path, "w") as f:
            json.dump(quality_violations, f, indent=2, sort_keys=True)
            f.write("\n")
        report["quality_regression"] = {
            "violations": quality_violations, "diff": diff_path,
            "note": "optimality gap exceeded the pinned bound "
                    "(tests/golden/scenarios/quality.json)",
        }
    print(json.dumps({"corpus": report, "ok": rc == 0}, sort_keys=True))
    return rc


def _cmd_fleet(args) -> int:
    """N tenants through one shared coalescing sidecar (sim/fleet.py):
    per-tenant digests must equal their isolated replays AND the goldens
    pinned in multi-cluster-storm.digests.json. The fleet gate. The
    pinned file is read, never written: it belongs to the JAX package."""
    from karpenter_tpu_torch.sim.fleet import replay_fleet
    from karpenter_tpu_torch.sim.scenario import DEFAULT_SEED

    seed = args.seed if args.seed is not None else DEFAULT_SEED
    res = replay_fleet(args.tenants, base_seed=seed, mesh=args.mesh, device=args.device)
    digest_path = os.path.join(args.dir, "multi-cluster-storm.digests.json")
    golden = {}
    if os.path.exists(digest_path):
        with open(digest_path) as f:
            golden = json.load(f)
    rc = 0 if res.ok else 1
    report = {
        "tenants": args.tenants, "seed": seed, "mesh": bool(args.mesh),
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

    cor = sub.add_parser(
        "corpus",
        help="replay every committed scenario differentially and against "
        "the pinned digests and quality bounds (read, never written: no "
        "--update-digests, no --update-quality -- the goldens belong to "
        "the JAX package)",
    )
    cor.add_argument("--dir", default="tests/golden/scenarios")
    cor.add_argument("--artifacts", default="sim-artifacts",
                     help="where shrunk repros and the quality diff land")
    cor.add_argument("--device", choices=("cuda", "cpu"), default=None,
                     help=device_help)
    cor.set_defaults(fn=_cmd_corpus)

    flt = sub.add_parser(
        "fleet",
        help="multi-tenant replay: N engines sharing one coalescing "
        "sidecar, per-tenant golden digests (multi-tenant == isolated); "
        "no --update-digests (the pinned file belongs to the JAX package)",
    )
    flt.add_argument("--tenants", type=int, default=3)
    flt.add_argument("--mesh", action="store_true",
                     help="shard the shared sidecar's solves over 8 shards of the device")
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
