#!/usr/bin/env python3
"""What the port's tracing costs when it is on, and where a tick's time
outside every span sits, on one NVIDIA GPU.

    python3 hack/torch_trace_cost.py [--workload np1-50k.wave] [--seed 7] [--calls 100]
                                     (repository root; one card)

Sets a cell of BENCHMARK.json up as benchmark/run.py does (its inputs from
--seed, the solver, the warm-up ladder, one warm call per input, the
collector's latency policy), then makes 2 x --calls calls in one process,
with karpenter_tpu_torch.tracing.TRACER enabled and disabled in turns (off,
on, on, off, ...), each call under `tracing.trace("tick")` and ending in
a sync. Then the same again under a live CPU-only torch.profiler capture,
so that every span also opens its `karpenter::` profiler range. Prints one
JSON line a phase (`plain`, `profiled`): the mean and median call ms of
each mode, and on - off in ms and as a share of the off mean. A call's
host time swings by more than tracing costs, so the `span` line times one
span's start and finish alone (`--spans` of them under one root, tracing
off, on, and on under a live capture): µs a span. The last line holds,
over the traced calls of the plain phase, the spans a call opens, each
span name's mean total ms a call, the root's time outside its child
spans by where it sits (`before <span>`, `after the last span`), the
dispatches the spans recorded (`entry:impl` -> count), what the
feasibility spans recorded (`feas_node_rows`, `feas_pairs` -> count), the
card's `nvidia-smi` name and power limit, and the three phases again.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "benchmark"))
sys.path.insert(0, str(ROOT))

import harness  # noqa: E402
from gen import traffic  # noqa: E402


def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def alternate(driver, tracing, n: int, sync) -> dict:
    """2n calls, tracing off and on in turns (off, on, on, off, ...)."""
    walls = {"off": [], "on": []}
    roots = []
    for i in range(2 * n):
        on = i % 4 in (1, 2)
        tracing.TRACER.configure(enabled=on, sample=1.0)
        fn = driver.call(i)
        a = time.perf_counter()
        with tracing.trace("tick") as root:
            fn()
        sync()
        walls["on" if on else "off"].append(time.perf_counter() - a)
        if on:
            roots.append(root)
    tracing.TRACER.configure(enabled=False)
    off, on = statistics.fmean(walls["off"]), statistics.fmean(walls["on"])
    doc = {"calls_each": n}
    for mode, w in walls.items():
        doc[f"{mode}_mean_ms"] = 1e3 * statistics.fmean(w)
        doc[f"{mode}_median_ms"] = 1e3 * statistics.median(w)
    doc["cost_ms"] = 1e3 * (on - off)
    doc["cost_pct"] = 100.0 * (on - off) / off
    return doc, roots


def span_us(tracing, n: int) -> dict:
    """µs one span's start and finish take, tracing off and on."""
    out = {}
    for mode in ("off", "on"):
        tracing.TRACER.configure(enabled=mode == "on", sample=1.0)
        with tracing.trace("tick"):
            a = time.perf_counter()
            for _ in range(n):
                with tracing.span("x"):
                    pass
            out[mode] = 1e6 * (time.perf_counter() - a) / n
    tracing.TRACER.configure(enabled=False)
    return out


def where(roots) -> dict:
    """Each span name's mean total ms a call, the root's own time by
    where it sits among its children, and the recorded dispatches."""
    total, gaps, dispatch, feasibility = {}, {}, {}, {}
    opened = 0
    for r in roots:
        stack = list(r.children)
        while stack:
            sp = stack.pop()
            stack.extend(sp.children)
            opened += 1
            total[sp.name] = total.get(sp.name, 0.0) + (sp.end - sp.start)
            for entry, impl in (sp.attributes.get("dispatch") or {}).items():
                key = f"{entry}:{impl}"
                dispatch[key] = dispatch.get(key, 0) + 1
            if "feas_node_rows" in sp.attributes:
                a = sp.attributes
                key = (f"{sp.name}: {a.get('classes')} classes x {a.get('nodes')} nodes -> "
                       f"{a['feas_node_rows']} node rows, {a['feas_pairs']} pairs")
                feasibility[key] = feasibility.get(key, 0) + 1
        prev = r.start
        for ch in sorted(r.children, key=lambda s: s.start):
            key = f"before {ch.name}"
            gaps[key] = gaps.get(key, 0.0) + (ch.start - prev)
            prev = ch.end
        gaps["after the last span"] = gaps.get("after the last span", 0.0) + (r.end - prev)
    n = len(roots)
    walls = [r.end - r.start for r in roots]
    return {
        "traced_calls": n,
        "traced_mean_ms": 1e3 * statistics.fmean(walls),
        "spans_a_call": opened / n,
        "span_total_ms": {k: 1e3 * v / n for k, v in sorted(total.items(), key=lambda kv: -kv[1])},
        "outside_spans_ms": {k: 1e3 * v / n for k, v in sorted(gaps.items(), key=lambda kv: -kv[1])},
        "dispatches": dispatch,
        "feasibility": feasibility,
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", default="np1-50k.wave")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--calls", type=int, default=100)
    ap.add_argument("--spans", type=int, default=100_000)
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    harness.program.load(harness.cache_dirs())
    from karpenter_tpu_torch import tracing

    _, config, mix = harness.cell_files(harness.manifest(), args.workload)
    driver = harness.DRIVERS[mix["kind"]](traffic.build(mix, config, args.seed), config, "cuda")
    driver.warm()
    harness.program.latency_gc()
    out = {"workload": args.workload, "seed": args.seed, "card": card()}
    plain, roots = alternate(driver, tracing, args.calls, torch.cuda.synchronize)
    print(json.dumps({"phase": "plain", **plain}), flush=True)
    with profile(activities=[ProfilerActivity.CPU]):
        profiled, _ = alternate(driver, tracing, args.calls, torch.cuda.synchronize)
    print(json.dumps({"phase": "profiled", **profiled}), flush=True)
    span = span_us(tracing, args.spans)
    with profile(activities=[ProfilerActivity.CPU]):
        span["on_profiled"] = span_us(tracing, args.spans)["on"]
    print(json.dumps({"phase": "span", **span}), flush=True)
    driver.close()
    out.update(plain=plain, profiled=profiled, span_us=span, **where(roots))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
