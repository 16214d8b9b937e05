#!/usr/bin/env python3
"""Drive the port's provisioning solve, its convex tier, the consolidation engine and the operator (in memory and over an apiserver) on one GPU.

    python3 chip_smoke.py          (from the repository root; needs one card)
    python3 chip_smoke.py --rehearse-kube [N_PODS]
                                   (phase `kube` and its reference alone,
                                   on the CPU, small)
    python3 chip_smoke.py --coldstart empty|warm OUT N_PODS G_MAX DEVICE
                                   (one process of phase `coldstart`; set
                                   $KARPENTER_TPU_COMPILE_CACHE first)
    python3 chip_smoke.py --witness OUT N_PODS N_WAVE G_MAX DEVICE
                                   (the process of phase `witness`; runs
                                   on the CPU too with DEVICE cpu)

Runs the karpenter_tpu_torch main path at full width -- the 627-type
generated catalog, 50,000 pending pods from 160 templates, one NodePool,
g_max 1024, the price objective -- through the entry points a user calls.
`TorchSolver.solve` takes two ticks: tick 1 on an empty cluster
(kernel A), tick 2 with a second wave of 10,000 pods packed first onto the
nodes of tick 1 (kernel B, one candidate set) and then opened for the rest
(kernel A). `TorchSolver.schedule`, the routing entry point, takes five
worlds: `suffix` (49,500 of those pods plus 500 with required hostname
pod affinity: the oracle suffix), `spread` (16 templates with zone
spread, two ticks, the second seeded with the first's pods: the split
pass, kernel B on zone-pinned rows), `merged` (the 50k pods under
weighted spot and on-demand NodePools: 1,254 joint columns), `merged 3
pools` (the same pods under spot, on-demand and default: K=1920, kernel A
in its scratch layout) and `pipelined` (schedule_begin/schedule_finish on
tick 1). `DisruptEngine(solver=...).evaluate`, the consolidation entry
point, takes four sweeps of 301 candidate sets each (256 singletons,
prefixes 2..32, 14 pairs): `bench-sweep` (bench.py's consolidation stage:
1,024 nodes, one pool), `rampdown-sweep` over tick 1's nodes after 75 % of
their pods left, once under one default pool and once under weighted spot
/ on-demand pools with daemonset overhead, and `steady-sweep` (the same
cluster before any pod left, so the replacement search decides some sets,
under the spot / on-demand pools). Every device solve also enqueues the
fractional price bound and publishes `last_quality`. `TorchSolver(tier=
"convex")` takes three worlds: tick 1 (50k pods), bench.py's convex stage
at 2,000 pods, and tests/test_convex.py's 30-pod adversarial mix. Phases,
one JSON line each:

  device      the card, its count and `nvidia-smi` name and power limit
  build       nvcc for sm_90a, one process per source, with ptxas -v lines;
              then karpenter_tpu_torch.native.grouping must have built
              (the C grouping loop: cc and Python.h on this machine)
  analysis    `python -m karpenter_tpu_torch.analysis` on the host, over
              the tree that runs: exit 0 against its baseline
  main        the two ticks with every launch count set to 0 before a tick
              and read after it; every pod must be placed exactly once
  schedule    the five worlds, counted the same way, each with its route,
              C and K of kernel A, the layout it chose, and its
              unschedulable pods; each must take its route and account for
              every pod once
  quality     the quality document of both ticks and each world (gap >= 1),
              the bound's [R] totals against the same function on a CPU
              copy of its inputs (rel 1e-6), the bound's dispatch + fetch
              (median of 30) and its share of the warm tick (the JAX
              bench's budget, < 1 %, printed, not asserted)
  convex      the three convex worlds, counted the same way: every pod
              once, the chosen price never above FFD's, iterations in
              1..48, the winner each must have, decisions and
              `last_convex` equal to a device="cpu" solver's, x and the
              lower bound within 5e-5 of the relaxation on a CPU copy;
              times: convex tick against FFD tick, the relaxation's
              enqueue and device time, its fetch, rounding and `choose`
  consolidate the four sweeps, counted the same way: kernel B once per
              sweep at S=512, N=1024, the replacement passes, and the
              verdicts by action (delete / replace-cheaper / blocked,
              against the candidates' own prices); every verdict must be
              well formed
  observe     the no-fallback witness over every phase above (no convex
              fallback but rounding's organic None, no quality-bound error,
              the solver's kernel-dispatch counter, with the consolidation
              engine's local dispatches for kernel B, equal to every
              counted run's launches, no plain run outside the convex
              phase's CPU copy); drills on worlds (a) and (c):
              `convex.rounding` and `rpc.convex.dispatch` armed to raise
              once, and a quality bound that raises, each tick the FFD
              tick, its counter and the failpoint's fires moved by one,
              the next tick as before;
              `hbm.poll()` against `torch.cuda`'s figures after tick 1;
              warm tick 1 with tracing and the observatory on against off
              (median of 5 each, in turns; printed, not gated) and one
              flight record per traced tick with its stages; a
              `torch.profiler` capture of two warm ticks naming kernel A,
              then three warm ticks with it stopped; the sync witness's
              sanctioned fetches and unsanctioned sites over warm ticks 1
              and 2 and a sweep, which must book no unsanctioned site
  wire        the solver sidecar: `python -m karpenter_tpu_torch.
              solver.rpc` started as a subprocess answers ping, then tick 1
              and tick 2 through the port's SolverClient, equal to the
              in-process ticks (bytes each way per tick, staged bytes, the
              transport); a server thread in this script, over the shm
              ring and over the socket: tick 1, tick 1 with 5 % of its pods
              replaced (shipped as solve_delta), tick 2, the merged world
              and a tainted merged world (the join_allowed feature check),
              convex world (a), the spot / on-demand ramp-down sweep
              through solve_disrupt -- each counted, each equal to the
              in-process result (decisions, last_route, last_convex,
              verdict reprs); ping round trips, wire against in-process
              walls, the server's echoed device and fetch stages; no
              breaker transition in the clean runs; then the breaker
              drill: the subprocess killed, two ticks behind the failed
              ladder (the second opens the breaker), one breaker-open
              tick, each in process on the card and counted once; the
              sidecar restarted, the probe promotes and the next tick
              rides the wire
  operator    the system's own entry points: `python -m karpenter_tpu_torch
              --max-ticks 5 --tick-interval 0.1 --seed 1 --health-port P
              --metrics-dump` as a subprocess (exit 0, its CUDA probe names
              the card, /readyz 200 after the first sweep), and the same
              command without a card (CUDA_VISIBLE_DEVICES="": exit
              non-zero, no tick); the full-width `Operator` world --
              TorchSolver(g_max=1024) and ConsolidationEvaluator on the
              kwok catalog, 50,000 pods, a 10,000-pod wave, then 75 % of
              the pods deleted and up to 6 ramp-down ticks -- with tick
              walls, the dispatch counter's launches
              per tick, nodes launched and disrupted and the flight record's
              operator fields; every golden corpus digest through the port's
              own replay on the card (the 8 host ones, the convex one, and
              the two tier-1 scenarios over the port's sidecar), with each
              replay's wall and launches
  kube        the operator over the apiserver bus, tests/fake_apiserver.py
              started in process: `python -m karpenter_tpu_torch
              --kubeconfig K --max-ticks 16` as a subprocess against a
              server that holds the default NodeClass and NodePool and 200
              pods (exit 0, /readyz 200, every pod bound, no NodePool
              written, kernel A in its dumped dispatch counter, the time
              from start to ready), `--in-cluster` without the service
              account's env (exit non-zero before any tick); the world --
              the port's Operator over KubeCluster, TorchSolver(g_max=1024)
              and ConsolidationEvaluator, a FakeClock, 800 pods from the
              160 templates, a 200-pod wave onto the live nodes, 75 % of
              the pods deleted, 2 ramp-down ticks -- with tick walls, HTTP
              requests per tick, kernel launches (A and B both) and the
              device's idle share in a torch.profiler capture of the
              binding tick
  times       each kernel and its plain version at every main-path shape
              (kernel A at tick 1, tick 2 and in each world; kernel B at
              tick 2, the spread wave and each sweep; kernel A also on
              the convex worlds), kernel A over G in
              {64, 256, 1024} on tick 1's operands, on the C=256 world and
              under the fit objective, each with its bound and, at G=1024,
              the surviving types of its groups; the scratch layout against
              the lean one at K=1280; kernel times are CUDA events around
              10 back-to-back calls; tick walls and their stages per tick
              and world, peak device memory; per sweep its wall (median of
              warm sweeps) with host stages, each replacement pass in CUDA
              events, and on bench-sweep the candidate nodes judged per
              second; the grouping stage (`encode.group_pods`) on each
              world's pods with the native C loop and with the pure-Python
              loop, in turns, median of 3 each: both must give the same
              classes in the same order with the same pods
  witness     a second process that installs the port's three runtime
              witnesses (lock order, exception escape, torch: rebuilds,
              captures and host syncs) before it imports the port, then
              runs ticks 1 and 2 cold and warm (warm inside
              torch_witness.hot()), `enable_aot(duty=0.05)` with at least
              20 live ticks of tick 1 inside hot() while the ladder's thread
              captures, a SolverServer thread with a cold and a warm wire
              tick, and the `convex.rounding=error(RuntimeError):times=1`
              drill; fails on any inversion, unsanctioned swallow or hot
              violation; prints the counts, the witnessed lock sites, the
              sanctioned fetches and the ticks' walls beside phase `times`'
              unwitnessed tick 1
  kernels     each kernel against its plain torch version on the card, on
              the main path's own inputs (tick 1's scan; tick 2's scan,
              whose C=128 holds 63 padded rows; tick 2's repack; the
              schedule worlds' scans, K=1920 among them, and the spread
              wave's repack; each sweep's repack) and on pinned edge cases:
              tied prices, exact quotients, slot exhaustion, padded or
              infeasible rows between real classes, a count-0 class that
              open groups could join, all-zero-request classes whose int32
              prefix sums wrap, a C=256 world, kernel B at 64 candidate
              sets, and the layouts each kernel takes when shared memory is
              short, run at shapes the others fit too; the sidecar's own
              calls in phase `wire`; the operator's calls in phases
              `operator` and `kube`; the warm-up ladder's armed CUDA graphs
              (solver/aot.py) against the ordinary dispatch byte for byte at
              every tier-0 bucket (the fused buffer and the bound's totals
              on real class rows, C = 16 .. 1024) and at the tier-3
              pre-pass floor shape, a tick through them, and two rung
              drills: a replay rejected by the `aot.dispatch` failpoint
              (disarmed, counted once, kernel A launched instead, the same
              decisions) and a corrupt library in a store (counted once,
              rebuilt, kernel B exact); equality is exact
  plain       the same ticks, worlds and sweeps with both kernels swapped
              for their plain versions: the decisions must be identical
  coldstart   tick 1 of the main path in two fresh processes over one
              temporary $KARPENTER_TPU_COMPILE_CACHE: (a) the store empty --
              each library's nvcc seconds, then the cold tick 1 broken down
              into the CUDA context (torch.cuda.init and the first
              allocation), library loads, catalog staging, each device
              entry's first dispatch (obs/jitstats) and the wall; (b) the
              store warm, `enable_aot()` and its ladder drained before tick 1:
              no store miss and no nvcc run, `karpenter_aot_dispatches_total
              {entry="ffd_solve_fused"}` >= 1 on tick 1, coverage 1.0 for
              every tier-0 entry, tick 1's decisions equal to (a)'s, its wall.
              Printed, not claimed
  references  the operator world and the kube world with device="cpu",
              each in a second process, both started once phase `times`,
              the last timed section, has ended (phases `kernels` and
              `plain`, which print no time, run beside them): each card
              world equal to its reference tick by tick (the NodeClaims
              and pod bindings)

Every phase line carries `script_s`, the seconds from the script's start
to the phase's end. Then the nvidia-smi line, the kernels line and, last,
the result line.
Any failed phase raises: the script exits non-zero and prints no result.
JAX and the JAX package are not imported.
"""
from __future__ import annotations

import collections
import contextlib
import copy
import dataclasses
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

SEED = 20_260_101
N_PODS = 50_000
N_WAVE = 10_000
N_AFF = 500                    # the suffix world's affinity pods
N_SPREAD = 16                  # the spread world's zone-spread templates
G_MAX = 1024
DEVICE = "cuda"
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory rate
FP32_OPS_PER_S = 67e12         # H100 SXM float32 peak outside the tensor cores


T_START = time.perf_counter()


def emit(doc: dict) -> None:
    if "phase" in doc:
        # when the phase ended, in seconds from the script's start
        doc = {**doc, "script_s": time.perf_counter() - T_START}
    print(json.dumps(doc), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    if not out:
        raise RuntimeError("nvidia-smi printed nothing")
    return out[0]


def cuda_ms(fn, reps: int, warmup: int = 2, batch: int = 10) -> float:
    """Median over `reps` of the mean milliseconds of `batch` back-to-back
    calls between two CUDA events: the card stays busy, so the host's
    enqueue of each call hides behind the kernels (a single call between
    two events on an idle card also times the host's enqueue)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(batch):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / batch)
    return statistics.median(times)


def wall_runs(fn, reps: int) -> list:
    """Host milliseconds of each of `reps` calls of fn(), each ending in a sync."""
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return times


def wall_ms(fn, reps: int):
    """(first, median) host milliseconds of fn(), each ending in a sync."""
    times = wall_runs(fn, reps)
    return times[0], statistics.median(times)


def max_abs_diff(got, want) -> float:
    return max(
        float((a.to(torch.int64) - b.to(torch.int64)).abs().max()) if a.numel() else 0.0
        for a, b in zip(got, want)
    )


def nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


# SOLVER_KERNEL_DISPATCHES entry of each kernel's call on the main path
DISPATCH_ENTRIES = {"ffd_scan": "ffd_solve_fused", "disrupt_repack": "disrupt_repack"}
QUALITY_SITES = ("solver.quality_dispatch", "solver.quality_finish")


def dispatch_counts(metrics) -> dict:
    """karpenter_solver_kernel_dispatches_total by "kernel/impl" (the
    solver's own launches), and as "disrupt_repack/engine" the
    consolidation engine's kernel B runs: karpenter_disruption_device_
    dispatches_total{path="local"}, one per local evaluate."""
    out = {f"{k}/{impl}": metrics.SOLVER_KERNEL_DISPATCHES.value(entry=entry, impl=impl)
           for k, entry in DISPATCH_ENTRIES.items() for impl in ("cuda", "plain")}
    out["disrupt_repack/engine"] = metrics.DISRUPTION_DEVICE_DISPATCHES.value(path="local")
    return out


def bound(bytes_moved: float, ops: float):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


@contextlib.contextmanager
def recording(ka, kb):
    """The operands each kernel wrapper is called with inside the block,
    per kernel; the calls go on to the wrappers unchanged."""
    rec = {"ffd_scan": [], "disrupt_repack": []}
    scan, repack = ka.fused_scan, kb.disrupt_repack

    def scan_rec(*ops, **kw):
        rec["ffd_scan"].append(ops)
        return scan(*ops, **kw)

    def repack_rec(*ops):
        rec["disrupt_repack"].append(ops)
        return repack(*ops)

    ka.fused_scan, kb.disrupt_repack = scan_rec, repack_rec
    try:
        yield rec
    finally:
        ka.fused_scan, kb.disrupt_repack = scan, repack


@contextlib.contextmanager
def calls_of(mod, name):
    """Every call of the module function `mod.name` inside the block, as
    (args, kwargs, result); the calls go on to the function unchanged."""
    rec = []
    fn = getattr(mod, name)

    def call(*a, **k):
        out = fn(*a, **k)
        rec.append((a, k, out))
        return out

    setattr(mod, name, call)
    try:
        yield rec
    finally:
        setattr(mod, name, fn)


@contextlib.contextmanager
def fn_timer(targets):
    """Host-clock milliseconds in each callable of `targets` ((owner,
    name, label) triples: a module's function or an object's method) over
    the calls inside the block (a nested call counts in its caller too)."""
    times = {}
    saved = [(owner, name, name in vars(owner), getattr(owner, name))
             for owner, name, _ in targets]

    def timed(label, fn):
        def call(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                times[label] = times.get(label, 0.0) + (time.perf_counter() - t0) * 1e3
        return call

    for owner, name, label in targets:
        setattr(owner, name, timed(label, getattr(owner, name)))
    try:
        yield times
    finally:
        for owner, name, own, fn in reversed(saved):
            if own:
                setattr(owner, name, fn)
            else:
                delattr(owner, name)


def graph_device_ms(fn, reps: int) -> dict:
    """Median CUDA-event milliseconds of one replay of fn's device work
    captured in a CUDA graph: the device time of its many small ops
    without the host's enqueue between them (a work of ~3,000 launches
    fills the launch queue, so holding the stream while the host
    enqueues cannot separate the two). A capture the runtime refuses
    leaves the number unmeasured, with the reason."""
    try:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            fn()
    except RuntimeError as e:
        torch.cuda.synchronize()
        return {"ms": None, "not_measured": f"{type(e).__name__}: {e}"[:300]}
    return {"ms": cuda_ms(graph.replay, reps=reps, batch=1)}


def device_busy_ms(fn, reps: int = 3):
    """(median wall ms, median device-busy ms) of fn() ending in a sync,
    the busy time being the sum of the CUDA kernels and copies
    torch.profiler records; busy None when the profiler records no
    device time."""
    from torch.profiler import ProfilerActivity, profile

    walls, busy = [], []
    for _ in range(reps):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        us = sum(getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)
                 for e in prof.key_averages() if "CUDA" in str(e.device_type))
        busy.append(us / 1e3)
    med = statistics.median(busy)
    return statistics.median(walls), (med if med > 0 else None)


# the host stages of a tick (TorchSolver methods and ffd functions), in
# the order a tick runs them; `fetch` waits for the device, and
# `solve_finish` holds `fetch` and `decode`
SOLVER_STAGES = ("_group", "supports", "_merged_catalog", "_split_spread", "_pack_existing",
                 "_encode", "solve_finish", "_decode", "_oracle_suffix")
FFD_STAGES = ("ffd_solve_fused", "fetch_fused")


def stage_timer(solver, ffd_mod):
    """Host-clock milliseconds spent in each stage of SOLVER_STAGES and
    FFD_STAGES over the calls inside the block (a nested stage counts in
    its parent too)."""
    return fn_timer([(solver, name, name.lstrip("_")) for name in SOLVER_STAGES]
                    + [(ffd_mod, name, name) for name in FFD_STAGES])


# the host stages of a sweep: DisruptEngine methods in the order a sweep
# runs them (`assemble` holds the replacement passes)
ENGINE_STAGES = {"_encode_sets": "encode_sets", "_pool_contexts": "pool_contexts",
                 "_dispatch_local": "repack", "_assemble": "assemble"}


def sweep_stage_timer(engine, functions):
    """Host-clock milliseconds in each stage of ENGINE_STAGES and in each
    module function of `functions` ((module, name, label) triples) over
    the calls inside the block (a nested stage counts in its parent too)."""
    return fn_timer([(engine, name, label) for name, label in ENGINE_STAGES.items()]
                    + list(functions))


# phase `operator`: the ramp-down after 75 % of the pods leave is ticked
# until the disruption controller goes quiet, at most this many ticks (it
# retires about one node a tick; the depth of the world is cut, never its
# width)
OPERATOR_RAMP_TICKS = 6
OPERATOR_SETTLE_TICKS = 12
OPERATOR_STEP_S = 3.0


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_binary(repo: str, extra_env: dict, args=(), drop_env=()) -> dict:
    """`python -m karpenter_tpu_torch --max-ticks 5 ...` as a subprocess
    (`args` come last, so they override those flags), polling its /readyz
    until it exits: exit code, seconds to the first 200, the tail of both
    streams. `drop_env` names variables the child does not inherit."""
    import urllib.error
    import urllib.request

    port = free_port()
    cmd = [sys.executable, "-m", "karpenter_tpu_torch", "--max-ticks", "5",
           "--tick-interval", "0.1", "--seed", "1", "--health-port", str(port),
           "--metrics-dump", *args]
    with tempfile.TemporaryDirectory(prefix="karpenter-binary-") as tmp:
        out_path, err_path = os.path.join(tmp, "out"), os.path.join(tmp, "err")
        with open(out_path, "wb") as out, open(err_path, "wb") as err:
            t0 = time.perf_counter()
            env = {k: v for k, v in os.environ.items() if k not in drop_env}
            proc = subprocess.Popen(cmd, cwd=repo, stdout=out, stderr=err,
                                    env=dict(env, **extra_env))
            ready_s, statuses = None, set()
            try:
                while proc.poll() is None:
                    if time.perf_counter() - t0 > 300:
                        raise AssertionError(f"the binary ran past 300 s: {cmd}")
                    try:
                        with urllib.request.urlopen(f"http://127.0.0.1:{port}/readyz",
                                                    timeout=1) as resp:
                            statuses.add(resp.status)
                            if resp.status == 200 and ready_s is None:
                                ready_s = time.perf_counter() - t0
                    except urllib.error.HTTPError as e:
                        statuses.add(e.code)
                    except OSError:
                        pass
                    time.sleep(0.02)
            finally:
                if proc.poll() is None:
                    proc.kill()
                proc.wait(timeout=60)
            wall_s = time.perf_counter() - t0
        with open(out_path) as f:
            stdout = f.read()
        with open(err_path) as f:
            stderr = f.read()
    return {"cmd": " ".join(cmd[1:]), "rc": proc.returncode, "wall_s": wall_s,
            "start_to_ready_s": ready_s, "readyz_statuses": sorted(statuses),
            "stdout": stdout, "stderr": stderr}


def operator_world(device) -> dict:
    """Phase `operator`'s full-width world: the port's Operator
    (TorchSolver(g_max=G_MAX) and its consolidation engine on `device`)
    on the in-memory kwok cluster, N_PODS pending pods, an N_WAVE-pod wave,
    then 75 % of the pods deleted and the ramp-down; per tick its wall,
    dispatches, flight record and a digest of its decisions."""
    import hashlib

    from karpenter_tpu_torch import metrics, seeding, workload
    from karpenter_tpu_torch.apis import Node, NodeClaim, NodePool, Pod, TPUNodeClass
    from karpenter_tpu_torch.apis import labels as wk
    from karpenter_tpu_torch.cache.ttl import FakeClock
    from karpenter_tpu_torch.controllers.disruption import MIN_NODE_LIFETIME
    from karpenter_tpu_torch.obs import flight
    from karpenter_tpu_torch.operator import Operator, Options
    from karpenter_tpu_torch.solver.consolidate import ConsolidationEvaluator
    from karpenter_tpu_torch.solver.service import TorchSolver

    saved = seeding.snapshot()
    solver = TorchSolver(g_max=G_MAX, device=device)
    op = Operator(
        clock=FakeClock(100_000.0), solver=solver,
        consolidation_evaluator=ConsolidationEvaluator(solver=solver),
        # a deadline no tick comes near: the brownout ladder observes
        # every tick (rung 0 in the flight record) and nothing sheds
        options=Options(seed=SEED, tracing=False, tick_deadline=3600.0),
    )
    op.cluster.create(TPUNodeClass("default"))
    op.cluster.create(NodePool("default"))
    ticks = []
    prev_nodes = set()
    on_card = torch.device(device).type == "cuda"

    def tick(stage):
        nonlocal prev_nodes
        before = dispatch_counts(metrics)
        # the first tick of the wave and of the ramp-down on the card
        # runs under torch.profiler: the device's busy time in the tick
        profiled = on_card and stage != "50k" and not any(t["stage"] == stage for t in ticks)
        busy = None
        t0 = time.perf_counter()
        if profiled:
            from torch.profiler import ProfilerActivity, profile

            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                op.tick()
                torch.cuda.synchronize()
            busy = sum(getattr(e, "self_device_time_total", None)
                       or getattr(e, "self_cuda_time_total", 0)
                       for e in prof.key_averages() if "CUDA" in str(e.device_type)) / 1e3
        else:
            op.tick()
            if on_card:
                torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        after = dispatch_counts(metrics)
        claims = sorted(
            (c.metadata.name, c.metadata.labels.get(wk.NODEPOOL_LABEL, ""),
             c.metadata.labels.get(wk.INSTANCE_TYPE_LABEL, ""),
             c.metadata.labels.get(wk.ZONE_LABEL, ""),
             c.metadata.labels.get(wk.CAPACITY_TYPE_LABEL, ""), c.deleting)
            for c in op.cluster.list(NodeClaim))
        bindings = sorted((p.metadata.name, p.node_name or "") for p in op.cluster.list(Pod))
        nodes_now = {n.metadata.name for n in op.cluster.list(Node)}
        rec = flight.RECORDER.last() or {}
        ticks.append({
            "stage": stage, "wall_ms": wall, "profiled": profiled,
            "device_busy_ms": busy,
            "device_idle_share": None if busy is None else 1.0 - busy / wall,
            "digest": hashlib.sha256(json.dumps([claims, bindings]).encode()).hexdigest(),
            "claims": len(claims), "bound": sum(1 for _, n in bindings if n),
            "pending": len(op.cluster.pending_pods()),
            "nodes_launched": len(nodes_now - prev_nodes),
            "nodes_disrupted": len(prev_nodes - nodes_now),
            "dispatches": {k: after[k] - before[k] for k in after if after[k] != before[k]},
            "flight": {k: rec.get(k) for k in (
                "brownout_level", "breaker", "deferred_pods", "shed_total", "nodes_ready",
                "pods_bound_total", "consolidation_ms", "consolidation_mode",
                "consolidation_sets")},
        })
        prev_nodes = nodes_now
        op.clock.step(OPERATOR_STEP_S)

    def settle(stage):
        for _ in range(OPERATOR_SETTLE_TICKS):
            tick(stage)
            if not op.cluster.pending_pods() and op.provisioner._inflight is None:
                return
        raise AssertionError(f"operator world ({device}): {stage} did not settle in "
                             f"{OPERATOR_SETTLE_TICKS} ticks")

    t_world = time.perf_counter()
    try:
        for p in workload.synth_pods(np.random.default_rng(SEED), workload.ZONES, N_PODS,
                                     salt=1):
            op.cluster.create(p)
        settle("50k")
        for p in workload.synth_pods(np.random.default_rng(SEED + 1), workload.ZONES,
                                     N_WAVE, salt=2):
            op.cluster.create(p)
        settle("10k wave")
        names = sorted(p.metadata.name for p in op.cluster.list(Pod))
        for i, name in enumerate(names):
            if i % 4:
                op.cluster.delete(Pod, name)
        op.clock.step(MIN_NODE_LIFETIME + 60)
        quiet = False
        for _ in range(OPERATOR_RAMP_TICKS):
            decided = metrics.DISRUPTION_DECISIONS._values.copy()
            tick("ramp-down")
            moved = metrics.DISRUPTION_DECISIONS._values != decided
            if (not moved and not op.cluster.pending_pods()
                    and not any(c.deleting for c in op.cluster.list(NodeClaim))):
                quiet = True
                break
    finally:
        seeding.restore(saved)
    return {"ticks": ticks, "seconds": time.perf_counter() - t_world, "quiet": quiet}


def phase_operator(dev, tag: dict, metrics, ka, kb):
    """The binary, the full-width operator world on the card and the golden
    corpus through the port's own replay; returns the kernel launches each
    counted run made, the operator path's kernel operands and the card
    world's per-tick digests (phase `references` holds them against the
    same world with device="cpu")."""
    from karpenter_tpu_torch import overload
    from karpenter_tpu_torch.sim.replay import replay
    from karpenter_tpu_torch.sim.trace import read_trace

    repo = os.path.dirname(os.path.abspath(__file__))
    launches = {}

    # 1. the binary on the card, then refusing to start without one
    dev_args = ("--device", "cpu") if DEVICE == "cpu" else ()
    on_card = run_binary(repo, {}, dev_args)
    no_card = run_binary(repo, {"CUDA_VISIBLE_DEVICES": ""})
    probe = [line for line in on_card["stderr"].splitlines() if '"CUDA probe"' in line]
    binary_ok = {
        "exit_0": on_card["rc"] == 0,
        "probe_names_the_card": DEVICE == "cpu" or bool(probe and tag["card"] in probe[0]),
        "readyz_200_after_a_sweep": on_card["start_to_ready_s"] is not None,
        "metrics_dumped": "karpenter_nodes_ready_count" in on_card["stdout"],
        "no_card_exit_nonzero": no_card["rc"] != 0,
        "no_card_names_device_cpu": "--device cpu" in no_card["stderr"],
        "no_card_no_tick": ("nodeclass readiness" not in no_card["stderr"]
                            and 200 not in no_card["readyz_statuses"]),
    }
    binary_doc = {
        "on_card": {k: on_card[k] for k in ("cmd", "rc", "wall_s", "start_to_ready_s",
                                             "readyz_statuses")},
        "probe_line": probe[0] if probe else None,
        "no_card": {k: no_card[k] for k in ("rc", "wall_s", "readyz_statuses")},
        "no_card_stderr": no_card["stderr"].strip().splitlines()[-1:],
        # the binary's warm-up ladder and store (printed, not gated)
        "aot_metrics": [ln for ln in on_card["stdout"].splitlines()
                        if ln.startswith(("karpenter_aot_", "karpenter_compile_cache_"))
                        or 'impl="aot"' in ln],
        "checks": binary_ok,
    }
    if not all(binary_ok.values()):
        raise AssertionError(f"the binary: {binary_ok}: {on_card['stderr'][-2000:]}")

    # 2. the full-width operator world on the card: 50,000 pending pods, a
    # 10,000-pod wave, then 75 % of the pods deleted
    ka.launches = kb.launches = 0
    plain0 = {k: v for k, v in dispatch_counts(metrics).items() if k.endswith("/plain")}
    with recording(ka, kb) as rec:
        card = operator_world(dev)
    launches["operator world"] = {"ffd_scan": ka.launches, "disrupt_repack": kb.launches}
    # the operator path's own kernel operands (phases `kernels` and `times`):
    # kernel A at the 50k tick and at the wave, kernel B as the provisioner's
    # pre-pass (one candidate set) and as the widest disruption sweep
    # (each with its launches in the world: per stage, or per kind of call)
    repacks = rec["disrupt_repack"]

    def stage_launches(stage):
        return int(sum(t["dispatches"].get("ffd_scan/cuda", 0) + t["dispatches"].get(
            "ffd_scan/plain", 0) for t in card["ticks"] if t["stage"] == stage))

    prepass = [o for o in repacks if o[4].shape[0] == 1]
    sweeps_b = [o for o in repacks if o[4].shape[0] > 1]
    operands = {
        "ffd_scan": {"operator 50k tick": (rec["ffd_scan"][0], stage_launches("50k")),
                     "operator 10k wave": (rec["ffd_scan"][-1], stage_launches("10k wave"))},
        "disrupt_repack": {
            "operator pre-pass": (prepass[0], len(prepass)),
            "operator sweep (widest)": (max(sweeps_b, key=lambda o: o[4].shape[0]), len(sweeps_b)),
        },
    }
    plain1 = {k: v for k, v in dispatch_counts(metrics).items() if k.endswith("/plain")}
    if DEVICE != "cpu" and plain1 != plain0:
        raise AssertionError(f"the card's operator world ran a plain version: {plain0} -> {plain1}")
    missing = [k for k, n in launches["operator world"].items() if n < 1]
    if missing:
        raise AssertionError(f"the operator world did not launch {missing}")
    flight_ok = all(t["flight"]["brownout_level"] == 0 and isinstance(t["flight"]["nodes_ready"], int)
                    and isinstance(t["flight"]["pods_bound_total"], int) for t in card["ticks"])
    last = card["ticks"][-1]
    world_doc = {
        "pods": [N_PODS, N_WAVE], "deleted_fraction": 0.75, "g_max": G_MAX,
        "ticks": [{k: v for k, v in t.items() if k != "digest"} for t in card["ticks"]],
        "card_seconds": card["seconds"], "quiet_within_ramp_ticks": card["quiet"],
        "reference": "the same world with device='cpu': phase references",
        "launches": launches["operator world"], "flight_fields_filled": flight_ok,
        "final": {"claims": last["claims"], "bound": last["bound"], "pending": last["pending"]},
        "wall_note": "host clock around Operator.tick() ending in a sync; dispatches: "
                     "karpenter_solver_kernel_dispatches_total moved in the tick",
    }
    if not flight_ok:
        raise AssertionError("a flight record lacks the operator's fields")
    digests = [t["digest"] for t in card["ticks"]]
    del card

    # 3. the golden corpus through the port's own replay on the card
    golden_dir = os.path.join(repo, "tests", "golden", "scenarios")
    with open(os.path.join(golden_dir, "digests.json")) as f:
        golden = json.load(f)

    def replay_counted(key, backend, name):
        events = read_trace(os.path.join(golden_dir, f"{name}.jsonl"))
        seed = next((int(e["seed"]) for e in events if e.get("ev") == "header" and "seed" in e), 0)
        ka.launches = kb.launches = 0
        t0 = time.perf_counter()
        res = replay(events, backend=backend, seed=seed, device=DEVICE)
        wall = time.perf_counter() - t0
        launches[f"replay {key}"] = {"ffd_scan": ka.launches, "disrupt_repack": kb.launches}
        return {"digest_equal": res.digest == golden[key if backend != "wire" else name],
                "wall_s": wall, "ticks": res.ticks, "launches": launches[f"replay {key}"]}

    corpus = {}
    for key in sorted(golden):
        backend, _, name = key.rpartition(":")
        corpus[key] = replay_counted(key, backend or "host", name)
    for name in ("diurnal-small", "diurnal-consolidation"):
        corpus[f"wire:{name}"] = replay_counted(f"wire:{name}", "wire", name)
    corpus_ok = all(d["digest_equal"] for d in corpus.values())
    overload.install_brownout(None)
    emit({"phase": "operator", "binary": binary_doc, "world": world_doc, "corpus": corpus,
          "corpus_ok": corpus_ok, **tag})
    if not corpus_ok:
        raise AssertionError(f"a corpus digest differs: "
                             f"{[k for k, d in corpus.items() if not d['digest_equal']]}")
    return launches, operands, digests


# phase `kube`: the operator over the apiserver bus. The world's pods are
# cut from 50,000 by the bus's own quadratic binding (each bind
# invalidates the pod snapshot and the binder's next check re-LISTs every
# pod: PERF.md section 4); its catalog and the kernels' widths stay full.
# Its device="cpu" reference runs after the card's timed work (phase
# `references`), so the card world and its reference run in turn: to stay
# inside the script's time limit on a slow host, the ramp-down's ticks
# were cut (4 to 2) and each stage's settle ticks (5 to 4, the last ones
# idle) before the pods (1,000 to 800; PERF.md section 4).
KUBE_PODS = 800
KUBE_WAVE = 200
KUBE_BINARY_PODS = 200
KUBE_STAGE_TICKS = (("pods", 4), ("wave", 4), ("ramp-down", 2))
# the binding tick: the third of the first stage (the nodes the first
# launched register on the second and come ready on the third)
KUBE_BINDING_TICK = ("pods", 2)
# the world's FakeClock starts after every creationTimestamp the apiserver
# stamps from the wall clock, so node ages are positive and the sweep can act
KUBE_CLOCK = 4_000_000_000.0
SIDE_WORLD_TIMEOUT_S = 700


def load_fake_apiserver(repo: str):
    """tests/fake_apiserver.py by file path: it is stdlib only, while
    importing `tests` as a package would run its conftest, which imports
    JAX."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "fake_apiserver", os.path.join(repo, "tests", "fake_apiserver.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def write_kubeconfig(path: str, url: str) -> None:
    # JSON is YAML: the binary reads it with yaml.safe_load
    with open(path, "w") as f:
        json.dump({"apiVersion": "v1", "kind": "Config", "current-context": "smoke",
                   "contexts": [{"name": "smoke", "context": {"cluster": "smoke",
                                                              "user": "smoke"}}],
                   "clusters": [{"name": "smoke", "cluster": {"server": url}}],
                   "users": [{"name": "smoke", "user": {"token": "smoke"}}]}, f)


def kube_world(repo: str, device, profile: bool = False) -> dict:
    """The port's Operator (TorchSolver(g_max=G_MAX) and its consolidation
    engine on `device`) over KubeCluster on an in-process fake apiserver,
    under a FakeClock: KUBE_PODS pods from workload.synth_pods's 160
    templates, a KUBE_WAVE-pod wave onto the live nodes, 75 % of the pods
    deleted, the ramp-down. Per tick: host wall, HTTP requests the operator
    sent, the kernel dispatches it made and a digest of its decisions
    (NodeClaims and pod bindings by name); with `profile` on the card, the
    binding tick runs under torch.profiler for the device's busy time."""
    import hashlib

    from karpenter_tpu_torch import metrics, seeding, workload
    from karpenter_tpu_torch.apis import Node, NodeClaim, NodePool, Pod, TPUNodeClass
    from karpenter_tpu_torch.apis import labels as wk
    from karpenter_tpu_torch.cache.ttl import FakeClock
    from karpenter_tpu_torch.controllers.disruption import MIN_NODE_LIFETIME
    from karpenter_tpu_torch.kube import KubeClient, KubeConfig, KubeCluster, convert
    from karpenter_tpu_torch.operator import Operator, Options
    from karpenter_tpu_torch.solver.consolidate import ConsolidationEvaluator
    from karpenter_tpu_torch.solver.service import TorchSolver

    srv = load_fake_apiserver(repo).FakeApiServer().start()
    clock = FakeClock(KUBE_CLOCK)
    cluster = KubeCluster(KubeClient(KubeConfig(server=srv.url)), clock=clock)
    user = KubeClient(KubeConfig(server=srv.url))
    pod_info = convert.REGISTRY[Pod]
    requests = [0]
    send = cluster.client.request

    def counted(*a, **k):
        requests[0] += 1
        return send(*a, **k)

    cluster.client.request = counted
    on_card = torch.device(device).type == "cuda"
    saved = seeding.snapshot()
    ticks = []
    prev_nodes = set()
    t_world = time.perf_counter()
    try:
        solver = TorchSolver(g_max=G_MAX, device=device)
        op = Operator(clock=clock, cluster=cluster, solver=solver,
                      consolidation_evaluator=ConsolidationEvaluator(solver=solver),
                      options=Options(seed=SEED, tracing=False))
        op.cluster.create(TPUNodeClass("default"))
        op.cluster.create(NodePool("default"))

        def tick(stage, i):
            nonlocal prev_nodes
            before, r0 = dispatch_counts(metrics), requests[0]
            profiled = profile and on_card and (stage, i) == KUBE_BINDING_TICK
            busy = None
            t0 = time.perf_counter()
            if profiled:
                from torch.profiler import ProfilerActivity, profile as capture

                with capture(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                    op.tick()
                    torch.cuda.synchronize()
                busy = sum(getattr(e, "self_device_time_total", None)
                           or getattr(e, "self_cuda_time_total", 0)
                           for e in prof.key_averages() if "CUDA" in str(e.device_type)) / 1e3
            else:
                op.tick()
                if on_card:
                    torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
            sent = requests[0] - r0
            after = dispatch_counts(metrics)
            claims = sorted(
                (c.metadata.name, c.metadata.labels.get(wk.NODEPOOL_LABEL, ""),
                 c.metadata.labels.get(wk.INSTANCE_TYPE_LABEL, ""),
                 c.metadata.labels.get(wk.ZONE_LABEL, ""),
                 c.metadata.labels.get(wk.CAPACITY_TYPE_LABEL, ""), c.deleting)
                for c in op.cluster.list(NodeClaim))
            bindings = sorted((p.metadata.name, p.node_name or "") for p in op.cluster.list(Pod))
            nodes_now = {n.metadata.name for n in op.cluster.list(Node)}
            bound = sum(1 for _, n in bindings if n)
            ticks.append({
                "stage": stage, "wall_ms": wall, "http_requests": sent, "profiled": profiled,
                "device_busy_ms": busy,
                "device_idle_share": None if busy is None else 1.0 - busy / wall,
                "digest": hashlib.sha256(json.dumps([claims, bindings]).encode()).hexdigest(),
                "claims": len(claims), "bound": bound,
                "newly_bound": bound - (ticks[-1]["bound"] if ticks else 0),
                "pending": sum(1 for _, n in bindings if not n),
                "nodes_launched": len(nodes_now - prev_nodes),
                "nodes_retired": len(prev_nodes - nodes_now),
                "dispatches": {k: after[k] - before[k] for k in after if after[k] != before[k]},
            })
            prev_nodes = nodes_now
            op.clock.step(OPERATOR_STEP_S)

        rng = np.random.default_rng
        waves = {"pods": workload.synth_pods(rng(SEED), workload.ZONES, KUBE_PODS, salt=1),
                 "wave": workload.synth_pods(rng(SEED + 1), workload.ZONES, KUBE_WAVE, salt=2)}
        setup_s = 0.0
        for stage, n_ticks in KUBE_STAGE_TICKS:
            t0 = time.perf_counter()
            if stage in waves:
                for p in waves[stage][:KUBE_PODS if stage == "pods" else KUBE_WAVE]:
                    op.cluster.create(p)
            else:
                # the users delete 3 of every 4 pods through their own client
                # (KubeCluster.delete by name re-LISTs the pods to confirm)
                pods = sorted((p.metadata.name, p.metadata.namespace)
                              for p in op.cluster.list(Pod))
                for i, (name, ns) in enumerate(pods):
                    if i % 4:
                        user.delete(f"{pod_info.base_path(ns)}/{name}")
                op.clock.step(MIN_NODE_LIFETIME + 60)
            setup_s += time.perf_counter() - t0
            for i in range(n_ticks):
                tick(stage, i)
    finally:
        seeding.restore(saved)
        cluster.stop()
        srv.stop()
    return {"ticks": ticks, "seconds": time.perf_counter() - t_world, "setup_s": setup_s}


class SideWorld:
    """A reference world in a second process, `python3 chip_smoke.py MODE
    OUT N_PODS N_WAVE G_MAX` (MODE `--operator-twin` or `--kube-reference`,
    both with device="cpu"); `result()` waits for it, `stop()` ends it
    whatever happened."""

    def __init__(self, mode: str, n_pods: int, n_wave: int):
        self.tmp = tempfile.mkdtemp(prefix="karpenter-side-")
        self.path = os.path.join(self.tmp, "world.json")
        self.log_path = os.path.join(self.tmp, "world.log")
        self.t0 = time.perf_counter()
        with open(self.log_path, "wb") as log:
            self.proc = subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), mode, self.path,
                 str(n_pods), str(n_wave), str(G_MAX)],
                cwd=os.path.dirname(os.path.abspath(__file__)), stdout=log,
                stderr=subprocess.STDOUT)

    def result(self):
        """(the world's document, seconds from the process's start to its end)."""
        rc = self.proc.wait(timeout=max(60.0, SIDE_WORLD_TIMEOUT_S
                                        - (time.perf_counter() - self.t0)))
        seconds = time.perf_counter() - self.t0
        if rc != 0:
            with open(self.log_path) as f:
                raise AssertionError(f"the side world failed ({rc}): {f.read()[-3000:]}")
        with open(self.path) as f:
            return json.load(f), seconds

    def stop(self):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait(timeout=60)
        shutil.rmtree(self.tmp, ignore_errors=True)


def side_world(mode: str, out_path: str) -> int:
    """The body of a SideWorld's process: the world with device="cpu" on
    four intra-op threads (the two references share the host's cores), its
    document written to OUT as JSON."""
    torch.set_num_threads(4)
    if mode == "--operator-twin":
        doc = operator_world("cpu")
    else:
        doc = kube_world(os.path.dirname(os.path.abspath(__file__)), "cpu")
    with open(out_path, "w") as f:
        json.dump(doc, f)
    return 0


# each card world's reference: the SideWorld mode and its sizes
REFERENCES = {"operator": lambda: ("--operator-twin", N_PODS, N_WAVE),
              "kube": lambda: ("--kube-reference", KUBE_PODS, KUBE_WAVE)}


def start_references(card_worlds: dict) -> dict:
    """The device="cpu" reference of each card world (name -> its per-tick
    digests), each in its own process, all started at once: name ->
    (the card's digests, its SideWorld). Start them once the card's timed
    work is done, so that no wall the script prints was taken beside them."""
    references = {}
    try:
        for name, digests in card_worlds.items():
            references[name] = (digests, SideWorld(*REFERENCES[name]()))
    except BaseException:
        stop_references(references)
        raise
    return references


def stop_references(references: dict) -> None:
    for _, side in references.values():
        side.stop()


def phase_references(tag: dict, references: dict) -> None:
    """Waits for each reference of `start_references` and holds its card
    world against it: equal tick by tick (the NodeClaims and pod
    bindings), or the phase fails."""
    doc = {}
    for name, (digests, side) in references.items():
        ref, process_s = side.result()
        doc[name] = {
            "ticks": len(digests), "reference_ticks": len(ref["ticks"]),
            "ticks_equal": [a == b["digest"] for a, b in zip(digests, ref["ticks"])],
            "reference_world_seconds": ref["seconds"], "reference_process_seconds": process_s,
        }
    emit({"phase": "references", "reference": "the same world with device='cpu', each in "
          "a second process, all started after the card's timed work", **doc, **tag})
    differ = [name for name, d in doc.items()
              if d["ticks"] != d["reference_ticks"] or not all(d["ticks_equal"])]
    if differ:
        raise AssertionError(f"a card world differs from its device='cpu' reference: {differ}")


def phase_kube(dev, tag: dict, metrics, ka, kb):
    """The binary over a fake apiserver and the full-width operator world
    over KubeCluster on the card; returns the kernel launches and operands
    of the card's world and its per-tick digests (phase `references` holds
    them against the same world with device="cpu")."""
    import re

    from karpenter_tpu_torch import overload, workload
    from karpenter_tpu_torch.apis import NodePool, Pod, TPUNodeClass
    from karpenter_tpu_torch.kube import KubeClient, KubeConfig, KubeCluster

    repo = os.path.dirname(os.path.abspath(__file__))
    tmp = tempfile.mkdtemp(prefix="karpenter-kube-")
    dev_args = ("--device", "cpu") if DEVICE == "cpu" else ()
    try:
        # 1. the binary over a fake apiserver that holds the default class
        # and pool and KUBE_BINARY_PODS pods
        fa = load_fake_apiserver(repo)
        srv = fa.FakeApiServer().start()
        cl = KubeCluster(KubeClient(KubeConfig(server=srv.url)))
        reader = KubeCluster(KubeClient(KubeConfig(server=srv.url)), list_cache_ttl=0.0)
        try:
            cl.create(TPUNodeClass("default"))
            cl.create(NodePool("default"))
            pool_uid = cl.get(NodePool, "default").metadata.uid
            for p in workload.synth_pods(np.random.default_rng(SEED), workload.ZONES,
                                         KUBE_BINARY_PODS, salt=3)[:KUBE_BINARY_PODS]:
                cl.create(p)
            kubeconfig = os.path.join(tmp, "kubeconfig")
            write_kubeconfig(kubeconfig, srv.url)
            # the kwok nodes register 3 s and initialize 2 s after launch
            # on the wall clock: 16 ticks half a second apart outlast both
            run = run_binary(repo, {}, ("--kubeconfig", kubeconfig, "--max-ticks", "16",
                                        "--tick-interval", "0.5", *dev_args))
            pods = reader.list(Pod)
            pools = reader.list(NodePool)
        finally:
            cl.stop()
            reader.stop()
            srv.stop()
        # then `--in-cluster` without the service account's env: it reaches
        # no apiserver
        off_cluster = run_binary(repo, {}, ("--in-cluster", "--max-ticks", "3", *dev_args),
                                 ("KUBERNETES_SERVICE_HOST", "KUBERNETES_SERVICE_PORT"))
        # on the card kernel A runs launched (cuda) or inside a graph the
        # warm-up ladder armed (aot)
        impls = ("plain",) if DEVICE == "cpu" else ("cuda", "aot")
        dumped = {}
        for labels, value in re.findall(
                r"^karpenter_solver_kernel_dispatches_total\{([^}]*)\} (\S+)$",
                run["stdout"], re.M):
            dumped[labels] = float(value)
        scans = sum(v for k, v in dumped.items()
                    if 'entry="ffd_solve_fused"' in k and any(f'impl="{i}"' in k for i in impls))
        binary_ok = {
            "exit_0": run["rc"] == 0,
            "readyz_200": run["start_to_ready_s"] is not None,
            "every_pod_bound": len(pods) == KUBE_BINARY_PODS and all(p.node_name for p in pods),
            "no_nodepool_written": ([(p.metadata.name, p.metadata.uid) for p in pools]
                                    == [("default", pool_uid)]),
            "kernel_a_launched": scans >= 1,
            "in_cluster_off_cluster_exit_nonzero": off_cluster["rc"] != 0,
            "in_cluster_names_the_cause": "no KUBERNETES_SERVICE_HOST" in off_cluster["stderr"],
            "in_cluster_no_tick": ("nodeclass readiness" not in off_cluster["stderr"]
                                   and 200 not in off_cluster["readyz_statuses"]),
        }
        binary_doc = {
            "pods": KUBE_BINARY_PODS, "cmd": run["cmd"], "rc": run["rc"],
            "wall_s": run["wall_s"], "start_to_ready_s": run["start_to_ready_s"],
            "readyz_statuses": run["readyz_statuses"], "bound": sum(1 for p in pods if p.node_name),
            "kernel_a_dispatches": scans,
            "in_cluster": {"rc": off_cluster["rc"], "wall_s": off_cluster["wall_s"],
                           "stderr": off_cluster["stderr"].strip().splitlines()[-1:]},
            "checks": binary_ok,
        }
        if not all(binary_ok.values()):
            raise AssertionError(f"phase kube, the binary: {binary_ok}: {run['stderr'][-2000:]}"
                                 f"{off_cluster['stderr'][-1000:]}")

        # 2. the world on the card, counted and recorded
        ka.launches = kb.launches = 0
        with recording(ka, kb) as rec:
            card = kube_world(repo, dev, profile=True)
        launches = {"kube world": {"ffd_scan": ka.launches, "disrupt_repack": kb.launches}}
        missing = [k for k, n in launches["kube world"].items() if n < 1]
        if missing:
            raise AssertionError(f"the kube world did not launch {missing}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    def scans_in(stage):
        return int(sum(t["dispatches"].get("ffd_scan/cuda", 0)
                       + t["dispatches"].get("ffd_scan/plain", 0)
                       for t in card["ticks"] if t["stage"] == stage))

    repacks = rec["disrupt_repack"]
    prepass = [o for o in repacks if o[4].shape[0] == 1]
    sweeps_b = [o for o in repacks if o[4].shape[0] > 1]
    n_pods = scans_in("pods")
    operands = {"ffd_scan": {"kube pods tick": (rec["ffd_scan"][0], n_pods)},
                "disrupt_repack": {}}
    if len(rec["ffd_scan"]) > n_pods:
        operands["ffd_scan"]["kube wave"] = (rec["ffd_scan"][n_pods], scans_in("wave"))
    if prepass:
        operands["disrupt_repack"]["kube pre-pass"] = (prepass[0], len(prepass))
    if sweeps_b:
        operands["disrupt_repack"]["kube sweep (widest)"] = (
            max(sweeps_b, key=lambda o: o[4].shape[0]), len(sweeps_b))
    binding = next((t for t in card["ticks"] if t["profiled"]), None)
    world_doc = {
        "pods": [KUBE_PODS, KUBE_WAVE], "deleted_fraction": 0.75, "g_max": G_MAX,
        "stage_ticks": dict(KUBE_STAGE_TICKS),
        "reference": "the kube world with device='cpu': phase references",
        "ticks": [{k: v for k, v in t.items() if k != "digest"} for t in card["ticks"]],
        "card_seconds": card["seconds"], "setup_s": card["setup_s"],
        "launches": launches["kube world"],
        "binding_tick": None if binding is None else {
            k: binding[k] for k in ("wall_ms", "device_busy_ms", "device_idle_share",
                                    "newly_bound", "http_requests")},
        "http_requests_per_tick": [t["http_requests"] for t in card["ticks"]],
        "final": {k: card["ticks"][-1][k] for k in ("claims", "bound", "pending")},
        "wall_note": "host clock around Operator.tick() ending in a sync; http_requests: "
                     "KubeClient.request calls the operator made in the tick",
    }
    overload.install_brownout(None)
    emit({"phase": "kube", "binary": binary_doc, "world": world_doc, **tag})
    if not any(t["nodes_retired"] for t in card["ticks"] if t["stage"] == "ramp-down"):
        raise AssertionError("the kube world's ramp-down retired no node")
    return launches, operands, [t["digest"] for t in card["ticks"]]


def rehearse_kube(n_pods: int) -> int:
    """`python3 chip_smoke.py --rehearse-kube [N_PODS]`: phases `kube` and
    `references` (its world only) on the CPU (DEVICE = "cpu", g_max 256,
    the wave a quarter of N_PODS, the binary with --device cpu), each
    kernel wrapper counted as the phase counts launches on the card;
    prints the phases' lines and the seconds."""
    global DEVICE, G_MAX, KUBE_PODS, KUBE_WAVE
    from karpenter_tpu_torch import metrics
    from karpenter_tpu_torch.solver.kernels import disrupt_repack as kb
    from karpenter_tpu_torch.solver.kernels import ffd_scan as ka

    torch.set_num_threads(4)
    DEVICE, G_MAX, KUBE_PODS, KUBE_WAVE = "cpu", 256, n_pods, n_pods // 4
    for mod, name in ((ka, "fused_scan"), (kb, "disrupt_repack")):
        def call(*a, _fn=getattr(mod, name), _mod=mod, **k):
            _mod.launches += 1
            return _fn(*a, **k)
        setattr(mod, name, call)
    tag = {"card": "cpu rehearsal", "power_limit": "n/a"}
    t0 = time.perf_counter()
    launches, _, digests = phase_kube(torch.device("cpu"), tag, metrics, ka, kb)
    card_s = time.perf_counter() - t0
    references = start_references({"kube": digests})
    try:
        phase_references(tag, references)
    finally:
        stop_references(references)
    print(json.dumps({"rehearsal": "kube", "launches": launches, "card_seconds": card_s,
                      "seconds": time.perf_counter() - t0}), flush=True)
    return 0


# -- coldstart: tick 1 of a fresh process, over an empty and a warm store ----------

COLDSTART_TIMEOUT_S = 400
# tier 0 of the warm-up ladder's plan (solver/aot.py)
TIER0_ENTRIES = ("ffd_solve_fused", "fractional_price_bound")


def decision_digest(result) -> str:
    """sha256 of a decision: groups by pod names and cheapest type,
    existing-node assignments, unschedulable reasons."""
    import hashlib

    sig = (
        sorted((tuple(sorted(p.metadata.name for p in g.pods)), g.instance_types[0].name)
               for g in result.new_groups),
        sorted(result.existing_assignments.items()),
        sorted(result.unschedulable.items()),
    )
    return hashlib.sha256(repr(sig).encode()).hexdigest()


def coldstart_child(mode: str, out_path: str) -> int:
    """One process of phase `coldstart` (`--coldstart MODE OUT N_PODS
    G_MAX DEVICE`, $KARPENTER_TPU_COMPILE_CACHE set by the caller): the
    CUDA context, the store prepared, then `empty` builds the libraries
    (nvcc, one process per source) and `warm` enables AOT over the store
    and drains the warm-up ladder on the staged catalog; then tick 1 of
    the main path with its stages, each device entry's first dispatch and
    the store's counters, and a second tick. Writes the document to OUT."""
    from karpenter_tpu_torch import metrics, workload
    from karpenter_tpu_torch.apis import NodePool
    from karpenter_tpu_torch.obs import jitstats
    from karpenter_tpu_torch.solver import ffd
    from karpenter_tpu_torch.solver.kernels import build
    from karpenter_tpu_torch.solver.service import TorchSolver
    from karpenter_tpu_torch.utils import enable_compilation_cache

    dev = torch.device(DEVICE)
    on_card = dev.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    doc = {"mode": mode, "device": DEVICE}
    t0 = time.perf_counter()
    if on_card:
        torch.cuda.init()
        torch.empty(1, device=dev)
        sync()
    doc["cuda_context_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    home = enable_compilation_cache()
    doc["store"] = {"dir": home, "prepare_s": time.perf_counter() - t0,
                    "before": build.store_stats(home)}
    jitstats.install()
    items = workload.build_catalog_items()
    pool = NodePool("default")
    pods1 = workload.synth_pods(np.random.default_rng(SEED), workload.ZONES, N_PODS, salt=1)
    solver = TorchSolver(g_max=G_MAX, device=dev)
    if mode == "empty":
        t0 = time.perf_counter()
        if on_card:
            build.build()
        doc["nvcc_wall_s"] = time.perf_counter() - t0
        doc["nvcc_s"] = {name: log["seconds"] for name, log in build.BUILD_LOG.items()}
    else:
        t0 = time.perf_counter()
        mgr = solver.enable_aot(home, duty=1.0)
        doc["enable_aot_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        solver._catalog(items)          # stages the catalog: the ladder plans it
        doc["ladder_drained"] = mgr.drain(COLDSTART_TIMEOUT_S)
        doc["stage_and_ladder_s"] = time.perf_counter() - t0
        doc["aot"] = mgr.describe()
    jitstats.reset()
    before = {"aot": {e: metrics.AOT_DISPATCHES.value(entry=e) for e in TIER0_ENTRIES},
              "impl": {i: metrics.SOLVER_KERNEL_DISPATCHES.value(entry="ffd_solve_fused", impl=i)
                       for i in ("cuda", "plain", "aot")}}
    with fn_timer([(ffd, "stage_catalog", "catalog_staging"), (solver, "_group", "group"),
                   (solver, "_encode", "encode"), (ffd, "fetch_fused", "fetch_fused"),
                   (solver, "_decode", "decode")]) as stages:
        t0 = time.perf_counter()
        tick1 = solver.solve(pool, items, pods1)
        sync()
        wall1 = (time.perf_counter() - t0) * 1e3
    table = jitstats.table()
    doc["tick1"] = {
        "wall_ms": wall1, "stages_ms": dict(stages),
        "first_dispatch": {e: {k: row[k] for k in ("dispatches", "dispatch_ms", "compiles",
                                                  "compile_ms")}
                           for e, row in table.items() if row.get("dispatches")},
        "library_load_ms": sum(row.get("compile_ms", 0.0) for e, row in table.items()
                               if e.endswith((".fused_scan", "kernels.disrupt_repack.disrupt_repack"))),
        "aot_dispatches": {e: metrics.AOT_DISPATCHES.value(entry=e) - before["aot"][e]
                           for e in TIER0_ENTRIES},
        "fused_dispatches_by_impl": {
            i: metrics.SOLVER_KERNEL_DISPATCHES.value(entry="ffd_solve_fused", impl=i)
            - before["impl"][i] for i in before["impl"]},
        "decision_sig": decision_digest(tick1),
        "groups": len(tick1.new_groups),
    }
    t0 = time.perf_counter()
    tick1b = solver.solve(pool, items, pods1)
    sync()
    doc["tick1_again_ms"] = (time.perf_counter() - t0) * 1e3
    doc["tick1_again_same"] = decision_digest(tick1b) == doc["tick1"]["decision_sig"]
    doc["cache"] = {k: v for k, v in jitstats.cache_stats().items()}
    doc["nvcc_runs"] = len(build.BUILD_LOG)
    doc["loaded_from_store"] = {n: metrics.AOT_LOADED.value(entry=n) for n in build.SOURCES}
    doc["store"]["after"] = build.store_stats(home)
    if solver._aot is not None:
        solver._aot.stop(timeout_s=60.0)
    with open(out_path, "w") as f:
        json.dump(doc, f)
    return 0


def phase_coldstart(tag: dict) -> dict:
    """Phase `coldstart`: `coldstart_child` in two fresh processes over one
    temporary store, empty then warm. Prints, claims nothing; fails when
    the warm process ran nvcc or missed the store, served tick 1 without an
    armed dispatch, planned tier 0 short of full coverage, or decided
    otherwise than the empty one."""
    docs = {}
    with tempfile.TemporaryDirectory(prefix="karpenter-coldstart-") as tmp:
        env = dict(os.environ, KARPENTER_TPU_COMPILE_CACHE=os.path.join(tmp, "store"))
        for mode in ("empty", "warm"):
            out, log = os.path.join(tmp, f"{mode}.json"), os.path.join(tmp, f"{mode}.log")
            t0 = time.perf_counter()
            with open(log, "wb") as f:
                proc = subprocess.run(
                    [sys.executable, os.path.abspath(__file__), "--coldstart", mode, out,
                     str(N_PODS), str(G_MAX), DEVICE],
                    cwd=os.path.dirname(os.path.abspath(__file__)), env=env, stdout=f,
                    stderr=subprocess.STDOUT, timeout=COLDSTART_TIMEOUT_S)
            seconds = time.perf_counter() - t0
            if proc.returncode != 0:
                with open(log) as f:
                    raise AssertionError(f"coldstart {mode} exited {proc.returncode}: "
                                         f"{f.read()[-3000:]}")
            with open(out) as f:
                docs[mode] = json.load(f)
            docs[mode]["process_s"] = seconds
    a, b = docs["empty"], docs["warm"]
    entries = b["aot"]["entries"]
    checks = {
        "empty_built_every_library": DEVICE == "cpu" or sorted(a["nvcc_s"]) == sorted(
            ("ffd_scan", "disrupt_repack")),
        "warm_cache_misses_0": b["cache"]["misses"] == 0,
        "warm_no_nvcc_run": b["nvcc_runs"] == 0,
        "warm_loaded_every_library": DEVICE == "cpu" or all(
            n >= 1 for n in b["loaded_from_store"].values()),
        "warm_ladder_drained": b["ladder_drained"] and b["aot"]["compile_failures"] == 0,
        "warm_tick1_aot_fused_ge_1": b["tick1"]["aot_dispatches"]["ffd_solve_fused"] >= 1,
        "warm_tier0_coverage_1": all(entries.get(e, {}).get("fraction") == 1.0
                                     for e in TIER0_ENTRIES),
        "tick1_decision_sig_equal": a["tick1"]["decision_sig"] == b["tick1"]["decision_sig"],
        "second_ticks_equal": a["tick1_again_same"] and b["tick1_again_same"],
    }
    emit({"phase": "coldstart", "pods": N_PODS, "g_max": G_MAX, "empty_cache": a,
          "warm_cache": b, "checks": checks, "claimed": "nothing: printed beside the card",
          **tag})
    if not all(checks.values()):
        raise AssertionError(f"phase coldstart: {checks}")
    return docs


WITNESS_TIMEOUT_S = 420
# live ticks of the main path beside the warm-up ladder (duty 0.05): at
# least this many, and on the card until the ladder has captured inside
# the window, for at most WITNESS_WINDOW_S
WITNESS_LIVE_TICKS = 20
WITNESS_WINDOW_S = 45.0


def p90(values) -> float:
    return statistics.quantiles(values, n=10, method="inclusive")[-1] if len(values) > 1 \
        else values[0]


def witness_child(out_path: str) -> int:
    """Phase `witness`, one process (`--witness OUT N_PODS N_WAVE G_MAX
    DEVICE`): the port's three runtime witnesses installed BEFORE the
    first import of karpenter_tpu_torch, then (a) ticks 1 and 2 of the
    main path, cold then warm (the warm ones inside torch_witness.hot());
    (b) `enable_aot(duty=0.05)`, as the binary runs it, and live ticks
    inside hot() while the ladder's thread captures; (c) a SolverServer
    thread and ticks through the port's client; (d) the convex.rounding
    drill. Writes the witnesses' counts and the ticks' walls to OUT."""
    from karpenter_tpu_torch.analysis import witness

    witness.install()
    from karpenter_tpu_torch.analysis import torch_witness

    torch_witness.install()
    from karpenter_tpu_torch.analysis import errwitness

    errwitness.install()
    from karpenter_tpu_torch import failpoints, metrics, workload
    from karpenter_tpu_torch.apis import NodePool, Pod
    from karpenter_tpu_torch.scheduling import Resources
    from karpenter_tpu_torch.solver import rpc
    from karpenter_tpu_torch.solver.kernels import build
    from karpenter_tpu_torch.solver.service import TorchSolver

    dev = torch.device(DEVICE)
    on_card = dev.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def timed(fn, label=None):
        """(result, host ms) of fn() ending in a sync, inside hot(label)
        when a label is given."""
        section = torch_witness.hot(label) if label else contextlib.nullcontext()
        with section:
            t0 = time.perf_counter()
            out = fn()
            sync()
            return out, (time.perf_counter() - t0) * 1e3

    doc = {"device": DEVICE, "pods": [N_PODS, N_WAVE], "g_max": G_MAX}
    if on_card:
        build.build()       # the parent's store: loads, no nvcc
    items = workload.build_catalog_items()
    pool = NodePool("default")
    pods1 = workload.synth_pods(np.random.default_rng(SEED), workload.ZONES, N_PODS, salt=1)
    pods2 = workload.synth_pods(np.random.default_rng(SEED + 1), workload.ZONES, N_WAVE, salt=2)

    # (a) the main path: cold, then warm inside hot()
    solver = TorchSolver(g_max=G_MAX, device=dev)
    tick1, cold1 = timed(lambda: solver.solve(pool, items, pods1))
    nodes = workload.nodes_from_result(tick1)
    tick2, cold2 = timed(lambda: solver.solve(pool, items, pods2, existing_nodes=nodes))
    d1, d2 = decision_digest(tick1), decision_digest(tick2)
    warm1, warm2, same = [], [], True
    for _ in range(3):
        r, ms = timed(lambda: solver.solve(pool, items, pods1), "tick 1")
        warm1.append(ms)
        same &= decision_digest(r) == d1
        r, ms = timed(lambda: solver.solve(pool, items, pods2, existing_nodes=nodes), "tick 2")
        warm2.append(ms)
        same &= decision_digest(r) == d2
    doc["main"] = {"tick1_cold_ms": cold1, "tick2_cold_ms": cold2, "tick1_warm_ms": warm1,
                   "tick2_warm_ms": warm2, "decisions_equal_cold": same}

    # (b) the warm-up ladder at the binary's duty beside live ticks
    live_solver = TorchSolver(g_max=G_MAX, device=dev)
    mgr = live_solver.enable_aot(None, duty=0.05)
    st0 = torch_witness.stats()
    hits0 = metrics.AOT_DISPATCHES.value(entry="ffd_solve_fused")
    first, first_ms = timed(lambda: live_solver.solve(pool, items, pods1))   # stages: the ladder plans
    live, same_live = [], decision_digest(first) == d1
    t_window = time.perf_counter()
    while True:
        r, ms = timed(lambda: live_solver.solve(pool, items, pods1), f"live tick {len(live)}")
        live.append(ms)
        same_live &= decision_digest(r) == d1
        captured = torch_witness.stats()["aot_captures"] - st0["aot_captures"]
        elapsed = time.perf_counter() - t_window
        if len(live) >= WITNESS_LIVE_TICKS and (captured >= 2 or not on_card
                                                 or elapsed > WITNESS_WINDOW_S):
            break
    st1 = torch_witness.stats()
    ladder = mgr.describe()
    mgr.stop(timeout_s=120.0)
    doc["ladder"] = {"duty": ladder["duty"], "first_tick_ms": first_ms, "live_tick_ms": live,
                     "window_s": time.perf_counter() - t_window,
                     "captures_in_window": st1["aot_captures"] - st0["aot_captures"],
                     "armed_dispatches": metrics.AOT_DISPATCHES.value(entry="ffd_solve_fused") - hits0,
                     "armed_graphs": ladder["armed"], "ladder_busy_at_end": ladder["ladder_busy"],
                     "decisions_equal": same_live}

    # (c) the sidecar as a thread: a cold wire tick (staging), then a warm one in hot()
    wire_dir = tempfile.mkdtemp(prefix="kt-")
    server = rpc.SolverServer(path=os.path.join(wire_dir, "w.sock"), device=dev).start()
    try:
        client = rpc.SolverClient(path=os.path.join(wire_dir, "w.sock"), timeout=120.0)
        wire_solver = TorchSolver(g_max=G_MAX, device=dev, client=client)
        r_cold, wire_cold = timed(lambda: wire_solver.solve(pool, items, pods1))
        r_warm, wire_warm = timed(lambda: wire_solver.solve(pool, items, pods1), "wire tick")
        doc["wire"] = {"cold_ms": wire_cold, "warm_ms": wire_warm,
                       "transport": "shm" if client._ring is not None else "tcp",
                       "decisions_equal": decision_digest(r_cold) == decision_digest(r_warm) == d1}
        client.close()
    finally:
        server.stop()
        shutil.rmtree(wire_dir, ignore_errors=True)

    # (d) the rounding drill on the adversarial mix: one FFD tick, counted once
    shapes_adv = (("1100m", "2200Mi"), ("700m", "1400Mi"), ("1700m", "3400Mi"))
    adv = [Pod(f"adv{i}", requests=Resources(
        {"cpu": shapes_adv[i % 3][0], "memory": shapes_adv[i % 3][1]})) for i in range(30)]
    cx = TorchSolver(g_max=G_MAX, device=dev, tier="convex")
    ffd_digest = decision_digest(TorchSolver(g_max=G_MAX, device=dev).solve(pool, items, adv))
    cx.solve(pool, items, adv)
    sync()
    f0 = metrics.CONVEX_FALLBACKS.value(reason="rounding")
    failpoints.FAILPOINTS.arm_spec("convex.rounding=error(RuntimeError):times=1")
    try:
        drilled, drill_ms = timed(lambda: cx.solve(pool, items, adv), "drill")
    finally:
        failpoints.FAILPOINTS.reset()
    doc["drill"] = {"spec": "convex.rounding=error(RuntimeError):times=1", "ms": drill_ms,
                    "fallbacks_moved": metrics.CONVEX_FALLBACKS.value(reason="rounding") - f0,
                    "drilled_equals_ffd_tick": decision_digest(drilled) == ffd_digest}

    errwitness.flush()
    swallows = errwitness.swallows()
    doc["counts"] = {"inversions": len(witness.inversions()),
                     "unsanctioned_swallows": sum(not s.sanctioned for s in swallows),
                     "hot_violations": len(torch_witness.hot_violations())}
    doc["witnessed_locks"] = {"wrapped": witness.wrapped_count(), "edges": witness.edge_count(),
                              "sites": witness.sites()}
    doc["swallows"] = [s.render() for s in swallows]
    doc["torch_witness"] = torch_witness.stats()
    doc["reports"] = {"lock": witness.report()[-4000:], "escape": errwitness.report()[-4000:],
                      "torch": torch_witness.report()[-4000:]}
    with open(out_path, "w") as f:
        json.dump(doc, f)
    return 0


def phase_witness(tag: dict, unwitnessed: dict) -> dict:
    """Phase `witness`: `witness_child` in a process of its own. Fails on
    any lock-order inversion, unsanctioned swallow or hot violation (a
    library build or load inside hot(), a capture outside the ladder, an
    unsanctioned sync), on a decision that differs, on a drill that did
    not land on the FFD rung once, and on the card when the ladder did not
    capture beside the live ticks."""
    with tempfile.TemporaryDirectory(prefix="karpenter-witness-") as tmp:
        out, log = os.path.join(tmp, "witness.json"), os.path.join(tmp, "witness.log")
        t0 = time.perf_counter()
        with open(log, "wb") as f:
            proc = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--witness", out, str(N_PODS),
                 str(N_WAVE), str(G_MAX), DEVICE],
                cwd=os.path.dirname(os.path.abspath(__file__)), stdout=f,
                stderr=subprocess.STDOUT, timeout=WITNESS_TIMEOUT_S)
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            with open(log) as f:
                raise AssertionError(f"witness child exited {proc.returncode}: {f.read()[-3000:]}")
        with open(out) as f:
            doc = json.load(f)
    live = doc["ladder"]["live_tick_ms"]
    warm1 = doc["main"]["tick1_warm_ms"]
    costs = {
        "tick1_witnessed_ms": {"median": statistics.median(warm1), "p90": p90(warm1)},
        "tick1_unwitnessed_ms_phase_times": unwitnessed,
        "live_ticks_beside_ladder_ms": {"n": len(live), "median": statistics.median(live),
                                        "p90": p90(live)},
    }
    checks = {
        "inversions_0": doc["counts"]["inversions"] == 0,
        "unsanctioned_swallows_0": doc["counts"]["unsanctioned_swallows"] == 0,
        "hot_violations_0": doc["counts"]["hot_violations"] == 0,
        "locks_witnessed": doc["witnessed_locks"]["wrapped"] > 0,
        "main_decisions_equal": doc["main"]["decisions_equal_cold"],
        "live_ticks_ge_20": len(live) >= WITNESS_LIVE_TICKS,
        "ladder_captured_beside_live_ticks": DEVICE == "cpu" or doc["ladder"]["captures_in_window"] >= 1,
        "live_decisions_equal": doc["ladder"]["decisions_equal"],
        "wire_decisions_equal": doc["wire"]["decisions_equal"],
        "drill_on_the_ffd_rung_once": (doc["drill"]["fallbacks_moved"] == 1
                                       and doc["drill"]["drilled_equals_ffd_tick"]),
    }
    emit({"phase": "witness", "process_s": seconds, "counts": doc["counts"], "costs": costs,
          "witnessed_locks": doc["witnessed_locks"], "torch_witness": doc["torch_witness"],
          "swallows": doc["swallows"], "main": doc["main"], "ladder": doc["ladder"],
          "wire": doc["wire"], "drill": doc["drill"], "checks": checks, **tag})
    if not all(checks.values()):
        raise AssertionError(f"phase witness: {checks}\n{json.dumps(doc['reports'])[:6000]}")
    return doc


def phase_analysis(tag: dict) -> None:
    """Phase `analysis`: the port's static checkers over the tree that
    runs, on the host; fails unless they exit 0 against the baseline."""
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "karpenter_tpu_torch.analysis"],
                       cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True,
                       text=True, timeout=300)
    emit({"phase": "analysis", "command": "python -m karpenter_tpu_torch.analysis",
          "rc": r.returncode, "seconds": time.perf_counter() - t0,
          "summary": (r.stdout.strip().splitlines() or [""])[-1], **tag})
    if r.returncode != 0:
        raise AssertionError(f"python -m karpenter_tpu_torch.analysis exited {r.returncode}: "
                             f"{(r.stdout + r.stderr)[-3000:]}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs only on the card", file=sys.stderr)
        return 2
    from karpenter_tpu_torch import failpoints, metrics, native, tracing, workload
    from karpenter_tpu_torch.analysis import sync_witness
    from karpenter_tpu_torch.apis import NodePool, Pod, labels as wk
    from karpenter_tpu_torch.obs import flight, hbm, profiler
    from karpenter_tpu_torch.scheduling import Requirement, Resources, Taint
    from karpenter_tpu_torch.solver import bound as price_bound
    from karpenter_tpu_torch.solver import encode, ffd, packing
    from karpenter_tpu_torch.solver.convex import relax, rounding
    from karpenter_tpu_torch.solver.convex import tier as convex_tier
    from karpenter_tpu_torch.solver.kernels import build, cases
    from karpenter_tpu_torch.solver.kernels import disrupt_repack as kb
    from karpenter_tpu_torch.solver.kernels import ffd_scan as ka
    from karpenter_tpu_torch.solver.disrupt import DisruptEngine
    from karpenter_tpu_torch.solver.disrupt import engine as engine_mod
    from karpenter_tpu_torch.solver.disrupt import kernel as dk
    from karpenter_tpu_torch.solver.oracle import Scheduler, SchedulingResult
    from karpenter_tpu_torch.solver.service import TorchSolver

    # -- device ---------------------------------------------------------------
    card = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = nvidia_smi()
    power_limit = smi.split(",")[-1].strip()
    tag = {"card": card, "power_limit": power_limit}
    emit({"phase": "device", "kind": card, "count": count, "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})
    dev = torch.device(DEVICE)

    # -- build ----------------------------------------------------------------
    t0 = time.perf_counter()
    build.build()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "nvcc_flags": " ".join(build.NVCC_FLAGS),
          "sources": {name: build.BUILD_LOG.get(name, {"seconds": 0.0, "ptxas": ["cached"]})
                      for name in build.SOURCES}, **tag})

    # the native grouping loop must have built here: a missing cc or
    # Python.h on this machine shows, it is not papered over by the pure loop
    if native.grouping is None:
        raise AssertionError("karpenter_tpu_torch.native.grouping is None: the C grouping "
                             "loop did not build on this machine (cc, Python.h)")
    phase_analysis(tag)

    # every counted run of the main path: its launch counts and the solver's
    # kernel-dispatch counter over the same run (phase `observe` holds the
    # two against each other)
    counted_runs = []

    def start_count() -> dict:
        ka.launches = kb.launches = 0
        return dispatch_counts(metrics)

    def end_count(path: str, launches: dict, before: dict) -> None:
        after = dispatch_counts(metrics)
        counted_runs.append({"path": path, "launches": dict(launches),
                             "dispatches": {k: after[k] - before[k] for k in after}})

    # every rounding that returned None: the convex tier's organic FFD rung
    # (any other convex fallback is a failure, phase `observe`)
    rounding_none = [0]
    round_solution = rounding.round_solution

    def round_counted(*a, **k):
        out = round_solution(*a, **k)
        rounding_none[0] += out is None
        return out

    rounding.round_solution = round_counted

    # -- main path --------------------------------------------------------------
    items = workload.build_catalog_items()
    pool = NodePool("default")
    pods1 = workload.synth_pods(np.random.default_rng(SEED), workload.ZONES, N_PODS, salt=1)
    pods2 = workload.synth_pods(np.random.default_rng(SEED + 1), workload.ZONES, N_WAVE, salt=2)
    solver = TorchSolver(g_max=G_MAX, device=dev)
    torch.cuda.reset_peak_memory_stats()

    # each tick's quality document and its bound's call (phase `quality`)
    quality_docs, bound_calls = {}, {}
    with calls_of(price_bound, "fractional_price_bound") as qcalls:
        d0 = start_count()
        solver.last_quality = None
        t0 = time.perf_counter()
        tick1 = solver.solve(pool, items, pods1)
        torch.cuda.synchronize()
        wall1_cold = (time.perf_counter() - t0) * 1e3
        launches1 = {"ffd_scan": ka.launches, "disrupt_repack": kb.launches}
        end_count("tick 1", launches1, d0)
        quality_docs["tick 1"], bound_calls["tick 1"] = solver.last_quality, qcalls[-1:]
        nodes = workload.nodes_from_result(tick1)

        d0 = start_count()
        solver.last_quality = None
        t0 = time.perf_counter()
        tick2 = solver.solve(pool, items, pods2, existing_nodes=nodes)
        torch.cuda.synchronize()
        wall2_cold = (time.perf_counter() - t0) * 1e3
        launches2 = {"ffd_scan": ka.launches, "disrupt_repack": kb.launches}
        end_count("tick 2", launches2, d0)
        quality_docs["tick 2"], bound_calls["tick 2"] = solver.last_quality, qcalls[-1:]
    peak_bytes = torch.cuda.max_memory_allocated()

    if launches1["ffd_scan"] < 1 or launches2["ffd_scan"] < 1:
        raise AssertionError(f"kernel A did not run on the main path: {launches1} {launches2}")
    if launches2["disrupt_repack"] < 1:
        raise AssertionError(f"kernel B did not run on tick 2: {launches2}")

    def accounted(result, pods):
        names = [p.metadata.name for g in result.new_groups for p in g.pods]
        names += list(result.existing_assignments) + list(result.unschedulable)
        if sorted(names) != sorted(p.metadata.name for p in pods):
            raise AssertionError("a pod was lost or placed twice")
        for g in result.new_groups:
            vec = np.asarray(g.requested.to_vector())
            if not g.instance_types or not np.all(np.isfinite(vec)):
                raise AssertionError("a group without a type or with a non-finite request")
        return {"groups": len(result.new_groups), "on_existing": len(result.existing_assignments),
                "unschedulable": len(result.unschedulable)}

    def sig(result):
        """A decision: groups by pod names and cheapest type, existing-node
        assignments, unschedulable reasons."""
        return (
            sorted((tuple(sorted(p.metadata.name for p in g.pods)), g.instance_types[0].name)
                   for g in result.new_groups),
            sorted(result.existing_assignments.items()),
            sorted(result.unschedulable.items()),
        )

    emit({"phase": "main", "pods": [N_PODS, N_WAVE], "existing_nodes": len(nodes),
          "tick1": accounted(tick1, pods1), "tick2": accounted(tick2, pods2),
          "launches": {"tick1": launches1, "tick2": launches2}, **tag})

    # -- schedule(): the routing entry point on four worlds ----------------------
    zones = set(workload.ZONES)
    default_pools = [pool]
    spot_od = [
        NodePool(name, weight=weight,
                 requirements=[Requirement(wk.CAPACITY_TYPE_LABEL, "In", [name])])
        for name, weight in ((wk.CAPACITY_TYPE_SPOT, 100), (wk.CAPACITY_TYPE_ON_DEMAND, 10))
    ]
    three_pools = spot_od + [NodePool("default")]
    pods_aff = workload.synth_pods(np.random.default_rng(SEED), workload.ZONES, N_PODS - N_AFF,
                                   salt=1) + workload.affinity_pods(1, N_AFF)
    pods_sp1 = workload.synth_pods(np.random.default_rng(SEED), workload.ZONES, N_PODS, salt=1,
                                   spread=N_SPREAD)
    pods_sp2 = workload.synth_pods(np.random.default_rng(SEED + 1), workload.ZONES, N_WAVE,
                                   salt=2, spread=N_SPREAD)

    def sched(pools, existing=(), pods_by_node=None):
        return Scheduler(nodepools=pools, instance_types={p.name: items for p in pools},
                         existing_nodes=existing, pods_by_node=pods_by_node, zones=zones)

    # world -> (pods, the route it must take, the kernels it must launch)
    world_spec = {
        "suffix": (pods_aff, "device+suffix", ("ffd_scan",)),
        "spread tick 1": (pods_sp1, "device", ("ffd_scan",)),
        "spread tick 2": (pods_sp2, "device", ("ffd_scan", "disrupt_repack")),
        "merged": (pods1, "merged", ("ffd_scan",)),
        "merged 3 pools": (pods1, "merged", ("ffd_scan",)),
        "pipelined": (pods1, "device", ("ffd_scan",)),
    }

    def worlds_of(solver, done):
        """The schedule() worlds in run order, name -> thunk. The spread
        wave packs onto fresh nodes of `done["spread tick 1"]`, seeded
        with that tick's pods."""
        def spread2():
            s1 = done["spread tick 1"]
            return solver.schedule(sched(default_pools, workload.nodes_from_result(s1),
                                         workload.pods_by_node(s1)), pods_sp2)

        return {
            "suffix": lambda: solver.schedule(sched(default_pools), pods_aff),
            "spread tick 1": lambda: solver.schedule(sched(default_pools), pods_sp1),
            "spread tick 2": spread2,
            "merged": lambda: solver.schedule(sched(spot_od), pods1),
            "merged 3 pools": lambda: solver.schedule(sched(three_pools), pods1),
            "pipelined": lambda: solver.schedule_finish(
                solver.schedule_begin(sched(default_pools), pods1)),
        }

    sched_solver = TorchSolver(g_max=G_MAX, device=dev)
    world_results, world_ops, world_launches, world_docs = {}, {}, {}, {}
    for name, fn in worlds_of(sched_solver, world_results).items():
        pods_w, route, needed = world_spec[name]
        with recording(ka, kb) as rec, calls_of(price_bound, "fractional_price_bound") as qcalls:
            d0 = start_count()
            sched_solver.last_quality = None
            result = fn()
            torch.cuda.synchronize()
            world_launches[name] = {"ffd_scan": ka.launches, "disrupt_repack": kb.launches}
            end_count(name, world_launches[name], d0)
        world_results[name], world_ops[name] = result, rec
        quality_docs[name], bound_calls[name] = sched_solver.last_quality, qcalls
        if sched_solver.last_route["path"] != route:
            raise AssertionError(f"world {name} took route {sched_solver.last_route}, not {route}")
        missing = [k for k in needed if world_launches[name][k] < 1]
        if missing:
            raise AssertionError(f"world {name} did not launch {missing}: {world_launches[name]}")
        scan_ops = rec["ffd_scan"][0]
        C_w, R_w = scan_ops[0].shape
        K_w = scan_ops[9].shape[0]
        doc = {"route": dict(sched_solver.last_route), "pods": len(pods_w),
               "c_pad": C_w, "k_pad": K_w, "real_classes": len(cases.real_classes(scan_ops)),
               "layout": ka.layout(G_MAX, K_w, R_w),
               "launches": world_launches[name], **accounted(result, pods_w)}
        if rec["disrupt_repack"]:
            S_w, N_w = rec["disrupt_repack"][0][4].shape
            doc["repack_shape"] = {"S": S_w, "C": rec["disrupt_repack"][0][2].shape[0], "N": N_w}
        world_docs[name] = doc
    # uncounted: the synchronous call the pipelined one must equal
    same_pipe = (sig(world_results["pipelined"])
                 == sig(sched_solver.schedule(sched(default_pools), pods1)) == sig(tick1))
    emit({"phase": "schedule", "g_max": G_MAX, "objective": "price", "worlds": world_docs,
          "spread_templates": N_SPREAD, "pipelined_equals_solve": same_pipe, **tag})
    if not same_pipe:
        raise AssertionError("schedule_begin/schedule_finish decided differently from "
                             "schedule or solve")
    three = world_docs["merged 3 pools"]
    # at g_max 1024 neither shared-memory layout holds a K=1920 carry
    if three["k_pad"] != 1920 or (G_MAX == 1024 and three["layout"] != "scratch"):
        raise AssertionError(f"the three-pool world did not run kernel A at K=1920 in the "
                             f"scratch layout: {three}")

    # -- quality: the fractional price bound behind every device solve ----------------
    def cpu_inputs(inp):
        return ffd.SolveInputs(*(t.cpu() for t in inp))

    def bound_against_cpu(call):
        """(equal at rel=1e-6, max relative difference) of the [R] totals
        the card computed against the same function on a CPU copy."""
        (inp, placed), kw, totals = call
        got = totals.cpu().double()
        want = price_bound.fractional_price_bound(cpu_inputs(inp), placed.cpu(), **kw).double()
        diff = (got - want).abs()
        rel = float((diff / want.abs()).nan_to_num(nan=0.0, posinf=math.inf).max())
        return bool(torch.all(diff <= 1e-6 * want.abs())), rel

    q_docs = {}
    for name, doc in quality_docs.items():
        calls = bound_calls[name]
        if doc is None or len(calls) != 1:
            raise AssertionError(f"{name}: no quality document or not one bound call ({len(calls)})")
        if doc.get("optimality_gap", 0.0) < 1.0:
            raise AssertionError(f"{name}: optimality gap below 1 under tier ffd: {doc}")
        equal, rel = bound_against_cpu(calls[0])
        if not equal:
            raise AssertionError(f"{name}: the bound on the card differs from the CPU copy ({rel})")
        bound_h, r_star = price_bound.fetch_bound(calls[0][2])
        q_docs[name] = {"optimality_gap": doc["optimality_gap"], "bound_per_h": doc["bound_per_h"],
                        "realized_per_h": doc["realized_per_h"],
                        "binding_resource": doc["binding_resource"], "groups": doc["groups"],
                        "bound_fetched": bound_h, "bound_max_rel_diff_vs_cpu": rel}
    # the bound's cost alone on tick 1's inputs: dispatch and fetch
    (inp_q, placed_q), kw_q, _ = bound_calls["tick 1"][0]
    placed_q = placed_q.cpu().numpy()

    def bound_once():
        return price_bound.fetch_bound(solver._dispatch_bound(
            inp_q, placed_q, kw_q["word_offsets"], kw_q["words"]))

    for _ in range(3):
        bound_once()
    cost = []
    for _ in range(30):
        t0 = time.perf_counter()
        bound_once()
        cost.append((time.perf_counter() - t0) * 1e3)
    bound_cost_ms = statistics.median(cost)
    placed_dev = bound_calls["tick 1"][0][0][1]
    bound_dev_ms = graph_device_ms(
        lambda: price_bound.fractional_price_bound(inp_q, placed_dev, **kw_q), reps=20)
    _, warm_tick1_ms = wall_ms(lambda: solver.solve(pool, items, pods1), reps=3)
    bound_share = bound_cost_ms / warm_tick1_ms
    emit({"phase": "quality", "ticks": q_docs,
          "bound_cost_ms_median_of_30": bound_cost_ms, "warm_tick1_ms_median_of_3": warm_tick1_ms,
          "bound_share_of_warm_tick": bound_share, "bound_budget_under_1pct_met": bound_share < 0.01,
          "bound_device_ms_graph_replay": bound_dev_ms, **tag})

    # -- convex: TorchSolver(tier="convex") on three worlds --------------------------
    shapes_adv = (("1100m", "2200Mi"), ("700m", "1400Mi"), ("1700m", "3400Mi"))
    # world -> (pods, the winner it must have)
    convex_spec = {
        "a: tick 1": (pods1, "ffd"),
        # bench.py's convex stage at 2,000 pods (--convex-only, BENCH_N_PODS=2000)
        "b: bench 2k": (workload.synth_pods(np.random.default_rng(42), workload.ZONES, 2_000,
                                            salt=99_000), "convex"),
        # tests/test_convex.py adversarial_pods(30)
        "c: adversarial": ([Pod(f"adv{i}", requests=Resources(
            {"cpu": shapes_adv[i % 3][0], "memory": shapes_adv[i % 3][1]})) for i in range(30)],
            "convex"),
    }
    cx_solver = TorchSolver(g_max=G_MAX, device=dev, tier="convex")
    cx_cpu = TorchSolver(g_max=G_MAX, device="cpu", tier="convex")
    ffd_solver = TorchSolver(g_max=G_MAX, device=dev)
    convex_docs, convex_ops, convex_launches = {}, {}, {}
    cpu_solves = [0]                   # the CPU copy's solves: plain by design
    for name, (pods_w, want_winner) in convex_spec.items():
        with recording(ka, kb) as rec, calls_of(relax, "convex_relax") as rcalls, \
                calls_of(price_bound, "fractional_price_bound") as qcalls:
            d0 = start_count()
            cx_solver.last_convex = cx_solver.last_quality = None
            result = cx_solver.solve(pool, items, pods_w)
            torch.cuda.synchronize()
            convex_launches[name] = {"ffd_scan": ka.launches, "disrupt_repack": kb.launches}
            end_count(f"convex {name}", convex_launches[name], d0)
        convex_ops[name] = rec
        lc, q = cx_solver.last_convex, cx_solver.last_quality
        if convex_launches[name]["ffd_scan"] < 1 or len(rcalls) != 1 or len(qcalls) != 1:
            raise AssertionError(f"convex {name}: kernel A, the relaxation or the bound did not "
                                 f"run once: {convex_launches[name]} {len(rcalls)} {len(qcalls)}")
        if lc is None or q is None:
            raise AssertionError(f"convex {name}: no last_convex or last_quality")
        chosen = lc["price_convex"] if lc["winner"] == "convex" else lc["price_ffd"]
        if not chosen <= lc["price_ffd"]:
            raise AssertionError(f"convex {name}: the chosen price is above FFD's: {lc}")
        if not 1 <= lc["iterations"] <= relax.DEFAULT_ITERS:
            raise AssertionError(f"convex {name}: iterations out of range: {lc}")
        if want_winner is not None and lc["winner"] != want_winner:
            raise AssertionError(f"convex {name}: winner {lc['winner']}, not {want_winner}: {lc}")
        # the same solver on the CPU (the plain versions), and the
        # relaxation on a CPU copy of the card's inputs
        cpu_result = cx_cpu.solve(pool, items, pods_w)
        cpu_solves[0] += 1
        lc_cpu = cx_cpu.last_convex
        same_decisions = sig(cpu_result) == sig(result)
        same_convex = all(lc[k] == lc_cpu[k] for k in ("winner", "price_ffd", "price_convex",
                                                       "iterations"))
        (inp_x,), kw_x, out_x = rcalls[0]
        x_card, lower_card, trace_card = relax.fetch_relax(out_x)
        x_cpu, lower_cpu, trace_cpu = relax.fetch_relax(relax.convex_relax(cpu_inputs(inp_x), **kw_x))
        x_err = float(np.abs(x_card - x_cpu).max())
        lower_err = abs(lower_card - lower_cpu)
        trace_err = float(np.abs(trace_card - trace_cpu).max())
        bound_equal, bound_rel = bound_against_cpu(qcalls[0])
        convex_docs[name] = {
            "pods": len(pods_w), "c_pad": int(inp_x.req.shape[0]), "k_pad": int(inp_x.cap.shape[0]),
            "iters": kw_x["iters"], "last_convex": lc, "last_convex_cpu": lc_cpu,
            "chosen_price": chosen, "optimality_gap": q.get("optimality_gap"),
            "bound_per_h": q.get("bound_per_h"), "realized_per_h": q.get("realized_per_h"),
            "launches": convex_launches[name], "decisions_equal_cpu": same_decisions,
            "last_convex_equal_cpu": same_convex, "x_max_abs_diff_vs_cpu": x_err,
            "lower_abs_diff_vs_cpu": lower_err, "trace_max_abs_diff_vs_cpu": trace_err,
            "bound_max_rel_diff_vs_cpu": bound_rel, **accounted(result, pods_w)}
        if not (same_decisions and same_convex):
            raise AssertionError(f"convex {name}: the card decided differently from the CPU: "
                                 f"{lc} {lc_cpu}")
        if x_err > 5e-5 or lower_err > 5e-5 * max(lower_cpu, 1.0) or not bound_equal:
            raise AssertionError(f"convex {name}: x, lower or the bound off the CPU's: "
                                 f"{x_err} {lower_err} {bound_rel}")
        # times: the convex tick against the FFD tick (bench.py's
        # convex_tick_overhead), and the convex stages of a warm tick
        reps = 3 if len(pods_w) > 10_000 else 5
        _, ffd_ms = wall_ms(lambda: ffd_solver.solve(pool, items, pods_w), reps=reps)
        _, cx_ms = wall_ms(lambda: cx_solver.solve(pool, items, pods_w), reps=reps)
        stage_runs = []
        for _ in range(3):
            with fn_timer([(relax, "convex_relax", "relax_enqueue"),
                           (relax, "fetch_relax", "relax_fetch"),
                           (rounding, "round_solution", "rounding"),
                           (convex_tier, "choose", "choose"),
                           (price_bound, "fractional_price_bound", "bound_enqueue"),
                           (price_bound, "fetch_bound", "bound_fetch")]) as t:
                cx_solver.solve(pool, items, pods_w)
                torch.cuda.synchronize()
            stage_runs.append(t)
        relax_dev = graph_device_ms(lambda: relax.convex_relax(inp_x, **kw_x), reps=10)
        _, ffd_busy = device_busy_ms(lambda: ffd_solver.solve(pool, items, pods_w))
        _, cx_busy = device_busy_ms(lambda: cx_solver.solve(pool, items, pods_w))
        convex_docs[name]["times"] = {
            "ffd_tick_ms_median": ffd_ms, "convex_tick_ms_median": cx_ms,
            "convex_tick_overhead": cx_ms / ffd_ms,
            "stages_ms_median_of_3": {k: statistics.median(r[k] for r in stage_runs)
                                      for k in stage_runs[0]},
            "relax_device_ms_graph_replay": relax_dev,
            "ffd_tick_device_busy_ms": ffd_busy, "convex_tick_device_busy_ms": cx_busy,
            "ffd_tick_device_idle_share": None if ffd_busy is None else 1 - ffd_busy / ffd_ms,
            "convex_tick_device_idle_share": None if cx_busy is None else 1 - cx_busy / cx_ms}
    emit({"phase": "convex", "entry": "TorchSolver(tier='convex').solve", "g_max": G_MAX,
          "worlds": convex_docs,
          "stages_note": "host clock, median of 3 warm ticks; relax_fetch waits for the device; "
                         "relax_device_ms_graph_replay: CUDA events around a replay of the "
                         "relaxation captured in a CUDA graph, median of 10; device busy: "
                         "kernels and copies torch.profiler records over a warm tick, median "
                         "of 3, idle share against the unprofiled median wall", **tag})

    # -- consolidate: DisruptEngine.evaluate on four sweeps --------------------------
    bench_spec = workload.bench_sweep_spec()
    ramp_spec = workload.rampdown_sweep_spec(tick1, np.random.default_rng(SEED + 3))
    steady_spec = workload.rampdown_sweep_spec(tick1, np.random.default_rng(SEED + 3), keep=1.0)
    # sweep -> (spec, pools)
    sweep_spec = {
        "bench-sweep": (bench_spec, "default"),
        "rampdown-sweep default": (ramp_spec, "default"),
        "rampdown-sweep spot-od": (ramp_spec, "spot-od"),
        "steady-sweep spot-od": (steady_spec, "spot-od"),
    }
    by_name = {it.name: it for it in items}

    def node_price(labels) -> float:
        """The hourly price of a node's own offering; 0.0 for a node that
        names no catalog type (bench-sweep's nodes): then only `delete`
        beats its budget."""
        it = by_name.get(labels.get(wk.INSTANCE_TYPE_LABEL))
        for o in (it.offerings if it is not None else ()):
            if (o.zone, o.capacity_type) == (labels.get(wk.ZONE_LABEL),
                                             labels.get(wk.CAPACITY_TYPE_LABEL)):
                return o.price
        return 0.0

    sweeps = {}
    for name, (spec, kind) in sweep_spec.items():
        nodes_s, sets_s = workload.sweep_world(spec)
        pools_s, ovh_s = workload.sweep_pools(kind)
        price_of = {n[0]: node_price(n[1]) for n in spec["nodes"]}
        sweeps[name] = {
            "nodes": nodes_s, "sets": sets_s,
            "budgets": [sum(price_of[c] for c in excluded) for _, excluded in sets_s],
            "kw": dict(pools=pools_s, catalogs={p.name: items for p in pools_s},
                       daemon_overhead=ovh_s),
        }

    def well_formed(v, n_pods, pools_s) -> bool:
        infinite = math.isinf(v.replace_price) and math.isinf(v.replace_od_price)
        if v.can_delete:
            return v.leftover == 0 and infinite and v.replace_type is None and v.nodepool is None
        if not 0 < v.leftover <= n_pods:
            return False
        if math.isfinite(v.replace_price):
            return (v.replace_od_price >= v.replace_price and v.replace_type in by_name
                    and v.nodepool in {p.name for p in pools_s})
        return infinite and v.replace_type is None and v.nodepool is None

    engine = DisruptEngine(solver=solver)
    sweep_results, sweep_ops, sweep_launches, sweep_docs = {}, {}, {}, {}
    for name, sw in sweeps.items():
        with recording(ka, kb) as rec:
            d0 = start_count()
            dk.replace_calls = 0
            verdicts = engine.evaluate(sw["nodes"], sw["sets"], **sw["kw"])
            torch.cuda.synchronize()
            sweep_launches[name] = {"disrupt_repack": kb.launches, "ffd_scan": ka.launches,
                                    "disrupt_replace": dk.replace_calls}
            end_count(name, sweep_launches[name], d0)
        sweep_results[name], sweep_ops[name] = verdicts, rec
        if kb.launches != 1 or len(rec["disrupt_repack"]) != 1:
            raise AssertionError(f"sweep {name} did not launch kernel B once: {sweep_launches[name]}")
        ops = rec["disrupt_repack"][0]
        (S_s, N_s), C_s = ops[4].shape, ops[2].shape[0]
        want_shape = (encode.bucket(len(sw["sets"])), encode.bucket(len(sw["nodes"]), lo=16))
        if (S_s, N_s) != want_shape:
            raise AssertionError(f"sweep {name}: kernel B at S={S_s}, N={N_s}, not {want_shape}")
        bad = [i for i, (v, (pods_i, _)) in enumerate(zip(verdicts, sw["sets"]))
               if not well_formed(v, len(pods_i), sw["kw"]["pools"])]
        if len(verdicts) != len(sw["sets"]) or bad:
            raise AssertionError(f"sweep {name}: malformed verdicts at sets {bad[:10]}")
        actions = collections.Counter(v.action(b) for v, b in zip(verdicts, sw["budgets"]))
        sweep_docs[name] = {
            "sets": len(sw["sets"]), "candidates": sum(len(x) == 1 for _, x in sw["sets"]),
            "nodes": len(sw["nodes"]),
            # a candidate's pods appear in every set that holds it
            "pod_entries": sum(len(p) for p, _ in sw["sets"]),
            "repack_shape": {"S": S_s, "C": C_s, "N": N_s, "R": ops[2].shape[1]},
            "feasible_classes": int(ops[1].any(1).sum()), "launches": sweep_launches[name],
            "actions": {a: actions.get(a, 0) for a in ("delete", "replace-cheaper", "blocked")},
            "replacement_pools": dict(collections.Counter(
                v.nodepool for v in verdicts if v.nodepool is not None)),
            "first_sweep_ms": engine.last_dispatch["ms"],
        }
    emit({"phase": "consolidate", "entry": "DisruptEngine(solver=TorchSolver).evaluate",
          "sweeps": sweep_docs, **tag})

    # -- observe: metrics, failpoints, tracing and the observatory ---------------------
    # the no-fallback witness over every phase above: no device failure took
    # a degrade rung, and the dispatch counter agrees with the launch counts
    impl = "cuda" if dev.type == "cuda" else "plain"
    other = "plain" if impl == "cuda" else "cuda"
    # kernel B's runs: the solver's count plus the engine's local dispatches
    runs_off = [r["path"] for r in counted_runs if any(
        r["dispatches"][f"{k}/{impl}"] + (r["dispatches"]["disrupt_repack/engine"]
                                          if k == "disrupt_repack" else 0) != r["launches"][k]
        or r["dispatches"][f"{k}/{other}"] for k in DISPATCH_ENTRIES)]
    dispatches = dispatch_counts(metrics)
    witness = {
        "convex_fallbacks": {r: metrics.CONVEX_FALLBACKS.value(reason=r)
                             for r in ("dispatch", "rounding")},
        "rounding_returned_none": rounding_none[0],
        "handled_errors": {s: metrics.HANDLED_ERRORS.value(site=s) for s in QUALITY_SITES},
        "kernel_dispatches": dispatches,
        "counted_runs": len(counted_runs),
        "counted_launches": {k: sum(r["launches"][k] for r in counted_runs) for k in DISPATCH_ENTRIES},
        "counted_dispatches": {key: sum(r["dispatches"][key] for r in counted_runs)
                               for key in dispatch_counts(metrics)},
        "cpu_copy_solves": cpu_solves[0], "runs_off": runs_off}
    # on the card the only plain runs are the convex phase's CPU copy
    plain_ok = impl == "plain" or (dispatches["ffd_scan/plain"] == cpu_solves[0]
                                   and dispatches["disrupt_repack/plain"] == 0)
    witness_ok = (
        witness["convex_fallbacks"]["dispatch"] == 0
        and witness["convex_fallbacks"]["rounding"] == rounding_none[0]
        and not any(witness["handled_errors"].values()) and not runs_off and plain_ok)

    # drills on the card: each drilled tick is the FFD tick, its counter
    # moves by exactly one, and the next, disarmed tick decides as before
    real_bound = price_bound.fractional_price_bound

    def broken_bound(*a, **k):
        raise RuntimeError("drill: the quality bound raises")

    def counter(kind, label) -> float:
        if kind == "fallback":
            return metrics.CONVEX_FALLBACKS.value(reason=label)
        return metrics.HANDLED_ERRORS.value(site=label)

    # drill -> (failpoint spec or None for the patched bound, counter, solver)
    drill_spec = {
        "convex.rounding": ("convex.rounding=error(RuntimeError):times=1",
                            ("fallback", "rounding"), cx_solver),
        "rpc.convex.dispatch": ("rpc.convex.dispatch=error(RuntimeError):times=1",
                                ("fallback", "dispatch"), cx_solver),
        "bound raises": (None, ("handled", "solver.quality_dispatch"), ffd_solver),
    }
    drills, drills_ok = {}, True
    for world_name in ("a: tick 1", "c: adversarial"):
        pods_w = convex_spec[world_name][0]
        ffd_sig = sig(ffd_solver.solve(pool, items, pods_w))
        ref_sig = sig(cx_solver.solve(pool, items, pods_w))
        ref_lc = dict(cx_solver.last_convex)
        organic_none = math.isinf(ref_lc["price_convex"])
        for drill, (spec, (kind, label), drill_solver) in drill_spec.items():
            site = spec.split("=")[0] if spec else None
            c0 = counter(kind, label)
            f0 = metrics.FAILPOINT_FIRES.value(site=site, action="error") if site else 0.0
            if spec:
                failpoints.FAILPOINTS.arm_spec(spec)
            else:
                price_bound.fractional_price_bound = broken_bound
            try:
                drilled = drill_solver.solve(pool, items, pods_w)
                torch.cuda.synchronize()
            finally:
                failpoints.FAILPOINTS.reset()
                price_bound.fractional_price_bound = real_bound
            moved = counter(kind, label) - c0
            fired = (metrics.FAILPOINT_FIRES.value(site=site, action="error") - f0) if site else 0.0
            q_drilled = dict(drill_solver.last_quality or {})
            c1 = counter(kind, label)
            again = drill_solver.solve(pool, items, pods_w)
            torch.cuda.synchronize()
            moved_again = counter(kind, label) - c1
            organic = int(organic_none) if drill == "convex.rounding" else 0
            if drill_solver is cx_solver:
                next_ok = sig(again) == ref_sig and cx_solver.last_convex["winner"] == ref_lc["winner"]
            else:
                next_ok = sig(again) == ffd_sig and "optimality_gap" in drill_solver.last_quality
            doc = {"drilled_equals_ffd_tick": sig(drilled) == ffd_sig, "counter_moved": moved,
                   "failpoint_fires": fired, "next_tick_as_before": next_ok,
                   "counter_moved_next_tick": moved_again, "organic_next_tick": organic,
                   "gap_in_drilled_tick": q_drilled.get("optimality_gap")}
            drills[f"{world_name} / {drill}"] = doc
            drills_ok &= (doc["drilled_equals_ffd_tick"] and moved == 1
                          and fired == (1 if site else 0) and next_ok and moved_again == organic)

    # hbm: the observatory's poll against torch.cuda's own figures, read at
    # the same point after tick 1
    solver.solve(pool, items, pods1)
    torch.cuda.synchronize()
    snap = hbm.poll(max_age_s=0)
    cuda_figures = {"memory_allocated": torch.cuda.memory_allocated(0),
                    "max_memory_allocated": torch.cuda.max_memory_allocated(0),
                    "mem_get_info_total": torch.cuda.mem_get_info(0)[1]}
    dev_snap = snap["devices"].get("cuda:0", {})
    hbm_doc = {"poll": snap, "torch_cuda": cuda_figures,
               "staged_bytes_by_kind": solver.staged_bytes_by_kind(),
               "equal": (dev_snap.get("bytes_in_use") == cuda_figures["memory_allocated"]
                         and dev_snap.get("peak_bytes") == cuda_figures["max_memory_allocated"]
                         and dev_snap.get("bytes_limit") == cuda_figures["mem_get_info_total"])}

    with tempfile.TemporaryDirectory(prefix="karpenter-observe-") as tmp:
        # flight and cost: warm tick-1 walls with tracing and the observatory
        # on (a traced tick, the idle profiler's bracket, the flight record
        # with its hbm poll) against off, in turns
        prof = profiler.PROFILER
        flight.RECORDER.clear()
        tracing.TRACER.configure(enabled=True, sample=1.0)

        def observed_tick():
            t_mono = time.monotonic()
            prof.on_tick_start()
            with tracing.trace("tick") as root:
                solver.solve(pool, items, pods1)
            prof.on_tick_end()
            flight.record(flight.build_tick_record(root, t_mono, solver=solver))

        walls = {"on": [], "off": []}
        for turn in ("off", "on", "on", "off", "off", "on", "on", "off", "off", "on"):
            t0 = time.perf_counter()
            observed_tick() if turn == "on" else solver.solve(pool, items, pods1)
            torch.cuda.synchronize()
            walls[turn].append((time.perf_counter() - t0) * 1e3)
        tracing.TRACER.configure(enabled=False)
        records = flight.RECORDER.dump()["records"]
        box = flight.flush_blackbox("manual", path=os.path.join(tmp, "flightdata.jsonl"))
        with open(box) as f:
            box_lines = sum(1 for _ in f)
        flight_doc = {"records": len(records), "blackbox_lines": box_lines,
                      "stages_ms": [r.get("stages_ms") for r in records],
                      "last": {k: v for k, v in records[-1].items() if k != "stages_ms"}}

        # profiler: a capture armed for two warm ticks, then three warm
        # ticks with it stopped
        prof.request(2, out_dir=tmp)
        for _ in range(2):
            prof.on_tick_start()
            solver.solve(pool, items, pods1)
            torch.cuda.synchronize()
            prof.on_tick_end()
        _, after_capture_ms = wall_ms(lambda: solver.solve(pool, items, pods1), reps=3)
        prof_state = prof.describe()
        trace_path = os.path.join(prof_state["last_trace_dir"] or tmp, profiler.TRACE_FILE)
        with open(trace_path) as f:
            events = json.load(f).get("traceEvents", [])
        kernel_names = collections.Counter(
            e.get("name", "") for e in events if e.get("cat") == "kernel")
        prof_doc = {"captures": prof_state["captures"], "errors": prof_state["errors"],
                    "trace_bytes": os.path.getsize(trace_path), "events": len(events),
                    "kernel_events": sum(kernel_names.values()),
                    "kernel_a_events": sum(n for name, n in kernel_names.items()
                                           if "ffd_scan_kernel" in name),
                    "tick1_wall_ms_median_of_3_after_capture": after_capture_ms}
    flight_ok = (len(records) == 5 and box_lines == 6 and all(
        {"encode", "device", "decode"} <= set(r.get("stages_ms", {})) for r in records))
    cost = {"tick1_wall_ms_median_on": statistics.median(walls["on"]),
            "tick1_wall_ms_median_off": statistics.median(walls["off"]),
            "walls_ms": walls}
    cost["overhead"] = cost["tick1_wall_ms_median_on"] / cost["tick1_wall_ms_median_off"] - 1

    # the sync witness on warm ticks 1 and 2 and one sweep
    sweep_w = sweeps["rampdown-sweep spot-od"]
    sync_witness.reset()
    with sync_witness.hot("warm ticks 1, 2 and a sweep"):
        solver.solve(pool, items, pods1)
        solver.solve(pool, items, pods2, existing_nodes=nodes)
        engine.evaluate(sweep_w["nodes"], sweep_w["sets"], **sweep_w["kw"])
        torch.cuda.synchronize()
    sync = sync_witness.stats()

    emit({"phase": "observe", "no_fallback_witness": witness, "witness_ok": witness_ok,
          "drills": drills, "hbm": hbm_doc, "profiler": prof_doc, "flight": flight_doc,
          "cost": cost, "sync_witness": sync,
          "kernel_dispatches_after": dispatch_counts(metrics), **tag})
    if not witness_ok:
        raise AssertionError(f"a degrade rung or a plain run on the main path: {witness}")
    if not drills_ok:
        raise AssertionError(f"a drill did not take its rung, count once and recover: {drills}")
    if not hbm_doc["equal"]:
        raise AssertionError(f"hbm.poll differs from torch.cuda's figures: {hbm_doc}")
    if prof_doc["captures"] != 1 or not prof_doc["trace_bytes"] or not prof_doc["kernel_a_events"]:
        raise AssertionError(f"the profiler capture missed kernel A: {prof_doc}")
    if not flight_ok:
        raise AssertionError(f"not one flight record with stages per tick: {flight_doc}")
    if sync["sanctioned_fetches"] < 1:
        raise AssertionError(f"the sync witness saw no sanctioned fetch: {sync}")
    if sync["unsanctioned"]:
        raise AssertionError(f"the tick waited for the card outside its fetches: {sync}")

    # -- coldstart: tick 1 of a fresh process, empty store then warm ---------------
    phase_coldstart(tag)

    # -- wire: the solver sidecar ---------------------------------------------------
    # the real entry point in a subprocess (tick 1, the byte and staging
    # figures, the breaker drill) and a server thread inside this script
    # (its launches counted here and its kernels' operands recorded), the
    # latter over the shm ring and over the socket
    from karpenter_tpu_torch.solver import rpc
    from karpenter_tpu_torch.solver.breaker import CircuitBreaker

    wire_dir = tempfile.mkdtemp(prefix="kt-")
    sub_sock = os.path.join(wire_dir, "sub.sock")
    sub_log = os.path.join(wire_dir, "sub.log")
    procs = []

    def start_sidecar():
        log = open(sub_log, "ab")
        proc = subprocess.Popen(
            [sys.executable, "-m", "karpenter_tpu_torch.solver.rpc", "--socket", sub_sock,
             "--device", DEVICE],
            cwd=os.path.dirname(os.path.abspath(__file__)), stdout=log, stderr=log)
        log.close()
        procs.append(proc)
        t0 = time.perf_counter()
        while True:
            if proc.poll() is not None:
                with open(sub_log) as f:
                    raise AssertionError(f"the sidecar exited {proc.returncode}: {f.read()[-2000:]}")
            probe = rpc.SolverClient(path=sub_sock, timeout=5.0, connect_timeout=1.0, shm=False,
                                     track_transport=False)
            try:
                if probe.ping():
                    return proc, time.perf_counter() - t0
            except OSError:
                pass
            finally:
                probe.close()
            if time.perf_counter() - t0 > 180:
                raise AssertionError("the sidecar did not answer ping within 180 s")
            time.sleep(0.2)

    def ping_ms(client, n=50):
        client.ping()
        times = []
        for _ in range(n):
            t0 = time.perf_counter()
            client.ping()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    def norm_convex(lc):
        """last_convex on the keys both forms carry (a wire tick's also
        has `fallback`; its price_convex is None where in process it is
        inf)."""
        pc = lc["price_convex"]
        return {"winner": lc["winner"], "iterations": lc["iterations"],
                "price_ffd": lc["price_ffd"],
                "price_convex": math.inf if pc is None else pc, "lower": lc["lower"]}

    def wire_counts():
        return {"to_open": metrics.BREAKER_TRANSITIONS.value(to="open"),
                "short_circuits": metrics.BREAKER_SHORT_CIRCUITS.value(),
                "handled_errors": (metrics.HANDLED_ERRORS.value(site="solver.wire_down")
                                   + metrics.HANDLED_ERRORS.value(site="solver.breaker_open")),
                "rpc_down": metrics.SOLVER_PIPELINE_FALLBACKS.value(reason="rpc-down")}

    def wire_bytes():
        return {f"{d}/{t}": metrics.WIRE_BYTES.value(direction=d, transport=t)
                for d in ("sent", "received") for t in ("shm", "tcp")}

    def server_stages(solver_w, fn):
        """The server's echoed stages of one traced tick (the `device` and
        `fetch` spans grafted under the client's `wire` span)."""
        tracing.TRACER.configure(enabled=True, sample=1.0)
        try:
            with tracing.trace("tick") as root:
                fn()
        finally:
            tracing.TRACER.configure(enabled=False)
        wire_sp = [c for c in root.children if c.name == "wire"]
        if not wire_sp:
            raise AssertionError("no wire span in a wire tick")
        return {g.name: g.attributes["server_dur_ms"] for g in wire_sp[0].children
                if g.attributes.get("remote")}

    clean0 = wire_counts()
    # in-process references not computed above (uncounted)
    tainted_pools = [
        NodePool(name, weight=weight,
                 requirements=[Requirement(wk.CAPACITY_TYPE_LABEL, "In", [name])])
        for name, weight in ((wk.CAPACITY_TYPE_SPOT, 100), (wk.CAPACITY_TYPE_ON_DEMAND, 10))
    ]
    tainted_pools[1].template.taints = [Taint("dedicated", "NoSchedule", "")]
    ref_solver = TorchSolver(g_max=G_MAX, device=dev)
    ref_tainted = ref_solver.schedule(sched(tainted_pools), pods1)
    ref_tainted_route = dict(ref_solver.last_route)
    ref_merged_route = world_docs["merged"]["route"]
    ref_cx = cx_solver.solve(pool, items, pods1)
    ref_cx_lc = norm_convex(cx_solver.last_convex)
    # tick 1 with ~5 % of its pods replaced: the same classes with a few
    # counts moved, which ships as solve_delta
    by_class = sorted(encode.group_pods(pods1), key=lambda pc: -len(pc.pods))
    n_rep = len(pods1) // 20
    drop = {id(p) for pc in by_class[:2] for p in pc.pods[: n_rep // 2]}
    extra = []
    for i in range(len(drop)):
        src = by_class[2].pods[i % len(by_class[2].pods)]
        q = copy.copy(src)
        q.metadata = dataclasses.replace(src.metadata, name=f"{src.metadata.name}-r{i}")
        extra.append(q)
    pods_delta = [p for p in pods1 if id(p) not in drop] + extra
    ref_delta = solver.solve(pool, items, pods_delta)
    wire_sweep = sweeps["rampdown-sweep spot-od"]
    ref_sweep = [repr(v) for v in sweep_results["rampdown-sweep spot-od"]]

    # 1. the real entry point: python -m karpenter_tpu_torch.solver.rpc
    proc, sub_start_s = start_sidecar()
    sub_client = rpc.SolverClient(path=sub_sock, timeout=120.0)
    sub_breaker = CircuitBreaker(failure_threshold=2, backoff_base=1000.0,
                                 rng=np.random.default_rng(SEED).random)
    sub_solver = TorchSolver(g_max=G_MAX, device=dev, client=sub_client, breaker=sub_breaker)
    b0 = wire_bytes()
    sub_tick1 = sub_solver.solve(pool, items, pods1)
    b1 = wire_bytes()
    if sig(sub_tick1) != sig(tick1):
        raise AssertionError("the sidecar subprocess decided tick 1 unlike the in-process tick")
    sub_tick2 = sub_solver.solve(pool, items, pods2, existing_nodes=nodes)
    b2 = wire_bytes()
    if sig(sub_tick2) != sig(tick2):
        raise AssertionError("the sidecar subprocess decided tick 2 unlike the in-process tick")
    sub_debug = sub_client.debug_info()
    sub_doc = {
        "start_to_ping_s": sub_start_s, "transport": "shm" if sub_client._ring is not None else "tcp",
        "ping_ms_median_of_50": ping_ms(sub_client),
        "bytes_tick1": {k: b1[k] - b0[k] for k in b0}, "bytes_tick2": {k: b2[k] - b1[k] for k in b1},
        "last_reply_tick2": dict(sub_client.last_reply), "last_delta_tick2": dict(sub_client.last_delta),
        "server_staged_bytes": sub_debug["staged_bytes"], "tick1_equal": True, "tick2_equal": True}

    # 2. a server thread inside the script, over the ring and the socket
    thr_sock = os.path.join(wire_dir, "thr.sock")
    thr = rpc.SolverServer(path=thr_sock, device=dev).start()
    wire_docs, wire_launches, wire_ops = {}, {}, {}
    for transport in ("shm", "tcp"):
        client = rpc.SolverClient(path=thr_sock, timeout=120.0, shm=transport == "shm")
        brk = CircuitBreaker(failure_threshold=2, backoff_base=1000.0,
                             rng=np.random.default_rng(SEED).random)
        w_solver = TorchSolver(g_max=G_MAX, device=dev, client=client, breaker=brk)
        w_cx = TorchSolver(g_max=G_MAX, device=dev, tier="convex", client=client, breaker=False)
        w_engine = DisruptEngine(solver=w_solver)

        def counted(name, fn, needed):
            with recording(ka, kb) as rec:
                ka.launches = kb.launches = 0
                out = fn()
                torch.cuda.synchronize()
                launches = {"ffd_scan": ka.launches, "disrupt_repack": kb.launches}
            missing = [k for k in needed if launches[k] < 1]
            if missing:
                raise AssertionError(f"wire {transport} {name} did not launch {missing}: {launches}")
            wire_launches[f"{transport} {name}"] = launches
            wire_ops[f"{transport} {name}"] = rec
            return out

        checks_w = {}
        r = counted("tick 1", lambda: w_solver.solve(pool, items, pods1), ("ffd_scan",))
        checks_w["tick 1"] = sig(r) == sig(tick1)
        # right behind tick 1, whose class epoch it patches
        r = counted("delta tick", lambda: w_solver.solve(pool, items, pods_delta), ("ffd_scan",))
        delta_doc = dict(client.last_delta)
        checks_w["delta tick"] = sig(r) == sig(ref_delta) and delta_doc["mode"] == "delta"
        r = counted("tick 2", lambda: w_solver.solve(pool, items, pods2, existing_nodes=nodes),
                    ("ffd_scan", "disrupt_repack"))
        checks_w["tick 2"] = sig(r) == sig(tick2)
        r = counted("merged", lambda: w_solver.schedule(sched(spot_od), pods1), ("ffd_scan",))
        checks_w["merged"] = (sig(r) == sig(world_results["merged"])
                              and w_solver.last_route == ref_merged_route)
        r = counted("merged tainted", lambda: w_solver.schedule(sched(tainted_pools), pods1),
                    ("ffd_scan",))
        checks_w["merged tainted (join_allowed)"] = (
            sig(r) == sig(ref_tainted) and w_solver.last_route == ref_tainted_route
            and "join_allowed" in client.features())
        r = counted("convex a: tick 1", lambda: w_cx.solve(pool, items, pods1), ("ffd_scan",))
        lc_w = dict(w_cx.last_convex)
        checks_w["convex a: tick 1"] = sig(r) == sig(ref_cx) and norm_convex(lc_w) == ref_cx_lc
        r = counted("rampdown-sweep spot-od", lambda: w_engine.evaluate(
            wire_sweep["nodes"], wire_sweep["sets"], **wire_sweep["kw"]), ("disrupt_repack",))
        checks_w["rampdown-sweep spot-od"] = ([repr(v) for v in r] == ref_sweep
                                              and w_engine.last_dispatch["path"] == "wire")
        if not all(checks_w.values()):
            raise AssertionError(f"wire {transport}: a result differs from in process: {checks_w}")
        # times: warm tick walls over the wire against in process (median
        # of 3 each), the server's echoed stages, the sweep wire vs local
        walls = {}
        for tname, fn_w, fn_l in (
            ("tick 1", lambda: w_solver.solve(pool, items, pods1),
             lambda: solver.solve(pool, items, pods1)),
            ("tick 2", lambda: w_solver.solve(pool, items, pods2, existing_nodes=nodes),
             lambda: solver.solve(pool, items, pods2, existing_nodes=nodes)),
            ("sweep", lambda: w_engine.evaluate(wire_sweep["nodes"], wire_sweep["sets"],
                                                **wire_sweep["kw"]),
             lambda: engine.evaluate(wire_sweep["nodes"], wire_sweep["sets"],
                                     **wire_sweep["kw"])),
        ):
            _, wire_med = wall_ms(fn_w, reps=3)
            _, local_med = wall_ms(fn_l, reps=3)
            walls[tname] = {"wire_ms_median_of_3": wire_med, "in_process_ms_median_of_3": local_med}
        stages = {
            "tick 1": server_stages(w_solver, lambda: w_solver.solve(pool, items, pods1)),
            "tick 2": server_stages(w_solver, lambda: w_solver.solve(
                pool, items, pods2, existing_nodes=nodes)),
        }
        wire_docs[transport] = {
            "transport_in_use": "shm" if client._ring is not None else "tcp",
            "checks": checks_w, "ping_ms_median_of_50": ping_ms(client),
            "walls": walls, "server_stages_ms": stages, "delta": delta_doc,
            "last_convex": lc_w, "launches": {k: v for k, v in wire_launches.items()
                                              if k.startswith(transport)},
            "describe_wire": {k: v for k, v in w_solver.describe_wire().items()
                              if k in ("transport", "last_delta", "last_reply", "server")}}
        if wire_docs[transport]["transport_in_use"] != transport:
            raise AssertionError(f"the {transport} client negotiated "
                                 f"{wire_docs[transport]['transport_in_use']}")
        client.close()
    clean_moved = {k: v - clean0[k] for k, v in wire_counts().items()}
    if any(clean_moved.values()) or sub_breaker.trips:
        raise AssertionError(f"a breaker transition or a rung in the clean wire runs: {clean_moved}")

    # 3. the breaker drill on the subprocess sidecar
    proc.kill()
    proc.wait(timeout=30)
    drill_ticks = []
    for expect in ("rpc-down", "rpc-down", "breaker-open"):
        c0 = wire_counts()
        ka.launches = 0
        r = sub_solver.solve(pool, items, pods1)
        torch.cuda.synchronize()
        moved = {k: v - c0[k] for k, v in wire_counts().items()}
        drill_ticks.append({"expect": expect, "equal": sig(r) == sig(tick1), "moved": moved,
                            "state": sub_breaker.state, "kernel_a_launches": ka.launches})
    proc, restart_s = start_sidecar()
    promoted = sub_breaker.probe_now()
    c0 = wire_counts()
    ka.launches = 0
    r = sub_solver.solve(pool, items, pods1)
    moved = {k: v - c0[k] for k, v in wire_counts().items()}
    back_on_wire = bool(sub_client.debug_info()["staged_seqnums"])
    drill_ticks.append({"expect": "wire", "equal": sig(r) == sig(tick1), "moved": moved,
                        "state": sub_breaker.state, "kernel_a_launches_here": ka.launches})
    # each rung tick counts once, in the JAX package's families only
    # (karpenter_handled_errors_total has no rung site, as in the JAX package)
    want_moves = [
        {"to_open": 0, "short_circuits": 0, "handled_errors": 0, "rpc_down": 1},
        {"to_open": 1, "short_circuits": 0, "handled_errors": 0, "rpc_down": 1},
        {"to_open": 0, "short_circuits": 1, "handled_errors": 0, "rpc_down": 0},
        {"to_open": 0, "short_circuits": 0, "handled_errors": 0, "rpc_down": 0},
    ]
    drill_ok = (promoted and back_on_wire and all(t["equal"] for t in drill_ticks)
                and [t["moved"] for t in drill_ticks] == want_moves
                and [t["state"] for t in drill_ticks] == ["closed", "open", "open", "closed"]
                and all(t["kernel_a_launches"] == 1 for t in drill_ticks[:3])
                and drill_ticks[3]["kernel_a_launches_here"] == 0)
    sub_client.close()
    thr.stop()
    thr._thread.join(timeout=30)
    for p in procs:
        if p.poll() is None:
            p.terminate()
            try:
                p.wait(timeout=30)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait(timeout=30)
    shutil.rmtree(wire_dir, ignore_errors=True)
    emit({"phase": "wire", "entry": "python -m karpenter_tpu_torch.solver.rpc; "
          "TorchSolver(client=SolverClient); DisruptEngine over solve_disrupt",
          "subprocess": sub_doc, "thread_server": wire_docs, "clean_runs_moved": clean_moved,
          "breaker_drill": {"ticks": drill_ticks, "promoted": promoted,
                            "restart_to_ping_s": restart_s, "ok": drill_ok},
          "stages_note": "walls: host clock ending in a sync; server_stages_ms: the sidecar's "
                         "device and fetch stages of one traced tick, echoed in the reply",
          **tag})
    if not drill_ok:
        raise AssertionError(f"the breaker drill: {drill_ticks}")

    # -- the operator: the binary, the full-width world, the corpus ---------------
    operator_launches, operator_ops, operator_digests = phase_operator(
        dev, tag, metrics, ka, kb)
    # -- kube: the operator over the apiserver bus --------------------------------
    kube_launches, kube_ops, kube_digests = phase_kube(dev, tag, metrics, ka, kb)
    operator_launches.update(kube_launches)
    for kernel, rows in kube_ops.items():
        operator_ops[kernel].update(rows)

    # the main path's own kernel inputs: tick 1's scan, tick 2's repack
    classes1 = encode.group_pods(pods1, extra_requirements=pool.requirements())
    classes2 = encode.group_pods(pods2, extra_requirements=pool.requirements())
    entry = solver._catalog(items)
    cs1 = solver._encode(pool, entry, classes1, np.zeros(len(classes1), dtype=np.int64))

    def scan_ops(class_set, objective, packed, staged=entry.staged):
        inp = ffd.make_inputs_staged(staged, class_set, packed_masks=packed)
        return ffd.scan_operands(inp, entry.offsets, entry.words, objective)

    ops_a = scan_ops(cs1, "price", True)
    ops_b = solver._repack_operands(classes2, nodes)
    # tick 2's scan operands: counts net of the pre-pass (a kernel B launch
    # outside the counted main path), C bucketed to 128 with 63 padded rows
    placed2 = solver._pack_existing(classes2, nodes, SchedulingResult())
    ops_a2 = scan_ops(solver._encode(pool, entry, classes2, placed2), "price", True)
    # a C=256 class set: the same generator with 4,000 templates
    pods3 = workload.synth_pods(np.random.default_rng(SEED + 2), workload.ZONES, N_PODS, salt=3,
                                templates=4000)
    classes3 = encode.group_pods(pods3, extra_requirements=pool.requirements())
    ops_a3 = scan_ops(solver._encode(pool, entry, classes3, np.zeros(len(classes3), dtype=np.int64)),
                      "price", True)

    # -- times ----------------------------------------------------------------------
    def scan_ms(ops, g_max=G_MAX, objective="price"):
        return cuda_ms(lambda: ka.fused_scan(*ops, g_max=g_max, objective=objective), reps=20)

    def scan_plain_ms(ops):
        return cuda_ms(lambda: ka.fused_scan_reference(*ops, g_max=G_MAX, objective="price"),
                       reps=3, warmup=1, batch=1)

    ms_a, ms_a2 = scan_ms(ops_a), scan_ms(ops_a2)
    plain_a, plain_a2 = scan_plain_ms(ops_a), scan_plain_ms(ops_a2)
    ms_b = cuda_ms(lambda: kb.disrupt_repack(*ops_b), reps=50)
    plain_b = cuda_ms(lambda: kb.repack_reference(*ops_b), reps=5, warmup=1, batch=1)
    tick1_runs = wall_runs(lambda: solver.solve(pool, items, pods1), reps=5)
    tick1_first, tick1_ms = tick1_runs[0], statistics.median(tick1_runs)
    tick2_first, tick2_ms = wall_ms(
        lambda: solver.solve(pool, items, pods2, existing_nodes=nodes), reps=5)

    def stages(pods, existing) -> dict:
        """Milliseconds of each stage of one warm tick: solve_begin and
        solve_finish unrolled, host clock per stage; `solve_device` is the
        CUDA-event time from the first to the last kernel the fused solve
        enqueues (prologue, kernel A, epilogue, and any gaps between)."""
        t = {}
        t0 = time.perf_counter()
        classes = encode.group_pods(pods, extra_requirements=pool.requirements())
        t["group"] = (time.perf_counter() - t0) * 1e3
        placed = np.zeros(len(classes), dtype=np.int64)
        if existing:
            t0 = time.perf_counter()
            placed = solver._pack_existing(classes, existing, SchedulingResult())
            t["pack_existing"] = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        entry = solver._catalog(items)
        class_set = solver._encode(pool, entry, classes, placed)
        inp = ffd.make_inputs_staged(entry.staged, class_set, packed_masks=True)
        torch.cuda.synchronize()
        t["encode"] = (time.perf_counter() - t0) * 1e3
        nnz = ffd.nnz_budget(class_set.c_pad, G_MAX)
        ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        ev0.record()
        buf = ffd.ffd_solve_fused(inp, g_max=G_MAX, nnz_max=nnz, word_offsets=entry.offsets,
                                  words=entry.words, objective="price")
        ev1.record()
        host = ffd.fetch_fused(buf)
        t["solve_and_fetch"] = (time.perf_counter() - t0) * 1e3
        t["solve_device"] = ev0.elapsed_time(ev1)
        t0 = time.perf_counter()
        dense = ffd.expand_fused(host, class_set.c_pad, G_MAX, entry.tensors.k_pad,
                                 encode.Z_PAD, encode.CT, nnz)
        if dense is None:
            dense = ffd.solve_dense_tuple(inp, g_max=G_MAX, word_offsets=entry.offsets,
                                          words=entry.words, objective="price")
        solver._decode(pool, entry, class_set, dense, None, result=SchedulingResult(),
                       class_offset=placed)
        t["decode"] = (time.perf_counter() - t0) * 1e3
        return t

    def median_stages(pods, existing, reps=3) -> dict:
        runs = [stages(pods, existing) for _ in range(reps)]
        return {k: statistics.median(r[k] for r in runs) for k in runs[0]}

    stages1 = median_stages(pods1, ())
    stages2 = median_stages(pods2, nodes)

    # bounds from this run's inputs: bytes the function must read once and
    # write once; operations it cannot skip -- kernel A's price envelope
    # over every (real class, type) and the survivor-word join of every
    # open group at each real class's step; kernel B's fit over every
    # (set, class, node, axis)
    def scan_bound(ops, g_max=G_MAX, objective="price"):
        outs = ka.fused_scan(*ops, g_max=g_max, objective=objective)
        take = outs[0].cpu().numpy()
        # groups open after step c: every opened group takes a pod when it opens
        last = np.where((take > 0).any(axis=1),
                        take.shape[1] - np.argmax((take > 0)[:, ::-1], axis=1), 0)
        open_before = np.concatenate([[0], np.maximum.accumulate(last)[:-1]])
        real = cases.real_classes(ops)
        C, K = ops[0].shape[0], ops[9].shape[0]
        n_ops = len(real) * K * 6 + int(open_before[real].sum()) * (K // 32)
        # a no-op row is known by its compat and fresh words: of it only
        # those and its count are read (and its zero take row written)
        bytes_in = (len(real) * nbytes(t[0] for t in ops[:9])
                    + (C - len(real)) * nbytes(ops[i][0] for i in (1, 2, 6)) + nbytes(ops[9:]))
        return bound(bytes_in + nbytes(outs), n_ops)

    bound_a, by_a = scan_bound(ops_a)
    bound_a2, by_a2 = scan_bound(ops_a2)
    C, K = ops_a[0].shape[0], ops_a[9].shape[0]
    sweep = {}
    for g in (64, 256, 1024):
        b_ms, b_by = scan_bound(ops_a, g)
        sweep[f"G={g}"] = {"ms": scan_ms(ops_a, g), "bound_ms": b_ms, "bound_by": b_by}
    b_ms, b_by = scan_bound(ops_a3)
    sweep["C=256 world"] = {"ms": scan_ms(ops_a3), "bound_ms": b_ms, "bound_by": b_by,
                            "real_classes": len(cases.real_classes(ops_a3))}

    def survivors(ops, objective):
        """(median, max) surviving types over the groups the scan opened."""
        _, _, n_open, gmask_bits, _ = ka.fused_scan(*ops, g_max=G_MAX, objective=objective)
        n = packing.unpack_rows(gmask_bits[: int(n_open)], ops[9].shape[0]).sum(1)
        return float(n.float().median()), int(n.max())

    # the fit objective keeps every compatible type in a fresh group (as a
    # zone-spread sub-class does): kernel A with wide groups at tick 1
    ops_fit = scan_ops(cs1, "fit", True)
    b_ms, b_by = scan_bound(ops_fit, objective="fit")
    sweep["G=1024"]["group_types_median_max"] = survivors(ops_a, "price")
    sweep["tick 1, fit objective"] = {
        "ms": scan_ms(ops_fit, objective="fit"), "bound_ms": b_ms, "bound_by": b_by,
        "group_types_median_max": survivors(ops_fit, "fit")}

    def repack_bound(ops):
        outs = kb.disrupt_repack(*ops)
        S, _ = ops[4].shape
        R = ops[2].shape[1]
        # a class with an empty feasibility row reads no request and fits nowhere
        feasible = ops[1].to(torch.bool)
        idle = int((~feasible.any(1)).sum())
        return bound(nbytes(ops) - idle * nbytes([ops[2][0]]) + nbytes(outs),
                     S * int(feasible.sum()) * (3 * R + 4))

    bound_b, by_b = repack_bound(ops_b)
    S, N = ops_b[4].shape
    Cb, R = ops_b[2].shape

    # every shape the main path gave each kernel: name -> (operands, launches)
    shapes_a = {"tick 1": (ops_a, launches1["ffd_scan"]), "tick 2": (ops_a2, launches2["ffd_scan"])}
    shapes_b = {"tick 2": (ops_b, launches2["disrupt_repack"])}
    for name in world_spec:
        shapes_a[name] = (world_ops[name]["ffd_scan"][0], world_launches[name]["ffd_scan"])
        if world_ops[name]["disrupt_repack"]:
            shapes_b[name] = (world_ops[name]["disrupt_repack"][0],
                              world_launches[name]["disrupt_repack"])
    for name in sweeps:
        shapes_b[name] = (sweep_ops[name]["disrupt_repack"][0], sweep_launches[name]["disrupt_repack"])
    for name in convex_spec:
        shapes_a[f"convex {name}"] = (convex_ops[name]["ffd_scan"][0], convex_launches[name]["ffd_scan"])
    # the sidecar's launches in phase `wire`, per op, over both transports
    for name, op in (("tick 1", "solve_delta (tick 1, full ship)"),
                     ("delta tick", "solve_delta (5 % replaced)"),
                     ("tick 2", "solve_delta (tick 2)"),
                     ("merged tainted", "solve_delta (merged, tainted on-demand)"),
                     ("convex a: tick 1", "solve_convex (a)")):
        shapes_a[f"wire {op}"] = (wire_ops[f"shm {name}"]["ffd_scan"][-1], sum(
            wire_launches[f"{t} {name}"]["ffd_scan"] for t in ("shm", "tcp")))
    shapes_a.update(operator_ops["ffd_scan"])
    shapes_b.update(operator_ops["disrupt_repack"])
    shapes_b["wire solve_disrupt (rampdown-sweep spot-od)"] = (
        wire_ops["shm rampdown-sweep spot-od"]["disrupt_repack"][0],
        sum(wire_launches[f"{t} rampdown-sweep spot-od"]["disrupt_repack"] for t in ("shm", "tcp")))
    shape_rows = {"ffd_scan": [], "disrupt_repack": []}
    for name, (ops, n) in shapes_a.items():
        if name == "tick 1":
            ms, plain, (b_ms, b_by) = ms_a, plain_a, (bound_a, by_a)
        elif name == "tick 2":
            ms, plain, (b_ms, b_by) = ms_a2, plain_a2, (bound_a2, by_a2)
        else:
            ms, plain, (b_ms, b_by) = scan_ms(ops), scan_plain_ms(ops), scan_bound(ops)
        C_s, R_s = ops[0].shape
        K_s = ops[9].shape[0]
        shape_rows["ffd_scan"].append({
            "path": name, "shape": {"C": C_s, "G": G_MAX, "K": K_s, "R": R_s},
            "real_classes": len(cases.real_classes(ops)),
            "layout": ka.layout(G_MAX, K_s, R_s),
            # kernel A walks each open group's survivors at every later
            # step, one thread per group
            "group_types_median_max": survivors(ops, "price"),
            "launches": n, "ms": ms, "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by})
    for name, (ops, n) in shapes_b.items():
        if name == "tick 2":
            ms, plain, (b_ms, b_by) = ms_b, plain_b, (bound_b, by_b)
        else:
            ms = cuda_ms(lambda: kb.disrupt_repack(*ops), reps=50)
            plain = cuda_ms(lambda: kb.repack_reference(*ops), reps=5, warmup=1, batch=1)
            b_ms, b_by = repack_bound(ops)
        shape_rows["disrupt_repack"].append({
            "path": name, "shape": {"S": ops[4].shape[0], "C": ops[2].shape[0],
                                    "N": ops[4].shape[1], "R": ops[2].shape[1]},
            "feasible_classes": int(ops[1].any(1).sum()),
            "launches": n, "ms": ms, "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by})

    # kernel A's scratch layout against the lean one at K=1280 (the merged
    # world's operands), in turns: lean, scratch, scratch, lean
    ops_m = world_ops["merged"]["ffd_scan"][0]
    turns = []
    for layout_name in ("lean", "scratch", "scratch", "lean"):
        turns.append((layout_name, cuda_ms(lambda: ka._launch(
            *ops_m, g_max=G_MAX, objective="price", layout_name=layout_name), reps=20)))
    scratch_vs_lean = {"shape": {"C": ops_m[0].shape[0], "G": G_MAX, "K": ops_m[9].shape[0]},
                       "turns_ms": turns}

    # each sweep: one replacement pass per pool (CUDA events, on the pass's
    # operands: the sweep's kernel-B leftover and the pool's context), the
    # sweep wall (median of 3 warm sweeps) and its host stages
    od_col = int(encode.CAPTYPE_INDEX[wk.CAPACITY_TYPE_ON_DEMAND])

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    sweep_times = {}
    for name, sw in sweeps.items():
        enc = engine._encode_sets(sw["nodes"], sw["sets"])
        leftover = kb.disrupt_repack(*sweep_ops[name]["disrupt_repack"][0])[0]
        replace_ms = {}
        for ctx in engine._pool_contexts(enc, sw["kw"]["pools"], sw["kw"]["catalogs"],
                                         sw["kw"]["daemon_overhead"]):
            r_ops = (leftover, put(ctx.cs.req), put(ctx.compat), put(ctx.cs.azone),
                     put(ctx.cs.acap), ctx.cap, put(ctx.ovh), ctx.price)
            replace_ms[ctx.pool.name] = {
                "ms": cuda_ms(lambda: dk.disrupt_replace(*r_ops, od_col=od_col), reps=10),
                "shape": {"S": leftover.shape[0], "C": leftover.shape[1], "K": ctx.cap.shape[0]}}
        runs = []
        for _ in range(3):
            with sweep_stage_timer(engine, [(dk, "disrupt_replace", "replace"),
                                            (encode, "group_pods", "group"),
                                            (engine_mod, "_node_feasibility", "feasibility")]) as t:
                t0 = time.perf_counter()
                engine.evaluate(sw["nodes"], sw["sets"], **sw["kw"])
                torch.cuda.synchronize()
                t["wall"] = (time.perf_counter() - t0) * 1e3
            runs.append(t)
        stages_s = {k: statistics.median(r.get(k, 0.0) for r in runs) for k in runs[0]}
        sweep_times[name] = {"wall_ms_median": stages_s.pop("wall"), "stages_ms": stages_s,
                             "replace_pass": replace_ms}
    bench_wall = sweep_times["bench-sweep"]["wall_ms_median"]
    bench_nodes_per_s = sweep_docs["bench-sweep"]["candidates"] / (bench_wall / 1e3)

    # each world's tick wall and host stages (median of 3 warm runs)
    world_walls, world_stages = {}, {}
    warm_results = dict(world_results)
    for name, fn in worlds_of(sched_solver, warm_results).items():
        first, med = wall_ms(fn, reps=3)
        world_walls[name] = {"first_timed": first, "median": med}
        runs = []
        for _ in range(3):
            with stage_timer(sched_solver, ffd) as t:
                fn()
                torch.cuda.synchronize()
            runs.append(t)
        world_stages[name] = {k: statistics.median(r.get(k, 0.0) for r in runs)
                              for k in runs[0]}
    torch.cuda.synchronize()

    # the armed route of B8 and B9 (solver/aot.py): the fused solve, the bound
    # and the relaxation on tick 1's inputs, the ordinary dispatch against the
    # armed graph's replay -- host enqueue (median of 10, each call alone
    # after a sync) and CUDA events around 10 back-to-back calls (median of 5);
    # printed, not claimed
    from karpenter_tpu_torch.solver import aot as aot_mod

    cx_armed = TorchSolver(g_max=G_MAX, device=dev, tier="convex")
    mgr_t = cx_armed.enable_aot(None, duty=1.0, pads=(cs1.c_pad,))
    ent_t = cx_armed._catalog(items)
    if not mgr_t.drain(600):
        raise AssertionError(f"the convex ladder did not drain: {mgr_t.describe()}")
    inp_t = ffd.make_inputs_staged(ent_t.staged, cs1, packed_masks=True)
    stat_b = dict(word_offsets=ent_t.offsets, words=ent_t.words)
    routes = {
        "ffd_solve_fused": ((inp_t,), dict(g_max=G_MAX, nnz_max=ffd.nnz_budget(cs1.c_pad, G_MAX),
                                           objective="price", **stat_b), ffd.ffd_solve_fused),
        "fractional_price_bound": ((inp_t, torch.from_numpy(cs1.count.astype(np.float32)).to(dev)),
                                   stat_b, price_bound.fractional_price_bound),
        "convex_relax": ((inp_t,), dict(iters=relax.DEFAULT_ITERS, **stat_b), relax.convex_relax),
    }
    armed_route = {}
    for name, (args, statics, fn) in routes.items():
        def ordinary(args=args, statics=statics, fn=fn):
            return fn(*args, **statics)

        def armed(name=name, args=args, statics=statics):
            hit, out = mgr_t.try_call(name, args, statics)
            if not hit:
                raise AssertionError(f"{name} is not armed at C={cs1.c_pad}")
            return out

        got, want = aot_mod._flatten(armed())[0], aot_mod._flatten(ordinary())[0]
        torch.cuda.synchronize()
        same = all(a.cpu().numpy().tobytes() == b.cpu().numpy().tobytes()
                   for a, b in zip(got, want))
        if not same:
            raise AssertionError(f"the armed {name} differs from its ordinary dispatch")
        row = {}
        for route, call in (("ordinary", ordinary), ("armed", armed)):
            enq = []
            for _ in range(10):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                call()
                enq.append((time.perf_counter() - t0) * 1e3)
            torch.cuda.synchronize()
            row[route] = {"enqueue_ms_median_of_10": statistics.median(enq),
                          "events_ms_10_back_to_back": cuda_ms(call, reps=5)}
        armed_route[name] = {"c_pad": cs1.c_pad, "equal": same, **row}
    mgr_t.stop(timeout_s=60.0)

    # the grouping stage on each world's pods: the C loop (native/_grouping.c)
    # against the pure-Python loop, in turns, median of 3 each; both must give
    # the same classes in the same order with the same pods
    group_loops = {}
    for name, (pods_w, _route, _needed) in world_spec.items():
        runs = {"native": [], "pure": []}
        classes = {}
        for _ in range(3):
            for loop in ("native", "pure"):
                encode._native_grouping = native.grouping if loop == "native" else None
                try:
                    t0 = time.perf_counter()
                    got = encode.group_pods(pods_w)
                    runs[loop].append((time.perf_counter() - t0) * 1e3)
                finally:
                    encode._native_grouping = native.grouping
                classes[loop] = [(c.key, [p.metadata.name for p in c.pods]) for c in got]
        if classes["native"] != classes["pure"]:
            raise AssertionError(f"world {name}: the native and pure grouping loops differ")
        group_loops[name] = {"pods": len(pods_w), "classes": len(classes["native"]),
                             "native_ms_median_of_3": statistics.median(runs["native"]),
                             "pure_ms_median_of_3": statistics.median(runs["pure"]),
                             "same_classes_order_and_pods": True}
    emit({"phase": "times", "timing": "CUDA events around 10 back-to-back calls, median of 20",
          "ffd_scan": {"ms": ms_a, "plain_ms": plain_a, "bound_ms": bound_a,
                       "bound_by": by_a, "shape": {"C": C, "G": G_MAX, "K": K}},
          "ffd_scan_tick2": {"ms": ms_a2, "plain_ms": plain_a2, "bound_ms": bound_a2,
                             "bound_by": by_a2, "shape": {"C": ops_a2[0].shape[0], "G": G_MAX, "K": K},
                             "real_classes": len(cases.real_classes(ops_a2))},
          "ffd_scan_sweep_tick1_operands": sweep,
          "disrupt_repack": {"ms": ms_b, "plain_ms": plain_b, "bound_ms": bound_b,
                             "bound_by": by_b, "shape": {"S": S, "C": Cb, "N": N}},
          "tick1_wall_ms": {"first": wall1_cold, "first_timed": tick1_first, "median": tick1_ms},
          "tick2_wall_ms": {"first": wall2_cold, "first_timed": tick2_first, "median": tick2_ms},
          "tick1_stages_ms": stages1, "tick2_stages_ms": stages2,
          "kernel_shapes": shape_rows,
          "schedule_wall_ms": world_walls, "schedule_stages_ms": world_stages,
          "stages_note": "host clock; solve_finish holds fetch_fused and decode, "
                         "oracle_suffix holds the oracle's pass, fetch_fused waits "
                         "for the device",
          "peak_device_bytes_main_path": peak_bytes,
          "ffd_scan_scratch_vs_lean_k1280": scratch_vs_lean,
          "consolidate": sweep_times, "bench_sweep_nodes_per_s": bench_nodes_per_s,
          "armed_route": armed_route,
          "group_native_vs_pure": {"native_module": native.grouping.__name__,
                                   "worlds": group_loops},
          "consolidate_stages_note": "host clock; encode_sets holds group (group_pods) and "
                                     "feasibility (the [C, N] loop), repack holds kernel B "
                                     "and the fetch of the leftover totals, assemble holds "
                                     "the replacement passes and their fetches, replace is "
                                     "their enqueue",
          **tag})

    # -- witness: the port's three runtime witnesses over the threaded paths,
    # in a process of its own, after every timed section of this one
    phase_witness(tag, {"median": tick1_ms, "p90": p90(tick1_runs), "n": len(tick1_runs)})

    # -- references: each card world against the same world with device="cpu",
    # each in a second process started after every timed section; the kernel
    # checks and the plain run, which print no time, run beside them
    references = start_references({"operator": operator_digests, "kube": kube_digests})
    try:
        # -- kernels against their plain versions -----------------------------------
        checks = []
        err_a = err_b = 0.0

        def check_scan(label, ops, objective, g_max=G_MAX, layout_name=None):
            """Kernel A against its plain version; `layout_name` runs a layout
            the kernel takes when shared memory is short ("lean", "scratch")
            at a shape where the resident one fits too."""
            nonlocal err_a
            if layout_name is not None:
                got = ka._launch(*ops, g_max=g_max, objective=objective, layout_name=layout_name)
            else:
                got = ka.fused_scan(*ops, g_max=g_max, objective=objective)
            want = ka.fused_scan_reference(*ops, g_max=g_max, objective=objective)
            torch.cuda.synchronize()
            err = max_abs_diff(got, want)
            err_a = max(err_a, err)
            same = all(torch.equal(a, b) for a, b in zip(got, want))
            checks.append({"kernel": "ffd_scan", "case": label, "equal": same, "max_abs_err": err})
            if not same:
                raise AssertionError(f"kernel A differs from its plain version: {label}")
            return want

        def check_repack(label, ops, scratch=False):
            """Kernel B against its plain version; `scratch` runs the layout
            with the headroom in device memory."""
            nonlocal err_b
            got = kb._launch(*ops, resident=False) if scratch else kb.disrupt_repack(*ops)
            want = kb.repack_reference(*ops)
            torch.cuda.synchronize()
            err = max_abs_diff(got, want)
            err_b = max(err_b, err)
            same = all(torch.equal(a, b) for a, b in zip(got, want))
            checks.append({"kernel": "disrupt_repack", "case": label, "equal": same, "max_abs_err": err})
            if not same:
                raise AssertionError(f"kernel B differs from its plain version: {label}")
            return want

        @contextlib.contextmanager
        def plain_kernels():
            """Both wrappers swapped for their plain versions (the reference
            run: not the main path, and not counted)."""
            saved = ka.fused_scan, kb.disrupt_repack
            ka.fused_scan = ka.fused_scan_reference
            kb.disrupt_repack = kb.repack_reference
            try:
                yield
            finally:
                ka.fused_scan, kb.disrupt_repack = saved

        nnz1 = ffd.nnz_budget(cs1.c_pad, G_MAX)
        for objective in ("price", "fit"):
            for packed in (True, False):
                inp = ffd.make_inputs_staged(entry.staged, cs1, packed_masks=packed)
                kw = dict(g_max=G_MAX, nnz_max=nnz1, word_offsets=entry.offsets,
                          words=entry.words, objective=objective)
                got = ffd.fetch_fused(ffd.ffd_solve_fused(inp, **kw))
                with plain_kernels():
                    want = ffd.fetch_fused(ffd.ffd_solve_fused(inp, **kw))
                same = got.tobytes() == want.tobytes()
                checks.append({"kernel": "ffd_scan", "case": f"tick1 fused buffer {objective} "
                               f"{'packed' if packed else 'full'}", "equal": same, "lanes": int(got.size)})
                if not same:
                    raise AssertionError(f"fused buffers differ ({objective}, packed={packed})")
                check_scan(f"tick1 scan {objective} {'packed' if packed else 'full'}",
                           scan_ops(cs1, objective, packed), objective)
        # tied prices: every offering at one price, so the envelope's argmin ties
        tied = encode.encode_catalog(items)
        tied.price = np.where(np.isfinite(tied.price), np.float32(1.0), tied.price).astype(np.float32)
        staged_tied, _, _ = ffd.stage_catalog(tied, dev)
        check_scan("tied prices", scan_ops(cs1, "price", True, staged_tied), "price")
        # exact quotients: capacities exact multiples of the requests (6/3 = 2)
        exact = encode.encode_catalog(items)
        real = exact.cap[:, 0] > 0
        exact.cap[real, 0] = 6000.0
        exact.cap[real, 1] = 8192.0
        staged_exact, _, _ = ffd.stage_catalog(exact, dev)
        check_scan("exact quotients", scan_ops(cs1, "price", True, staged_exact), "price")
        check_scan("slot exhaustion g_max=64", ops_a, "price", g_max=64)
        check_scan("tick2 scan (63 padded rows)", ops_a2, "price")
        zeroed = tuple(t.clone() for t in ops_a2)
        zeroed[6][cases.real_classes(ops_a2)[-1]] = 0
        check_scan("tick2 scan, a count-0 class open groups could join", zeroed, "price")
        want = check_scan("padded rows between real classes",
                          scan_ops(cases.padded_between(cs1), "price", True), "price")
        if not torch.all(want[1][2::6] == 3):
            raise AssertionError("the padded rows' pods did not come back as unplaced")
        last = cs1.c_real - 1
        for c, n in ((last, None), (last, 0), (cs1.c_real // 3, None)):
            want = check_scan(f"zero-request class {c} count {n}: the prefix sum wraps",
                              scan_ops(cases.zero_request(cs1, c, n), "price", True), "price")
            if int(want[1][c]) >= 0:
                raise AssertionError("the zero-request case did not wrap the prefix sum")
        check_scan("C=256 world", ops_a3, "price")
        for layout_name in ("lean", "scratch"):
            check_scan(f"{layout_name} layout tick1", ops_a, "price", layout_name=layout_name)
            check_scan(f"{layout_name} layout tick2", ops_a2, "price", layout_name=layout_name)
        r8 = list(ops_a)
        r8[0], r8[9] = ops_a[0][:, :8].contiguous(), ops_a[9][:, :8].contiguous()
        check_scan("scratch layout tick1, R=8 (run-time R)", tuple(r8), "price", layout_name="scratch")

        check_repack("tick2 pre-pass S=1", ops_b)
        check_repack("tick2 pre-pass, infeasible rows between real classes S=1", cases.gap_repack(ops_b))
        check_repack("tick2 pre-pass, scratch layout", ops_b, scratch=True)
        zr = tuple(t.clone() for t in ops_b)
        zr[2][3] = 0.0
        zr[1][3] = True
        if int(check_repack("zero-request class: the prefix sum wraps", zr)[0][0, 3]) >= 0:
            raise AssertionError("the zero-request repack case did not wrap the prefix sum")
        rng = np.random.default_rng(SEED)
        for s in range(2):
            s_, c_, n_ = 64, ops_b[2].shape[0], ops_b[0].shape[0]
            world = (
                rng.integers(0, 64, (n_, encode.R)).astype(np.float32), rng.random((c_, n_)) < 0.7,
                rng.integers(0, 5, (c_, encode.R)).astype(np.float32),
                rng.integers(0, 40, (s_, c_)), rng.random((s_, n_)) < 0.2,
            )
            ops = dk.repack_from_numpy(*world, dev)
            check_repack(f"random world S=64 seed {s}", ops)
            check_repack(f"random world S=64 seed {s}, infeasible rows between", cases.gap_repack(ops, s))
        check_repack("exact quotient 6/3", dk.repack_from_numpy(
            np.full((2, 1), 6.0), np.ones((1, 2), bool), np.full((1, 1), 3.0),
            np.array([[5]]), np.zeros((1, 2), bool), dev))
        # the schedule worlds' own operands: the merged catalog (K=1280, the
        # lean layout), the split pass's zone-pinned sub-classes, the wave's
        # repack onto zone-pinned rows
        for name in world_spec:
            ops = world_ops[name]["ffd_scan"][0]
            check_scan(f"{name} scan C={ops[0].shape[0]} K={ops[9].shape[0]} "
                       f"({world_docs[name]['layout']} layout)", ops, "price")
        for name in convex_spec:
            ops = convex_ops[name]["ffd_scan"][0]
            check_scan(f"convex {name} scan C={ops[0].shape[0]} K={ops[9].shape[0]}", ops, "price")
        check_repack("spread tick 2 pre-pass, zone-pinned rows",
                     world_ops["spread tick 2"]["disrupt_repack"][0])
        # each sweep's own repack: one block per candidate set
        for name in sweeps:
            ops = sweep_ops[name]["disrupt_repack"][0]
            check_repack(f"{name} S={ops[4].shape[0]} C={ops[2].shape[0]} N={ops[4].shape[1]}", ops)
        # the sidecar's own launches in phase `wire`: kernel A behind the ops
        # solve_delta (ticks) and solve_convex, kernel B behind solve_disrupt
        for name in ("shm tick 1", "shm delta tick", "tcp merged tainted", "shm convex a: tick 1"):
            ops = wire_ops[name]["ffd_scan"][0]
            check_scan(f"wire {name} scan C={ops[0].shape[0]} K={ops[9].shape[0]}", ops, "price")
        ops = wire_ops["shm rampdown-sweep spot-od"]["disrupt_repack"][0]
        check_repack(f"wire rampdown-sweep spot-od S={ops[4].shape[0]} C={ops[2].shape[0]} "
                     f"N={ops[4].shape[1]}", ops)
        # the operator's own calls in phase `operator`
        for name, (ops, _) in operator_ops["ffd_scan"].items():
            check_scan(f"{name} scan C={ops[0].shape[0]} K={ops[9].shape[0]}", ops, "price")
        for name, (ops, _) in operator_ops["disrupt_repack"].items():
            check_repack(f"{name} S={ops[4].shape[0]} C={ops[2].shape[0]} N={ops[4].shape[1]}", ops)
        # the warm-up ladder's armed CUDA graphs against the ordinary dispatch,
        # byte for byte: every tier-0 bucket on real class rows (the C=256
        # world's classes, repeated past 256), the tier-3 pre-pass floor shape
        from karpenter_tpu_torch.solver.kernels import build as kbuild

        armed_solver = TorchSolver(g_max=G_MAX, device=dev)
        mgr = armed_solver.enable_aot(None, duty=1.0)
        armed_entry = armed_solver._catalog(items)
        if not mgr.drain(600) or mgr.describe()["compile_failures"]:
            raise AssertionError(f"the warm-up ladder did not arm: {mgr.describe()}")
        # the fused solve's graph holds kernel A, the pre-pass's kernel B;
        # the bound is torch code (no kernel of its own)
        armed_checks = {"ffd_scan": 0, "disrupt_repack": 0, "fractional_price_bound": 0}

        def check_armed(kernel, label, entry_name, args, statics, ordinary):
            hit, got = mgr.try_call(entry_name, args, statics)
            want = ordinary(*args, **statics)
            torch.cuda.synchronize()
            got_t = got if isinstance(got, tuple) else (got,)
            want_t = want if isinstance(want, tuple) else (want,)
            same = hit and all(a.cpu().numpy().tobytes() == b.cpu().numpy().tobytes()
                               for a, b in zip(got_t, want_t))
            checks.append({"kernel": kernel, "case": f"armed graph {label} vs the ordinary "
                           f"dispatch", "equal": same, "hit": hit})
            if not same:
                raise AssertionError(f"an armed graph differs from the ordinary dispatch: {label}")
            armed_checks[kernel] += 1

        for cp in armed_solver.WARM_C_PADS:
            rows = (list(classes3) * (cp // len(classes3) + 1))[:cp]
            cs_cp = encode.encode_classes(rows, armed_entry.tensors, c_pad=cp)
            inp_cp = ffd.make_inputs_staged(armed_entry.staged, cs_cp, packed_masks=True)
            fstat = dict(g_max=G_MAX, nnz_max=ffd.nnz_budget(cp, G_MAX),
                         word_offsets=armed_entry.offsets, words=armed_entry.words,
                         objective="price")
            check_armed("ffd_scan", f"fused c{cp}", "ffd_solve_fused", (inp_cp,), fstat,
                        ffd.ffd_solve_fused)
            placed_cp = torch.from_numpy(cs_cp.count.astype(np.float32)).to(dev)
            check_armed("fractional_price_bound", f"bound c{cp}", "fractional_price_bound",
                        (inp_cp, placed_cp),
                        dict(word_offsets=armed_entry.offsets, words=armed_entry.words),
                        price_bound.fractional_price_bound)
        rng_p = np.random.default_rng(SEED + 3)
        floor_ops = dk.repack_from_numpy(
            rng_p.integers(0, 64, (16, encode.R)).astype(np.float32), rng_p.random((16, 16)) < 0.6,
            rng_p.integers(0, 5, (16, encode.R)).astype(np.float32),
            rng_p.integers(0, 9, (1, 16)).astype(np.int32), np.zeros((1, 16), bool), dev)
        check_armed("disrupt_repack", "pre-pass floor S=1 C=16 N=16", "disrupt_repack",
                    floor_ops, {}, kb.disrupt_repack)
        # a tick through the graphs: one armed fused solve, no launch, tick 1's
        # decisions; then the rejected-replay drill on the same tick
        a0 = metrics.AOT_DISPATCHES.value(entry="ffd_solve_fused")
        la = ka.launches
        through = armed_solver.solve(pool, items, pods1)
        torch.cuda.synchronize()
        tick_doc = {"aot_dispatches": metrics.AOT_DISPATCHES.value(entry="ffd_solve_fused") - a0,
                    "kernel_a_launches": ka.launches - la,
                    "decisions_equal_tick1": sig(through) == sig(tick1)}
        armed0 = mgr.describe()["armed"]
        f0 = metrics.AOT_FALLBACKS.value(reason="dispatch")
        la = ka.launches
        failpoints.FAILPOINTS.arm_spec("aot.dispatch=error(RuntimeError):times=1")
        try:
            drilled = armed_solver.solve(pool, items, pods1)
            torch.cuda.synchronize()
        finally:
            failpoints.FAILPOINTS.reset()
        reject_doc = {"fallbacks_dispatch": metrics.AOT_FALLBACKS.value(reason="dispatch") - f0,
                      "disarmed": armed0 - mgr.describe()["armed"],
                      "kernel_a_launches": ka.launches - la,
                      "decisions_equal_tick1": sig(drilled) == sig(tick1)}
        # a corrupt library in a store: counted once, unlinked, rebuilt by
        # nvcc, kernel B exact (the process's own libraries are put back)
        saved_libs, saved_store = dict(kbuild._LIBS), kbuild._store_dir
        try:
            with tempfile.TemporaryDirectory(prefix="karpenter-store-drill-") as store:
                kbuild.use_store(store)
                bad = kbuild._library_path("disrupt_repack")
                bad.write_bytes(b"\x7fELF not a library")
                kbuild._manifest(bad).write_text(json.dumps({
                    "v": kbuild._MANIFEST_VERSION, "fingerprint": kbuild.fingerprint(),
                    "name": "disrupt_repack"}))
                kbuild._LIBS.pop("disrupt_repack", None)
                d0 = metrics.AOT_FALLBACKS.value(reason="deserialize")
                m0 = metrics.COMPILE_CACHE_MISSES.value()
                check_repack("store drill: the rebuilt library, tick2 pre-pass S=1", ops_b)
                corrupt_doc = {
                    "fallbacks_deserialize": metrics.AOT_FALLBACKS.value(reason="deserialize") - d0,
                    "rebuilt_by_nvcc": metrics.COMPILE_CACHE_MISSES.value() - m0,
                    "rebuilt_seconds": kbuild.BUILD_LOG.get("disrupt_repack", {}).get("seconds"),
                    "store_after": kbuild.store_stats(store)}
        finally:
            kbuild._LIBS.clear()
            kbuild._LIBS.update(saved_libs)
            kbuild._store_dir = saved_store
        aot_doc = {"describe": mgr.describe(), "armed_checks": armed_checks,
                   "tick_through_graphs": tick_doc, "rejected_replay_drill": reject_doc,
                   "corrupt_library_drill": corrupt_doc}
        aot_ok = (tick_doc["aot_dispatches"] == 1 and tick_doc["kernel_a_launches"] == 0
                  and tick_doc["decisions_equal_tick1"]
                  and reject_doc == {"fallbacks_dispatch": 1, "disarmed": 1,
                                     "kernel_a_launches": 1, "decisions_equal_tick1": True}
                  and corrupt_doc["fallbacks_deserialize"] == 1
                  and corrupt_doc["rebuilt_by_nvcc"] == 1)
        mgr.stop(timeout_s=60.0)
        emit({"phase": "kernels", "checks": checks, "aot": aot_doc, **tag})
        if not aot_ok:
            raise AssertionError(f"the armed graphs or their rung drills: {aot_doc}")

        # -- the same two ticks through the plain versions, on the card --------------
        with plain_kernels():
            ref_solver = TorchSolver(g_max=G_MAX, device=dev)
            ref1 = ref_solver.solve(pool, items, pods1)
            ref2 = ref_solver.solve(pool, items, pods2, existing_nodes=workload.nodes_from_result(ref1))
            ref_worlds = {}
            for name, fn in worlds_of(TorchSolver(g_max=G_MAX, device=dev), ref_worlds).items():
                ref_worlds[name] = fn()
            ref_engine = DisruptEngine(solver=TorchSolver(g_max=G_MAX, device=dev))
            ref_sweeps = {name: ref_engine.evaluate(sw["nodes"], sw["sets"], **sw["kw"])
                          for name, sw in sweeps.items()}
        same1, same2 = sig(ref1) == sig(tick1), sig(ref2) == sig(tick2)
        same_worlds = {name: sig(ref_worlds[name]) == sig(world_results[name]) for name in world_spec}
        same_sweeps = {name: [repr(v) for v in ref_sweeps[name]]
                       == [repr(v) for v in sweep_results[name]] for name in sweeps}
        emit({"phase": "plain", "tick1_decisions_equal": same1, "tick2_decisions_equal": same2,
              "schedule_worlds_decisions_equal": same_worlds,
              "sweep_verdict_reprs_equal": same_sweeps, **tag})
        if not (same1 and same2 and all(same_worlds.values()) and all(same_sweeps.values())):
            raise AssertionError("the main path's decisions differ from the plain versions'")

        phase_references(tag, references)
    finally:
        stop_references(references)

    def launches_on_paths(kernel):
        return (launches1[kernel] + launches2[kernel]
                + sum(n[kernel] for n in world_launches.values())
                + sum(n[kernel] for n in sweep_launches.values())
                + sum(n[kernel] for n in convex_launches.values())
                + sum(n[kernel] for n in wire_launches.values())
                + sum(n[kernel] for n in operator_launches.values()))

    kernels = [
        {"name": "ffd_scan", "route": "cuda", "source": "karpenter_tpu_torch/csrc/ffd_scan.cu",
         "replaces": "karpenter_tpu/solver/kernels/ffd_pallas.py:70",
         "launches": launches_on_paths("ffd_scan"), "max_abs_err": err_a,
         "ms": ms_a, "plain_ms": plain_a, "bound_ms": bound_a, "bound_by": by_a,
         "library_ms": None, "shapes": shape_rows["ffd_scan"],
         "armed_replay_checks": armed_checks["ffd_scan"]},
        {"name": "disrupt_repack", "route": "cuda",
         "source": "karpenter_tpu_torch/csrc/disrupt_repack.cu",
         "replaces": "karpenter_tpu/solver/kernels/disrupt_pallas.py:38",
         "launches": launches_on_paths("disrupt_repack"),
         "max_abs_err": err_b, "ms": ms_b, "plain_ms": plain_b, "bound_ms": bound_b,
         "bound_by": by_b, "library_ms": None, "shapes": shape_rows["disrupt_repack"],
         "armed_replay_checks": armed_checks["disrupt_repack"]},
    ]
    print(smi, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": card, "count": count}})
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--operator-twin"]:
        N_PODS, N_WAVE, G_MAX = (int(v) for v in sys.argv[3:6])
        sys.exit(side_world(sys.argv[1], sys.argv[2]))
    if sys.argv[1:2] == ["--kube-reference"]:
        KUBE_PODS, KUBE_WAVE, G_MAX = (int(v) for v in sys.argv[3:6])
        sys.exit(side_world(sys.argv[1], sys.argv[2]))
    if sys.argv[1:2] == ["--coldstart"]:
        N_PODS, G_MAX = (int(v) for v in sys.argv[4:6])
        DEVICE = sys.argv[6]
        sys.exit(coldstart_child(sys.argv[2], sys.argv[3]))
    if sys.argv[1:2] == ["--witness"]:
        N_PODS, N_WAVE, G_MAX = (int(v) for v in sys.argv[3:6])
        DEVICE = sys.argv[6]
        sys.exit(witness_child(sys.argv[2]))
    if sys.argv[1:2] == ["--rehearse-kube"]:
        sys.exit(rehearse_kube(int(sys.argv[2]) if len(sys.argv) > 2 else 200))
    sys.exit(main())
