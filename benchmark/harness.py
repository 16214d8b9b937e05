"""One run of one cell: set-up, the measured window, the check against the
plain reference, and (with tracing) the per-layer readings.

Everything a cell needs is found by name: its configuration
(configs/<config>.json), its traffic mix (traffic/<mix>.json, read by
gen/traffic.py) and each per-layer metric's reader
(layer_metrics/<metric>.py, a `read(trace)` that returns a number or
None). The mix's kind picks the driver below.
"""
from __future__ import annotations

import importlib.util
import json
import math
import os
import sys
import tempfile
import time
import traceback
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

import program
from gen import traffic
from reference import common, ffd, sweep as sweep_ref
from roofline import counts

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
CACHE = HERE / ".cache"
FORBIDDEN = ("jax", "jaxlib", "flax", "karpenter_tpu")

# every comparison is exact: the limit of each number is 0
LIMITS = {
    "provision": {"existing_differ": 0.0, "nodes_differ": 0.0, "pods_not_once": 0.0,
                  "price_gap": 0.0, "calls_failed": 0.0},
    "sweep": {"verdicts_differ": 0.0, "calls_failed": 0.0},
}
CHECKED_CALLS = 3              # drawn from the seed, besides the slowest call
# a --trace 1 run traces the calls that start in the window's first seconds,
# so that its profile stays a few hundred MB; the rest of the window runs untraced
TRACE_SECONDS = 8.0


def manifest() -> dict:
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def cell_files(doc: dict, workload: str):
    """(cell, config, mix) of a workload name in BENCHMARK.json."""
    cells = {w["name"]: w for w in doc["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    config_entry = {c["name"]: c for c in doc["configs"]}[cell["config"]]
    with open(ROOT / config_entry["file"]) as f:
        config = json.load(f)
    mix = traffic.load_mix(str(HERE / "traffic" / f"{cell['traffic']}.json"))
    return cell, config, mix


def reader(metric: str):
    path = HERE / "layer_metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"layer_metric_{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cache_dirs() -> str:
    """Fixed build and kernel cache directories inside the checkout."""
    for name, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                      ("TRITON_CACHE_DIR", "triton")):
        os.environ[name] = str(CACHE / sub)
    return str(CACHE / "store")


# -- drivers ------------------------------------------------------------------

class Provision:
    """Calls of TorchSolver.schedule() on pending batches. Without a
    device, only the plain side (the reference and the check)."""

    def __init__(self, inputs: dict, config: dict, device: Optional[str]):
        self.inputs, self.config = inputs, config
        cat: common.Catalog = inputs["catalog"]
        self.zones = cat.zones
        self.n_calls = len(inputs["calls"])
        self.pools_plain = ffd.pools(config)
        self.routes: Dict[str, int] = {}      # the solver's route of each call, by path
        if device is None:
            return
        self.items = program.instance_types(inputs["entries"])
        self.pools = program.nodepools(config)
        self.overhead = program.daemon_overhead(config) or None
        factory = program.PodFactory(inputs["templates"])
        self.batches = [factory.pods(c["pods"]) for c in inputs["calls"]]
        self.standing = program.existing_nodes(inputs["standing"])
        self.solver, self.ladder = program.solver(device, config["g_max"], config["objective"],
                                                  cache_dirs())

    def close(self):
        self.solver.stop_warm_up()

    def warm(self):
        program.warm(self.solver, self.ladder, self.items)
        for i in range(len(self.batches)):
            self.call(i)()
        self.routes.clear()

    def call(self, i: int):
        pods = self.batches[i % len(self.batches)]
        sched = program.scheduler(self.pools, self.items, self.zones, self.standing, self.overhead)

        def schedule():
            out = self.solver.schedule(sched, pods)
            path = self.solver.last_route["path"]
            self.routes[path] = self.routes.get(path, 0) + 1
            return out
        return schedule

    def work(self, i: int) -> int:
        return len(self.inputs["calls"][i % self.n_calls]["pods"])

    def plain(self, out) -> dict:
        return program.decision(out, self.zones)

    def _classes(self, i: int):
        call = self.inputs["calls"][i % self.n_calls]
        return traffic.classes(self.inputs["templates"], call["pods"])

    def reference(self, i: int, precision=common.Precision(), joined=None, walked=None) -> dict:
        classes = self._classes(i)
        where, placed = {}, None
        if self.inputs["standing"]:
            where, placed = ffd.pack_existing(classes, self.inputs["standing"], precision, walked)
        out = ffd.tick(self.inputs["catalog"], classes, g_max=self.config["g_max"],
                       objective=self.config["objective"], pools=self.pools_plain,
                       precision=precision, placed=placed, joined=joined)
        out["existing"] = where
        return out

    def compare(self, got: dict, want: dict, i: int) -> Dict[str, float]:
        return ffd.compare(self.inputs["catalog"], got, want, self.work(i), self.pools_plain)

    def bounds(self, i: int) -> Dict[str, float]:
        """Kernel A over the columns the reference scanned (one a (pool,
        type) pair: the merged catalog under several pools) and the pairs
        it joined; kernel B's full entry over the nodes it walked."""
        joined: list = []
        walked: list = []
        scanned = self.reference(i, joined=joined, walked=walked)["columns"]
        out = {"ffd_scan": counts.ffd_scan_ms(joined, len(joined), scanned, common.R,
                                              self.config["g_max"])}
        if walked:
            w, member, n_nodes = walked[0]
            out["disrupt_repack"] = counts.disrupt_repack_ms(
                w, member, n_nodes, member.shape[1], 1, common.R, stepping=w > 0, takes=True)
        return out


class Sweep:
    """Calls of DisruptEngine.evaluate() over standing clusters. Without a
    device, only the plain side (the reference and the check)."""

    def __init__(self, inputs: dict, config: dict, device: Optional[str]):
        self.inputs, self.config = inputs, config
        self.n_calls = len(inputs["calls"])
        self.pools_plain = [(p["name"], p["captype"], p["weight"], p["overhead"])
                            for p in config["pools"]]
        self.routes: Dict[str, int] = {}
        if device is None:
            return
        from karpenter_tpu_torch.solver.disrupt.engine import DisruptEngine

        self.items = program.instance_types(inputs["entries"])
        self.pools = program.nodepools(config)
        self.catalogs = {p.name: self.items for p in self.pools}
        self.overhead = program.daemon_overhead(config)
        factory = program.PodFactory(inputs["templates"])
        self.worlds = []
        for call in inputs["calls"]:
            w = call["world"]
            cand = [factory.pods(ps) for ps in w["pods"]]
            sets = [([p for i in idx for p in cand[i]], [w["candidates"][i] for i in idx])
                    for idx in call["sets"]]
            self.worlds.append((program.existing_nodes(w["nodes"]), sets))
        self.solver, self.ladder = program.solver(device, config["g_max"], config["objective"],
                                                  cache_dirs())
        self.engine = DisruptEngine(solver=self.solver)

    def close(self):
        self.solver.stop_warm_up()

    def warm(self):
        program.warm(self.solver, self.ladder, self.items)
        # one sweep for each class-count bucket the worlds hit
        seen = set()
        for i, call in enumerate(self.inputs["calls"]):
            n = len({t for idx in call["sets"] for j in idx for t, _ in call["world"]["pods"][j]})
            if counts.bucket(n, 8) not in seen:
                seen.add(counts.bucket(n, 8))
                self.call(i)()

    def call(self, i: int):
        nodes, sets = self.worlds[i % len(self.worlds)]
        return lambda: self.engine.evaluate(nodes, sets, self.pools, self.catalogs, self.overhead)

    def work(self, i: int) -> int:
        return len(self.inputs["calls"][i % self.n_calls]["sets"])

    def plain(self, out) -> list:
        return program.verdicts(out)

    def reference(self, i: int, precision=common.Precision(), walked=None) -> list:
        call = self.inputs["calls"][i % self.n_calls]
        return sweep_ref.sweep(self.inputs["catalog"], self.inputs["templates"], call["world"],
                               call["sets"], self.pools_plain, precision=precision, walked=walked)

    def compare(self, got, want, i: int) -> Dict[str, float]:
        return sweep_ref.compare(got, want)

    def bounds(self, i: int) -> Dict[str, float]:
        walked: list = []
        self.reference(i, walked=walked)
        w, member, n_nodes = walked[0]
        return {"disrupt_repack": counts.disrupt_repack_ms(
            w, member, n_nodes, member.shape[1], member.shape[0], common.R, stepping=w > 0)}


DRIVERS = {"provision": Provision, "sweep": Sweep}


# -- the trace ------------------------------------------------------------------

class Trace:
    """What the per-layer readers read from one traced window."""

    def __init__(self, calls: List[dict], kernels: List[tuple], busy_us: float,
                 window_us: float, bounds: List[Dict[str, float]],
                 marks: Optional[List[tuple]] = None):
        self.calls = calls            # per call: wall_s, root span (program spans below it)
        self.kernels = kernels        # (name, start_us, dur_us) of every kernel launch
        self.busy_us = busy_us        # union of kernel and copy intervals
        self.window_us = window_us    # first call's start to last call's end
        self.bounds = bounds          # per call: kernel -> least time (ms)
        # per call: (start_us, end_us) of its marker on the kernels' clock;
        # a call's kernels start inside it (the call ends in a sync). None
        # when the profile's markers do not match the calls one for one
        self.marks = marks


def span_ms(root, name: str, self_time: bool) -> float:
    """Milliseconds in spans `name` under `root` (self time: less what
    their child spans cover)."""
    total, stack = 0.0, [root]
    while stack:
        sp = stack.pop()
        stack.extend(sp.children)
        if sp.name == name and sp.end is not None:
            d = sp.end - sp.start
            if self_time:
                d -= sum(ch.end - ch.start for ch in sp.children if ch.end is not None)
            total += d
    return total * 1e3


def _union(intervals) -> List[tuple]:
    out: List[list] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [tuple(x) for x in out]


def _read_profile(prof, roots, out) -> dict:
    """Kernels, busy time, the window and the breakdown from the profile
    (exported under $TMPDIR, read, and deleted)."""
    fd, path = tempfile.mkstemp(suffix=".json", dir=os.environ.get("TMPDIR") or None)
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        print(f"trace: {os.path.getsize(path)} bytes", file=out)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    # the host's call markers (kineto mirrors each on the device's timeline
    # as a gpu_user_annotation, which is not a call)
    marks = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                   if e.get("ph") == "X" and e.get("name") == "bench.call"
                   and e.get("cat") == "user_annotation")
    if not marks:
        raise RuntimeError("the profile holds no call markers")
    w0, w1 = marks[0][0], marks[-1][1]
    kernels, busy = [], []
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in ("kernel", "gpu_memcpy", "gpu_memset"):
            continue
        a, b = float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0))
        if b < w0 or a > w1:
            continue
        busy.append((max(a, w0), min(b, w1)))
        if e["cat"] == "kernel":
            kernels.append((e["name"], a, b - a))
    merged = _union(busy)
    busy_us = sum(b - a for a, b in merged)
    # host spans onto the profile's clock: each call's marker against its root
    offset = float(np.median([m[0] - r.start * 1e6 for m, r in zip(marks, roots)])) if roots else 0.0
    spans = []
    for r in roots:
        stack = [(r, 0)]
        while stack:
            sp, depth = stack.pop()
            if sp.end is not None:
                spans.append((sp.start * 1e6 + offset, sp.end * 1e6 + offset, depth, sp.name))
            stack.extend((ch, depth + 1) for ch in sp.children)
    gaps: Dict[str, float] = {}
    edges = [w0] + [x for ab in merged for x in ab] + [w1]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid = (a + b) / 2
        inside = [s for s in spans if s[0] <= mid <= s[1]]
        deepest = max(inside, key=lambda s: s[2]) if inside else None
        name = ("between calls" if deepest is None
                else "in the call, outside the program's spans" if deepest[2] == 0
                else deepest[3])
        gaps[name] = gaps.get(name, 0.0) + (b - a) / 1e6
    ops: Dict[str, float] = {}
    for name, _, dur in kernels:
        ops[name] = ops.get(name, 0.0) + dur / 1e6
    top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]  # noqa: E731
    return {"kernels": kernels, "busy_us": busy_us, "window_us": w1 - w0,
            "marks": marks if len(marks) == len(roots) else None,
            "breakdown": {"device_ops": top(ops), "idle_gaps": top(gaps)}}


# -- one run ------------------------------------------------------------------

def run(workload: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
        t0: Optional[float] = None, out=sys.stderr, doc: Optional[dict] = None) -> dict:
    """The result of one run (the JSON object run.py prints; its last key,
    `checks`, holds each number compared beside its limit)."""
    import torch

    t0 = time.perf_counter() if t0 is None else t0
    doc = manifest() if doc is None else doc
    cell, config, mix = cell_files(doc, workload)
    stages = {}

    def stage(name):
        stages[name] = round(time.perf_counter() - t0 - sum(stages.values()), 3)

    program.load(cache_dirs())
    stage("import")
    inputs = traffic.build(mix, config, seed)
    stage("inputs")
    driver = DRIVERS[mix["kind"]](inputs, config, device)
    stage("program_objects")
    driver.warm()
    stage("warm")
    # the binary's latency policy for the cyclic collector, once the
    # long-lived objects exist
    program.latency_gc()
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    stage("gc")
    # the plain reference's tick that built a standing cluster is the
    # yardstick's time, not the program's set-up
    print(f"setup stages (s): {json.dumps(stages)}; of the inputs, the reference's standing "
          f"cluster {inputs['reference_s']:.3f}", file=out)

    from karpenter_tpu_torch import tracing

    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function

        tracing.TRACER.configure(enabled=True, sample=1.0)
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
        prof = profile(activities=acts)
        prof.__enter__()
    rng = np.random.default_rng([seed, 1])
    walls: List[float] = []
    calls: List[dict] = []
    sample: Dict[int, object] = {}      # a uniform sample of the calls (algorithm R)
    slow = None                         # (wall, index, result) of the slowest call
    done = failed = 0
    setup_s = time.perf_counter() - t0 - inputs["reference_s"]
    w0 = time.perf_counter()
    i = 0
    tracing_on = trace
    while time.perf_counter() - w0 < seconds:
        if tracing_on and time.perf_counter() - w0 >= TRACE_SECONDS:
            prof.__exit__(None, None, None)
            tracing.TRACER.configure(enabled=False)
            tracing_on = False
        fn = driver.call(i)
        root = None
        a = time.perf_counter()
        try:
            if tracing_on:
                with record_function("bench.call"), tracing.trace("bench.call", force=True) as root:
                    res = fn()
            else:
                res = fn()
            if on_card:
                torch.cuda.synchronize()
        except Exception:  # noqa: BLE001 - a failed call is counted and reported
            failed += 1
            if failed == 1:
                traceback.print_exc(file=out)
            res = None
        wall = time.perf_counter() - a
        walls.append(wall)
        calls.append({"wall_s": wall, "root": root, "index": i})
        if res is not None:
            done += 1
            if len(sample) < CHECKED_CALLS:
                sample[i] = res
            else:
                j = int(rng.integers(0, done))
                if j < CHECKED_CALLS:
                    del sample[sorted(sample)[j]]
                    sample[i] = res
            if slow is None or wall > slow[0]:
                slow = (wall, i, res)
        i += 1
    window_s = time.perf_counter() - w0
    print(f"window: {len(walls)} calls in {window_s:.3f} s, {sum(walls) / window_s:.4f} of it "
          f"inside calls, median call {1e3 * sorted(walls)[len(walls) // 2]:.3f} ms", file=out)
    by_input: Dict[int, List[float]] = {}
    for c in calls:
        by_input.setdefault(c["index"] % driver.n_calls, []).append(c["wall_s"])
    if driver.routes:
        print(f"routes: {json.dumps(driver.routes)}", file=out)
    print("median ms by call input: " + json.dumps(
        {k: round(1e3 * sorted(v)[len(v) // 2], 3) for k, v in sorted(by_input.items())}), file=out)
    if len(walls) >= 10:
        q = np.quantile(np.array(walls) * 1e3, [0.1, 0.5, 0.9, 1.0])
        print(f"call ms p10 {q[0]:.3f} p50 {q[1]:.3f} p90 {q[2]:.3f} max {q[3]:.3f}; first ten "
              + json.dumps([round(1e3 * w, 2) for w in walls[:10]]), file=out)
    if tracing_on:
        prof.__exit__(None, None, None)
        tracing.TRACER.configure(enabled=False)
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    found = sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))
    if found:
        raise SystemExit(f"modules {found} are loaded in the process that measured")
    n = len(walls)
    work = sum(driver.work(c["index"]) for c in calls)
    metrics: Dict[str, dict] = {}
    result: Dict[str, object] = {}
    if trace:
        traced = [c for c in calls if c["root"] is not None]
        prof_doc = _read_profile(prof, [c["root"] for c in traced], out) if on_card else {
            "kernels": [], "busy_us": 0.0, "window_us": window_s * 1e6, "marks": None,
            "breakdown": None}
        bound_of: Dict[int, Dict[str, float]] = {}
        for c in traced:
            key = c["index"] % driver.n_calls
            if key not in bound_of:
                bound_of[key] = driver.bounds(c["index"])
        tr = Trace(traced, prof_doc["kernels"], prof_doc["busy_us"],
                   prof_doc["window_us"], [bound_of[c["index"] % driver.n_calls]
                                           for c in traced], prof_doc["marks"])
        for m in doc["per_layer"]:
            if workload not in m.get("workloads", [workload]):
                continue
            v = reader(m["name"])(tr)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        device_extra = {"busy_s": prof_doc["busy_us"] / 1e6, "window_s": prof_doc["window_us"] / 1e6}
        if prof_doc["breakdown"] is not None:
            result["breakdown"] = prof_doc["breakdown"]
    else:
        device_extra = {}
        e2e = {
            "tick_p95_ms": lambda: nearest_rank(walls, 0.95) * 1e3,
            "pods_per_s": lambda: work / window_s,
            "sets_per_s": lambda: work / window_s,
            "setup_s": lambda: setup_s,
        }
        for m in doc["end_to_end"]:
            if workload in m.get("workloads", [workload]):
                metrics[m["name"]] = {"value": e2e[m["name"]](), "unit": m["unit"]}
    # the check, once the window has closed and the peak is read
    del calls
    driver.close()
    numbers = {k: 0.0 for k in LIMITS[mix["kind"]]}
    numbers["calls_failed"] = float(failed)
    kept = dict(sample)
    if slow is not None:
        kept[slow[1]] = slow[2]
    for idx in sorted(kept):
        got = driver.plain(kept[idx])
        want = driver.reference(idx)
        for k, v in driver.compare(got, want, idx).items():
            numbers[k] = max(numbers[k], v)
    limits = LIMITS[mix["kind"]]
    correct = bool(kept) and all(numbers[k] <= limits[k] for k in limits)
    checks = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    if on_card:
        props = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                 "count": int(cell["chips"]), "memory_peak_bytes": int(peak)}
    else:
        props = {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    props.update(device_extra)
    out_doc = {"correct": correct, "attempted": n, "failed": failed, "metrics": metrics,
               "device": props}
    out_doc.update(result)
    out_doc["checks"] = checks
    return out_doc


def nearest_rank(values: List[float], q: float) -> float:
    s = sorted(values)
    return s[max(0, math.ceil(q * len(s)) - 1)]
