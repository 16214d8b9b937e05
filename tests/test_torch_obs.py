"""The port's metrics, failpoints, tracing and observatory against the JAX package's, on the CPU.

- every family of the port's registry exists in the JAX registry with the
  same name, type, label names (and buckets): the port defines no family
  the JAX package lacks;
- the same failpoint spec strings fire in the same sequence under the
  same seed in both registries (env arming and byte corruption too);
- after the same solves and sweeps, the shared families hold the same
  values in both packages (convex counters, quality gauges, the
  consolidation engine's counters);
- a traced `solve()`, a traced convex `solve()` and a traced `schedule()`
  on each route build span trees whose names, in tree order, are the JAX
  tracer's for the same call, once the port's own spans
  (`tracing.PORT_SPANS`) are taken out and their children lifted into
  their parents (the merged route's `merge_masks`, the `envelopes`, the
  route taken on `route`, the sparse take's counters on `device` and a
  forced dense refetch that decides alike); under a live `torch.profiler`
  capture each span is a `karpenter::<name>` range nested as the tree
  is, and with none live no range opens; a traced consolidation sweep
  opens the engine's spans in order;
- obs/hbm.py with an injected stats provider (the pressure eviction of
  TorchSolver's catalog LRU included), obs/profiler.py's capture,
  obs/flight.py's tick record and black box, and the sync witness's
  bookkeeping driven by a fake sync hook (``Tensor.cpu`` raising the
  warning torch's sync debug mode raises on the card).
"""
import json
import warnings

import numpy as np
import pytest

import jax  # noqa: F401  -- both frameworks in one process; data crosses as plain objects
import torch

from karpenter_tpu import failpoints as jfailpoints
from karpenter_tpu import metrics as jmetrics
from karpenter_tpu import tracing as jtracing
from karpenter_tpu.apis import NodePool as JNodePool
from karpenter_tpu.obs import flight as jflight
from karpenter_tpu.obs import hbm as jhbm
from karpenter_tpu.obs import jitstats as jjitstats  # noqa: F401  -- registers its families
from karpenter_tpu.obs import profiler as jprofiler  # noqa: F401  -- registers its families
from karpenter_tpu import operator as joperator  # noqa: F401  -- registers the controllers' families
from karpenter_tpu.obs import quality as jquality
from karpenter_tpu.solver import aot as jaot  # noqa: F401  -- registers its families
from karpenter_tpu.solver.disrupt import DisruptEngine as JEngine
from karpenter_tpu.solver.service import TPUSolver
from karpenter_tpu_torch import failpoints as tfailpoints
from karpenter_tpu_torch import operator as toperator  # noqa: F401  -- registers the controllers' families
from karpenter_tpu_torch import metrics as tmetrics
from karpenter_tpu_torch import tracing as ttracing
from karpenter_tpu_torch import workload
from karpenter_tpu_torch.analysis import sync_witness
from karpenter_tpu_torch.apis import NodePool as TNodePool
from karpenter_tpu_torch.obs import flight as tflight
from karpenter_tpu_torch.obs import hbm as thbm
from karpenter_tpu_torch.obs import profiler as tprofiler
from karpenter_tpu_torch.obs import quality as tquality
from karpenter_tpu_torch.solver.disrupt import DisruptEngine as TEngine
from karpenter_tpu_torch.solver.service import TorchSolver
from tests.test_packing import catalog_items  # noqa: F401
from tests.test_torch_catalog import (  # noqa: F401
    decision_sig, jax_nodes, node_specs, port_items, port_nodes,
)
from tests.test_torch_consolidate import jax_sweep, sweep_pools
from tests.test_torch_convex import world
from tests.test_torch_oracle import (  # noqa: F401
    TAINTED_POOLS, build, fuzz_spec, result_sig, small_items,
)
from tests.test_torch_schedule import ROUTE_WORLDS
from tests.test_torch_quality import both_pods
from karpenter_tpu.analysis import errwitness as jerrwitness
from karpenter_tpu.analysis import jax_witness as jjax_witness
from karpenter_tpu.analysis import witness as jwitness
from karpenter_tpu_torch.analysis import errwitness as terrwitness
from karpenter_tpu_torch.analysis import torch_witness as ttorch_witness
from karpenter_tpu_torch.analysis import witness as twitness


# small tensors: one intra-op thread per test worker (several workers share the cores)
torch.set_num_threads(1)

# the witnesses register their families lazily (first violation, or their
# _register_metrics hook): register them in both registries up front, so
# the comparison below does not depend on which tests this worker ran first
for _w in (jwitness, jerrwitness, jjax_witness, twitness, terrwitness, ttorch_witness):
    _w._register_metrics()

G = 64


# -- the registry: no family the JAX package lacks ------------------------------------


def families(registry):
    out = {}
    for name, m in registry._metrics.items():
        shape = (type(m).__name__, tuple(m.label_names))
        if isinstance(m, (jmetrics.Histogram, tmetrics.Histogram)):
            shape += (tuple(m.buckets),)
        out[name] = shape
    return out


# the families the port's modules reach: the rungs, the engine, the
# grouper, the staging accounting, tracing, failpoints and the
# observatory's own
PORT_FAMILIES = {
    "karpenter_handled_errors_total", "karpenter_failpoints_fired_total",
    "karpenter_solver_kernel_dispatches_total", "karpenter_solver_staged_bytes",
    "karpenter_solver_packed_mask_bytes", "karpenter_solver_staged_pressure_evictions_total",
    "karpenter_scheduler_delta_dirty_fraction",
    "karpenter_disruption_device_dispatches_total", "karpenter_disruption_device_sweep_seconds",
    "karpenter_convex_solves_total", "karpenter_convex_fallbacks_total",
    "karpenter_convex_iterations", "karpenter_convex_bound_tighten_ratio",
    "karpenter_tracing_spans_total", "karpenter_tracing_slow_ticks_total",
    "karpenter_quality_optimality_gap", "karpenter_quality_bound_price_per_hour",
    "karpenter_quality_stranded_fraction", "karpenter_quality_fragmentation_index",
    "karpenter_device_hbm_bytes_in_use", "karpenter_device_hbm_bytes_limit",
    "karpenter_device_hbm_peak_bytes", "karpenter_device_hbm_headroom_fraction",
    "karpenter_profiler_captures_total", "karpenter_profiler_armed_ticks",
    "karpenter_flightdata_records_total", "karpenter_flightdata_flushes_total",
    # the wire (solver/rpc.py, solver/shm.py), delta shipping, the sidecar's
    # staging LRUs, the breaker and the wire's fallback counters
    "karpenter_wire_bytes_total", "karpenter_wire_transport_in_use",
    "karpenter_wire_payload_copies_total", "karpenter_wire_shm_ring_full_total",
    "karpenter_wire_shm_send_timeouts_total",
    "karpenter_scheduler_delta_solves_total", "karpenter_scheduler_delta_rows_shipped_total",
    "karpenter_scheduler_delta_payload_bytes", "karpenter_scheduler_delta_epoch_restages_total",
    "karpenter_solver_staged_evictions_total",
    "karpenter_scheduler_breaker_state", "karpenter_scheduler_breaker_transitions_total",
    "karpenter_scheduler_breaker_probes_total", "karpenter_scheduler_breaker_short_circuits_total",
    "karpenter_scheduler_pipeline_fallbacks_total", "karpenter_disruption_device_fallbacks_total",
    # the operator and its controllers (controllers/, kwok/, batcher/,
    # journal.py, fencing.py, overload.py) and the replay and shrinker (sim/)
    "karpenter_cloud_batcher_batch_size", "karpenter_cloud_batcher_batch_time_seconds",
    "karpenter_cloudprovider_instance_info",
    "karpenter_cloudprovider_instance_type_offering_available",
    "karpenter_disruption_device_bounded_sweeps_total", "karpenter_disruption_device_sets_total",
    "karpenter_fencing_rejected_total", "karpenter_garbage_collected_instances_total",
    "karpenter_ignored_pod_count", "karpenter_interruption_deferred_total",
    "karpenter_interruption_deleted_messages_total",
    "karpenter_interruption_received_messages_total",
    "karpenter_journal_open_intents", "karpenter_journal_writes_total",
    "karpenter_nodeclaims_created_total", "karpenter_nodeclaims_terminated_total",
    "karpenter_nodes_ready_count", "karpenter_overload_brownout_level",
    "karpenter_overload_brownout_transitions_total", "karpenter_overload_deferred_pods",
    "karpenter_overload_shed_total", "karpenter_overload_skipped_sweeps_total",
    "karpenter_overload_tick_overrun_ratio", "karpenter_overload_watchdog_escalations_total",
    "karpenter_pods_bound_total", "karpenter_recovery_sweep_duration_seconds",
    "karpenter_recovery_sweep_intents_total", "karpenter_scheduler_pipeline_overlap_fraction",
    "karpenter_scheduler_pipeline_ticks_total",
    "karpenter_scheduler_scheduling_duration_seconds",
    "karpenter_sim_divergences_total", "karpenter_sim_replay_events_total",
    "karpenter_sim_replay_ticks_total", "karpenter_sim_shrink_rounds_total", "karpenter_status_condition_count",
    "karpenter_status_condition_transitions_total",
    "karpenter_voluntary_disruption_decision_evaluation_duration_seconds",
    "karpenter_voluntary_disruption_decisions_total",
    # the cold-start layer (solver/aot.py, solver/kernels/build.py) and the
    # per-entry table (obs/jitstats.py)
    "karpenter_aot_precompiled_fraction", "karpenter_aot_dispatches_total",
    "karpenter_aot_fallbacks_total", "karpenter_aot_serialized_total",
    "karpenter_aot_loaded_total", "karpenter_aot_swept_dirs_total",
    "karpenter_jit_entry_dispatches_total", "karpenter_jit_entry_dispatch_seconds_total",
    "karpenter_jit_entry_compiles_total", "karpenter_jit_entry_compile_seconds_total",
    "karpenter_jit_entry_aot_compiles_total", "karpenter_jit_entry_aot_compile_seconds_total",
    "karpenter_compile_cache_hits_total", "karpenter_compile_cache_misses_total",
    "karpenter_compile_cache_bytes",
    # the fleet coalescer (fleet/coalesce.py): the per-tenant families
    "karpenter_tenant_dispatches_total", "karpenter_tenant_dispatch_seconds",
    "karpenter_tenant_window_size", "karpenter_tenant_refusals_total",
    "karpenter_tenant_breaker_state", "karpenter_tenant_breaker_trips_total",
    # the mesh (fleet/shard.py, fleet/topology.py, fleet/straggler.py)
    "karpenter_mesh_devices", "karpenter_mesh_sharded_dispatches_total",
    "karpenter_mesh_topology_epoch", "karpenter_mesh_topology_healthy_devices",
    "karpenter_mesh_topology_quarantined_devices", "karpenter_mesh_topology_transitions_total",
    "karpenter_mesh_reshards_total", "karpenter_mesh_reshard_seconds",
    "karpenter_mesh_stale_topology_solves_total",
    "karpenter_mesh_shard_watchdog_escalations_total",
    # the runtime witnesses (analysis/): the JAX families' names
    "karpenter_lockwitness_inversions_total", "karpenter_errflow_swallowed_total",
    "karpenter_jaxwitness_retraces_total", "karpenter_jaxwitness_host_transfers_total",
}
# the cold-start families keep the JAX help texts too (one runbook)
COLD_START_FAMILIES = sorted(n for n in PORT_FAMILIES
                             if n.startswith(("karpenter_aot_", "karpenter_jit_entry_",
                                              "karpenter_compile_cache_")))


class TestRegistry:
    def test_every_port_family_is_a_jax_family(self):
        port, jax_fams = families(tmetrics.REGISTRY), families(jmetrics.REGISTRY)
        differ = {name: (shape, jax_fams.get(name)) for name, shape in port.items()
                  if jax_fams.get(name) != shape}
        assert not differ, f"port families absent from, or shaped unlike, the JAX registry: {differ}"

    @pytest.mark.parametrize("name", COLD_START_FAMILIES)
    def test_cold_start_family_help_is_the_jax_text(self, name):
        assert tmetrics.REGISTRY._metrics[name].help == jmetrics.REGISTRY._metrics[name].help

    def test_the_port_registers_exactly_its_families(self):
        assert set(families(tmetrics.REGISTRY)) == PORT_FAMILIES
        # the port has no Pallas -> XLA pin, so no kernel-fallback family
        assert "karpenter_solver_kernel_fallbacks_total" not in families(tmetrics.REGISTRY)

    def test_exposition_format(self):
        reg = tmetrics.Registry()
        c = reg.counter("x_total", "a counter", labels=("site",))
        c.inc(site='a"b\n')
        h = reg.histogram("y_seconds", "a histogram", buckets=(0.5, 1.0))
        h.observe(0.7)
        want = jmetrics.Registry()
        want.counter("x_total", "a counter", labels=("site",)).inc(site='a"b\n')
        want.histogram("y_seconds", "a histogram", buckets=(0.5, 1.0)).observe(0.7)
        assert reg.expose() == want.expose()
        assert c.value(site='a"b\n') == 1.0


# -- failpoints: the same schedule in both registries ---------------------------------


SPECS = (
    "convex.rounding=error(RuntimeError):times=3",
    "rpc.convex.dispatch=error(RuntimeError):after=2:times=2",
    "solver.solve_begin=error(ValueError):p=0.4",
    "solver.solve_finish=kill_after(5)",
    "drill.latency=latency(0):p=0.5:times=4",
    "drill.drop=drop:p=0.7",
    "drill.crash=crash:after=7:times=1",
)
SITES = [s.split("=", 1)[0] for s in SPECS]


def fire_sequence(mod, seed, rounds=30):
    reg = mod.FailpointRegistry(seed=seed)
    reg.arm_spec(";".join(SPECS))
    seq = []
    for _ in range(rounds):
        for site in SITES:
            try:
                reg.eval(site)
                seq.append((site, None))
            except (Exception, mod.OperatorCrashed) as e:  # noqa: BLE001 -- the drill's payload
                seq.append((site, type(e).__name__, str(e)))
    return seq, {s: (reg.hits(s), reg.fires(s)) for s in SITES}


def fires_counted(metrics_mod):
    return {(s, a): metrics_mod.FAILPOINT_FIRES.value(site=s, action=a)
            for s in SITES for a in ("error", "latency", "crash")}


class TestFailpoints:
    @pytest.mark.parametrize("seed", [0, 7, 20_260_101])
    def test_same_schedule_same_seed(self, seed):
        before_t, before_j = fires_counted(tmetrics), fires_counted(jmetrics)
        got, want = fire_sequence(tfailpoints, seed), fire_sequence(jfailpoints, seed)
        assert got == want
        seq, counts = got
        assert any(e[1] is not None for e in seq) and any(e[1] is None for e in seq)
        assert ("drill.crash", "OperatorCrashed", "failpoint drill.crash crashed the operator") in seq
        # every fire counted in each package's FAILPOINT_FIRES, alike
        after_t, after_j = fires_counted(tmetrics), fires_counted(jmetrics)
        moved_t = {k: after_t[k] - before_t[k] for k in after_t}
        assert moved_t == {k: after_j[k] - before_j[k] for k in after_j}
        assert sum(moved_t.values()) == sum(fires for _, fires in counts.values())

    def test_env_arming_and_seed(self):
        env = {tfailpoints.ENV: "solver.solve_begin=error(ValueError):p=0.5",
               tfailpoints.SEED_ENV: "11"}
        assert (tfailpoints.ENV, tfailpoints.SEED_ENV) == (jfailpoints.ENV, jfailpoints.SEED_ENV)
        regs = [tfailpoints.FailpointRegistry(), jfailpoints.FailpointRegistry()]
        runs = []
        for reg in regs:
            reg.arm_from_env(env)
            assert reg.seed == 11 and reg.armed
            fired = []
            for _ in range(20):
                try:
                    reg.eval("solver.solve_begin")
                    fired.append(False)
                except ValueError:
                    fired.append(True)
            runs.append(fired)
        assert runs[0] == runs[1] and any(runs[0]) and not all(runs[0])

    @pytest.mark.parametrize("spec", ["nosite", "a=", "a=error:times", "a=error:bogus=1",
                                      "a=explode", "a=error(NoSuchError)"])
    def test_malformed_specs_fail_loudly(self, spec):
        for mod in (tfailpoints, jfailpoints):
            reg = mod.FailpointRegistry()
            with pytest.raises(ValueError):
                reg.arm_spec(spec)
                reg.eval(spec.split("=")[0])

    def test_corrupt_and_live(self):
        data = bytes(range(64))
        outs = []
        for mod in (tfailpoints, jfailpoints):
            reg = mod.FailpointRegistry(seed=3)
            reg.arm("frame", "corrupt", times=2)
            outs.append([reg.corrupt("frame", data) for _ in range(3)])
            assert reg.fires("frame") == 2
        assert outs[0] == outs[1] and outs[0][0] != data and outs[0][2] == data
        tfailpoints.FAILPOINTS.arm("drill.live", "error", times=1)
        try:
            assert tfailpoints.live("drill.live") is not None
            with pytest.raises(ConnectionError):
                tfailpoints.eval("drill.live")
            assert tfailpoints.live("drill.live") is None          # spent
        finally:
            tfailpoints.FAILPOINTS.reset()
        assert tfailpoints.live("drill.live") is None and not tfailpoints.FAILPOINTS.armed


# -- the shared families after the same solves and sweeps -----------------------------


def counter_values(mod):
    m = mod
    return {
        ("solves", "convex"): m.CONVEX_SOLVES.value(winner="convex"),
        ("solves", "ffd"): m.CONVEX_SOLVES.value(winner="ffd"),
        ("fallbacks", "rounding"): m.CONVEX_FALLBACKS.value(reason="rounding"),
        ("fallbacks", "dispatch"): m.CONVEX_FALLBACKS.value(reason="dispatch"),
        ("disrupt", "local"): m.DISRUPTION_DEVICE_DISPATCHES.value(path="local"),
        ("disrupt", "sweeps"): m.DISRUPTION_DEVICE_SWEEP_SECONDS._totals.get((), 0),
    }


def gauge_values(mod, quality_mod):
    return {
        "iterations": mod.CONVEX_ITERATIONS.value(),
        "tighten": mod.CONVEX_TIGHTEN.value(),
        "gap": quality_mod.QUALITY_GAP.value(),
        "bound": quality_mod.QUALITY_BOUND.value(),
        "stranded_cpu": quality_mod.QUALITY_STRANDED.value(resource="cpu"),
        "stranded_memory": quality_mod.QUALITY_STRANDED.value(resource="memory"),
        "fragmentation": quality_mod.QUALITY_FRAGMENTATION.value(),
    }


def delta(after, before):
    return {k: after[k] - before[k] for k in after}


class TestSharedFamilies:
    def test_same_values_after_the_same_sequence(self, catalog_items, port_items, failpoints):  # noqa: F811
        """Convex ticks won by either tier, both failpoint rungs, an FFD
        tick and two consolidation sweeps, in both packages in turn."""
        def run(pkg):
            solver = (TPUSolver(g_max=G, tier="convex") if pkg == "jax"
                      else TorchSolver(device="cpu", g_max=G, tier="convex"))
            ffd = TPUSolver(g_max=G) if pkg == "jax" else TorchSolver(device="cpu", g_max=G)
            pool = JNodePool("default") if pkg == "jax" else TNodePool("default")
            items = catalog_items if pkg == "jax" else port_items
            registry = failpoints if pkg == "jax" else tfailpoints.FAILPOINTS
            mod, qmod = (jmetrics, jquality) if pkg == "jax" else (tmetrics, tquality)
            before = counter_values(mod)
            gauges = []
            idx = 0 if pkg == "jax" else 1
            for name, drill in (("adversarial", None), ("random-0", None),
                                ("adversarial", "convex.rounding"),
                                ("adversarial", "rpc.convex.dispatch"), ("adversarial", None)):
                if drill is not None:
                    registry.arm(drill, "error", "RuntimeError", times=1)
                solver.solve(pool, items, world(name)[idx])
                registry.reset()
                gauges.append(gauge_values(mod, qmod))
            ffd.solve(pool, items, world("random-2")[idx])
            gauges.append(gauge_values(mod, qmod))
            engine = JEngine() if pkg == "jax" else TEngine(device="cpu")
            for kind in ("default", "spot-od"):
                spec = workload.rampdown_sweep_spec(
                    workload_result(), np.random.default_rng(3), n_cand=8)
                if pkg == "jax":
                    nodes, sets = jax_sweep(spec)
                else:
                    nodes, sets = workload.sweep_world(spec)
                pools, ovh = sweep_pools(pkg, kind)
                engine.evaluate(nodes, sets, pools=pools, catalogs={p.name: items for p in pools},
                                daemon_overhead=ovh)
            return delta(counter_values(mod), before), gauges

        got, want = run("torch"), run("jax")
        assert got[0] == want[0]
        # the dispatch rung never reaches the differential: no solve counted
        assert got[0][("solves", "convex")] == 2 and got[0][("solves", "ffd")] == 2
        assert got[0][("fallbacks", "rounding")] == 1 and got[0][("fallbacks", "dispatch")] == 1
        assert got[0][("disrupt", "local")] == got[0][("disrupt", "sweeps")] == 2
        for g, w in zip(got[1], want[1]):
            assert g == pytest.approx(w, rel=1e-6, abs=1e-6)


_TICK1 = {}


def workload_result():
    """A small port tick whose nodes the sweeps consolidate (built once)."""
    if not _TICK1:
        pods = workload.synth_pods(np.random.default_rng(5), workload.ZONES, 400, 1, 12)
        _TICK1["r"] = TorchSolver(device="cpu", g_max=G).solve(
            TNodePool("default"), workload.build_catalog_items(), pods)
    return _TICK1["r"]


# -- spans: the JAX package's names at the JAX call sites ------------------------------


def tree(root):
    out = []

    def walk(sp, depth):
        out.append((depth, sp.name))
        for child in sp.children:
            walk(child, depth + 1)

    walk(root, 0)
    return out


def lifted(root, drop=ttracing.PORT_SPANS):
    """tree(root) with the spans named in `drop` taken out, each one's
    children lifted into its parent in place."""
    out = []

    def walk(sp, depth):
        if sp.name in drop:
            for child in sp.children:
                walk(child, depth)
            return
        out.append((depth, sp.name))
        for child in sp.children:
            walk(child, depth + 1)

    walk(root, 0)
    return out


def spans(root):
    out, stack = [], [root]
    while stack:
        sp = stack.pop()
        out.append(sp)
        stack.extend(sp.children)
    return out


def in_order(root, name):
    """The spans called `name` under `root`, in tree (start) order."""
    out = []

    def walk(sp):
        if sp.name == name:
            out.append(sp)
        for child in sp.children:
            walk(child)

    walk(root)
    return out


# schedule() worlds by route: the tests/test_torch_schedule.py worlds, and
# the merged one with a tainted pool (the join mask inside `merge_masks`)
SCHEDULE_WORLDS = {
    "device": ROUTE_WORLDS["device"],
    "merged": ROUTE_WORLDS["merged"],
    "merged tainted": dict(seed=8, pools=TAINTED_POOLS, spread=0.3, nodes=2, n_templates=8),
    "oracle": ROUTE_WORLDS["oracle"],
}


def traced(tracing_mod, fn):
    with tracing_mod.trace("tick", force=True) as root:
        fn()
    return root


class TestSpans:
    @pytest.mark.parametrize("case", ["solve", "convex solve", "existing nodes"])
    def test_span_tree_equals_jax(self, case, catalog_items, port_items):  # noqa: F811
        tier = "convex" if case == "convex solve" else "ffd"
        js, ts = TPUSolver(g_max=G, tier=tier), TorchSolver(device="cpu", g_max=G, tier=tier)
        jp, tp = world("adversarial") if tier == "convex" else both_pods(3)
        kw_j, kw_t = {}, {}
        if case == "existing nodes":
            tick1 = ts.solve(TNodePool("default"), port_items, tp)
            specs = node_specs(workload.nodes_from_result(tick1))
            for _name, _labels, _alloc, used, _taints in specs[:4]:
                for k in used:
                    used[k] *= 0.5
            kw_j, kw_t = dict(existing_nodes=jax_nodes(specs)), dict(existing_nodes=port_nodes(specs))
        jroot = traced(jtracing, lambda: js.solve(JNodePool("default"), catalog_items, jp, **kw_j))
        troot = traced(ttracing, lambda: ts.solve(TNodePool("default"), port_items, tp, **kw_t))
        assert lifted(troot) == tree(jroot)
        names = {name for _, name in tree(troot)}
        assert {"encode", "dispatch_device", "device", "decode"} <= names
        assert {"prepare", "bound", "quality"} <= names
        if tier == "convex":
            assert {"dispatch_convex", "convex_fetch", "convex_round"} <= names
            assert troot.attributes["convex_winner"] == jroot.attributes["convex_winner"] == "convex"
        if case == "existing nodes":
            pack = next(sp for sp in troot.children if sp.name == "pack_existing")
            assert [c.name for c in pack.children] == [
                "pack_feasibility", "pack_headroom", "pack_device", "pack_assign"]
            assert pack.children[2].attributes["dispatch"] == {"disrupt_repack": "plain"}
            feas = pack.children[0].attributes
            assert 1 <= feas["feas_node_rows"] < feas["nodes"]
            assert feas["feas_pairs"] <= feas["classes"] * feas["feas_node_rows"]
        dispatch = next(sp for sp in troot.children if sp.name == "dispatch_device")
        assert dispatch.attributes["dispatch"] == {"ffd_solve_fused": "plain"}

    def test_wire_span_tree_equals_jax(self, catalog_items, port_items, tmp_path):  # noqa: F811
        """A traced wire solve: the server's echoed "device" and "fetch"
        stages graft under the client's "wire" span in both packages."""
        import tempfile

        from karpenter_tpu.solver import rpc as jrpc
        from karpenter_tpu_torch.solver import rpc as trpc

        d = tempfile.mkdtemp(prefix="kt-")
        servers = [jrpc.SolverServer(path=f"{d}/j.sock").start(),
                   trpc.SolverServer(path=f"{d}/t.sock", device="cpu").start()]
        clients = [jrpc.SolverClient(path=f"{d}/j.sock", timeout=60.0),
                   trpc.SolverClient(path=f"{d}/t.sock", timeout=60.0)]
        try:
            js = TPUSolver(g_max=G, client=clients[0], breaker=False)
            ts = TorchSolver(device="cpu", g_max=G, client=clients[1], breaker=False)
            jp, tp = both_pods(3)
            jroot = traced(jtracing, lambda: js.solve(JNodePool("default"), catalog_items, jp))
            troot = traced(ttracing, lambda: ts.solve(TNodePool("default"), port_items, tp))
        finally:
            for c in clients:
                c.close()
            for srv in servers:
                srv.stop()
                srv._thread.join(timeout=10)
        assert lifted(troot) == tree(jroot)
        wire = [c for c in troot.children if c.name == "wire"]
        assert wire and [g.name for g in wire[0].children] == ["device", "fetch"]
        assert all(g.attributes["remote"] for g in wire[0].children)
        assert {"wire_dispatch", "encode", "decode"} <= {name for _, name in tree(troot)}

    def test_schedule_groups_and_routes_at_the_root(self, small_items):  # noqa: F811
        w = build("torch", fuzz_spec(2, spread=0.0, nodes=3), small_items)
        ts = TorchSolver(device="cpu", g_max=G)
        root = traced(ttracing, lambda: ts.schedule(w.scheduler("price"), list(w.pods)))
        assert ts.last_route["path"] == "device"
        names = [c.name for c in root.children]
        assert names[:2] == ["group", "route"] and names.count("route") == 2, names
        group = root.children[0]
        assert {"group_classes", "group_dirty", "group_dirty_fraction"} <= set(group.attributes)
        assert group.attributes["group_classes"] == ts.last_group_stats["classes"]
        assert not any(k.startswith("group_") for k in root.attributes)
        assert "prepare" in names and "pack_existing" in names

    @pytest.mark.parametrize("case", list(SCHEDULE_WORLDS))
    def test_schedule_span_tree_equals_jax(self, case, small_items, monkeypatch):  # noqa: F811
        """A traced schedule() on each route: the JAX tree once the port's
        spans are lifted out; `route` names the path taken; the merged
        route's masks open under `encode` with its pools, columns,
        classes and memo lookups, the taint gate under them only where
        a pool is tainted, kernel A's layout on the dispatch span, and
        every price solve unifies envelopes under `encode`."""
        from karpenter_tpu_torch.scheduling.taints import tolerates_all
        from karpenter_tpu_torch.solver import encode as tencode
        from karpenter_tpu_torch.solver import multipool as tmultipool
        from karpenter_tpu_torch.solver.kernels import ffd_scan as tffd_scan

        gated = []              # the gate's class rows that tolerate not every pool taint
        join_mask = tmultipool.join_allowed_mask

        def recording(classes, pools, *args):
            taints = [tt for p in pools for tt in p.template.taints]
            gated.append(sum(not tolerates_all(pc.pods[0].tolerations, taints) for pc in classes))
            return join_mask(classes, pools, *args)

        monkeypatch.setattr(tmultipool, "join_allowed_mask", recording)
        path = case.split()[0]
        kw = dict(SCHEDULE_WORLDS[case])
        spec = fuzz_spec(kw.pop("seed"), **kw)
        j, t = build("jax", spec, small_items), build("torch", spec, small_items)
        js, ts = TPUSolver(g_max=G), TorchSolver(device="cpu", g_max=G)
        jroot = traced(jtracing, lambda: js.schedule(j.scheduler("price"), list(j.pods)))
        troot = traced(ttracing, lambda: ts.schedule(t.scheduler("price"), list(t.pods)))
        assert lifted(troot) == tree(jroot)
        assert ts.last_route["path"] == js.last_route["path"] == path
        routes = [sp for sp in troot.children if sp.name == "route"]
        assert routes[0].attributes["path"] == path
        assert not any("path" in sp.attributes for sp in routes[1:])
        encodes = [sp for sp in spans(troot) if sp.name == "encode"]
        masks = [sp for sp in spans(troot) if sp.name == "merge_masks"]
        joins = [sp for sp in spans(troot) if sp.name == "join_masks"]
        envelopes = [sp for sp in spans(troot) if sp.name == "envelopes"]
        assert len(encodes) == (0 if path == "oracle" else 1)
        assert [[c.name for c in sp.children if c.name == "envelopes"] for sp in encodes] == [
            ["envelopes"] for _ in encodes]
        assert len(envelopes) == len(encodes)
        # the taint gate opens only where a merged pool is tainted
        assert len(joins) == (1 if case == "merged tainted" else 0)
        if path != "merged":
            assert masks == []
            return
        # one column a (pool, type) the pool's capacity type offers
        items = small_items["torch"]
        columns = sum(any(o.capacity_type == ct and o.available for o in it.offerings)
                      for ct in ("spot", "on-demand") for it in items)
        assert [c.name for c in encodes[0].children] == ["merge_masks", "envelopes"]
        classes = encodes[0].attributes["classes"]
        # a fresh solver's first tick: no class row has an opening pool memoised
        assert masks[0].attributes == {"pools": 2, "columns": columns, "classes": classes,
                                       "rows": classes, "rows_hit": 0}
        assert masks[0].children == joins
        if joins:
            # one tainted pool: a class row is gated where its pods do not
            # tolerate that pool's taint
            assert joins[0].attributes == {"tainted_pools": 1, "classes": classes,
                                           "gated_rows": gated[0]}
            assert 0 < gated[0] <= classes
        dispatch = next(sp for sp in troot.children if sp.name == "dispatch_device")
        k_pad = max(128, -(-columns // 128) * 128)
        assert dispatch.attributes["scan_layout"] == tffd_scan.layout(G, k_pad, tencode.R)

    @pytest.mark.parametrize("g_max, k_pad, want", [(1024, 1920, "scratch"), (1024, 1280, "lean"),
                                                    (1024, 640, "resident")])
    def test_the_dispatch_span_names_kernel_a_layout(self, g_max, k_pad, want):
        """Kernel A's layout at a solve's shape lands on the span that
        records its dispatch: the three pools' K=1920 at the benchmark's
        G=1024 takes the scratch layout, two pools' K=1280 the lean one."""
        from karpenter_tpu_torch.solver import encode as tencode
        from karpenter_tpu_torch.solver import service

        with ttracing.trace("tick", force=True) as root:
            with ttracing.span("dispatch_device") as sp:
                service._note_scan_layout(g_max, k_pad, tencode.R)
        service._note_scan_layout(g_max, k_pad, tencode.R)        # no trace: nothing
        assert sp.attributes == {"scan_layout": want}
        assert "scan_layout" not in root.attributes

    @pytest.mark.parametrize("route", ["device", "merged"])
    def test_dense_refetch_counts_and_decides_alike(self, route, small_items, monkeypatch):  # noqa: F811
        """Every `device` span carries the sparse take's true pairs and its
        budget; a budget forced below them refetches densely (a second
        `device` span, `refetch="dense"`, the same counters) and decides
        as the run within budget."""
        from karpenter_tpu_torch.solver import ffd as tffd

        kw = dict(ROUTE_WORLDS[route])
        spec = fuzz_spec(kw.pop("seed"), **kw)
        w = build("torch", spec, small_items)

        def run():
            ts = TorchSolver(device="cpu", g_max=G)
            out = []
            root = traced(ttracing, lambda: out.append(ts.schedule(w.scheduler("price"),
                                                                   list(w.pods))))
            return result_sig(out[0]), ts.last_route, root

        sig, last_route, root = run()
        with monkeypatch.context() as m:
            m.setattr(tffd, "nnz_budget", lambda c_pad, g_max: 1)
            forced_sig, forced_route, forced = run()
        assert forced_sig == sig and forced_route == last_route
        assert last_route["path"] == route
        (dev,) = [sp for sp in spans(root) if sp.name == "device"]
        (enc,) = [sp for sp in spans(root) if sp.name == "encode"]
        budget = tffd.nnz_budget(enc.attributes["c_pad"], G)
        assert dev.attributes == {"take_pairs": dev.attributes["take_pairs"], "take_budget": budget}
        assert 1 < dev.attributes["take_pairs"] <= budget
        first, refetch = in_order(forced, "device")
        counters = {"take_pairs": dev.attributes["take_pairs"], "take_budget": 1}
        assert first.attributes == counters
        assert refetch.attributes == dict(counters, refetch="dense")

    def test_a_span_keeps_every_dispatch(self):
        from karpenter_tpu_torch.solver import service

        with ttracing.trace("tick", force=True) as root:
            with ttracing.span("dispatch_device") as sp:
                service._note_dispatch("ffd_solve_fused", "aot")
                service._note_dispatch("convex_relax", "cuda")
            service._note_dispatch("disrupt_repack", "plain")
        service._note_dispatch("ffd_solve_fused", "plain")         # no trace: nothing
        assert sp.attributes["dispatch"] == {"ffd_solve_fused": "aot", "convex_relax": "cuda"}
        assert root.attributes["dispatch"] == {"disrupt_repack": "plain"}

    def test_port_spans_are_not_flight_stages(self):
        assert not set(ttracing.PORT_SPANS) & set(tflight.STAGE_NAMES)
        assert len(set(ttracing.PORT_SPANS)) == len(ttracing.PORT_SPANS)

    def test_spans_mirror_as_profiler_ranges(self, port_items, tmp_path):  # noqa: F811
        """Under a live capture every local span is one karpenter::<name>
        range, each child's interval inside its parent's."""
        from torch.profiler import ProfilerActivity, profile

        ts = TorchSolver(device="cpu", g_max=G)
        nodes = workload.nodes_from_result(ts.solve(TNodePool("default"), port_items,
                                                    both_pods(3)[1]))
        tp = both_pods(4)[1]
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            root = traced(ttracing, lambda: ts.solve(TNodePool("default"), port_items, tp,
                                                     existing_nodes=nodes))
        prof.export_chrome_trace(str(tmp_path / "trace.json"))
        with open(tmp_path / "trace.json") as f:
            events = [e for e in json.load(f)["traceEvents"]
                      if e.get("ph") == "X" and e.get("cat") == "user_annotation"
                      and e.get("name", "").startswith(ttracing.RANGE_PREFIX)]
        events.sort(key=lambda e: (float(e["ts"]), -float(e["dur"])))
        # tree order is start order
        order = []

        def walk(sp):
            order.append(sp)
            for child in sp.children:
                walk(child)

        walk(root)
        assert "pack_feasibility" in {sp.name for sp in order}
        assert [e["name"] for e in events] == [ttracing.RANGE_PREFIX + sp.name for sp in order]
        of = {id(sp): e for sp, e in zip(order, events)}
        eps = 0.01      # us: the export rounds start and length to the ns
        for sp in order:
            pa = of[id(sp)]
            for child in sp.children:
                ch = of[id(child)]
                assert float(pa["ts"]) - eps <= float(ch["ts"])
                assert (float(ch["ts"]) + float(ch["dur"])
                        <= float(pa["ts"]) + float(pa["dur"]) + eps), (sp.name, child.name)
        assert all(sp._range is None for sp in order)

    def test_no_capture_no_range(self, port_items, monkeypatch):  # noqa: F811
        """Tracing on and no capture live: not one profiler range opens;
        with a capture live, one a span."""
        from torch.autograd import profiler as autograd_profiler
        from torch.profiler import ProfilerActivity, profile

        opened = []
        real = autograd_profiler.record_function

        class Counting(real):
            def __enter__(self):
                opened.append(self.name)
                return super().__enter__()

        monkeypatch.setattr(autograd_profiler, "record_function", Counting)
        ts = TorchSolver(device="cpu", g_max=G)
        nodes = workload.nodes_from_result(ts.solve(TNodePool("default"), port_items,
                                                    both_pods(3)[1]))
        tp = both_pods(4)[1]
        root = traced(ttracing, lambda: ts.solve(TNodePool("default"), port_items, tp,
                                                 existing_nodes=nodes))
        assert len(spans(root)) > 10 and opened == []
        with profile(activities=[ProfilerActivity.CPU]):
            root = traced(ttracing, lambda: ts.solve(TNodePool("default"), port_items, tp,
                                                     existing_nodes=nodes))
        assert sorted(opened) == sorted(ttracing.RANGE_PREFIX + sp.name for sp in spans(root))

    def test_sweep_spans_in_order(self, port_items):  # noqa: F811
        """A traced evaluate opens the engine's stages under its caller's
        span, in order, and decides as an untraced one."""
        ts = TorchSolver(device="cpu", g_max=G)
        tick1 = ts.solve(TNodePool("default"), port_items, both_pods(4)[1])
        spec = workload.rampdown_sweep_spec(tick1, np.random.default_rng(1), n_cand=8)
        s_nodes, s_sets = workload.sweep_world(spec)
        pools, ovh = workload.sweep_pools("spot-od")
        engine = TEngine(solver=ts)

        def sweep():
            return engine.evaluate(s_nodes, s_sets, pools=pools,
                                   catalogs={p.name: port_items for p in pools},
                                   daemon_overhead=ovh)

        plain = sweep()
        got = []
        with ttracing.trace("tick", force=True) as root:
            with ttracing.span("disruption") as caller:
                got.append(sweep())
        assert got[0] == plain
        assert [c.name for c in root.children] == ["disruption"]
        names = [c.name for c in caller.children]
        assert names[:3] == ["encode_sets", "pool_contexts", "repack"], names
        encode_sets = caller.children[0].attributes
        assert 1 <= encode_sets["feas_node_rows"] <= len(s_nodes)
        assert encode_sets["feas_pairs"] % encode_sets["feas_node_rows"] == 0
        assert names[-1] == "assemble" and len(names) >= 5
        assert set(names[3:-1]) == {"replace"} and len(names) - 4 <= len(pools)

    def test_disabled_tracing_builds_nothing(self, port_items):  # noqa: F811
        assert not ttracing.TRACER.enabled
        assert ttracing.trace("tick") is ttracing.NOOP and ttracing.span("x") is ttracing.NOOP
        ts = TorchSolver(device="cpu", g_max=G)
        ts.solve(TNodePool("default"), port_items, both_pods(3)[1])
        assert ttracing.TRACER.current() is None

    def test_slow_tick_recorder_and_stats(self):
        t = [0.0]
        tracer = ttracing.Tracer(enabled=True, clock=lambda: t[0], slow_ms=5.0)
        before = tmetrics.TRACE_SPANS.value(name="encode")
        with tracer.trace("tick"):
            with tracer.span("encode"):
                t[0] += 0.010
        dump = tracer.recorder.dump()
        assert len(dump["slow"]) == 1 and dump["worst"]["name"] == "tick"
        assert tmetrics.TRACE_SPANS.value(name="encode") == before + 1


# -- obs/hbm.py -------------------------------------------------------------------------


@pytest.fixture
def stats_provider():
    """Both packages' hbm modules fed by one injected provider."""
    state = {"in_use": 10}

    def provider():
        return {"cuda:0": {"bytes_in_use": state["in_use"], "bytes_limit": 100,
                           "peak_bytes_in_use": 60}}

    for mod in (thbm, jhbm):
        mod.set_stats_provider(provider)
    yield state
    for mod in (thbm, jhbm):
        mod.set_stats_provider(None)


class TestHbm:
    def test_poll_matches_jax(self, stats_provider):
        for in_use in (10, 95, 40):
            stats_provider["in_use"] = in_use
            got, want = thbm.poll(max_age_s=0), jhbm.poll(max_age_s=0)
            assert got == want
            assert got["devices"]["cuda:0"]["peak_bytes"] == max(60, 95 if in_use != 10 else 60)
            for g in ("HBM_IN_USE", "HBM_LIMIT", "HBM_PEAK"):
                assert getattr(thbm, g).value(device="cuda:0") == getattr(jhbm, g).value(device="cuda:0")
            assert thbm.HBM_HEADROOM.value() == pytest.approx(1 - in_use / 100)
        assert thbm.under_pressure() is jhbm.under_pressure() is False
        stats_provider["in_use"] = 95
        thbm.poll(max_age_s=0), jhbm.poll(max_age_s=0)
        assert thbm.under_pressure() is jhbm.under_pressure() is True
        assert thbm.peak_bytes_max() == jhbm.peak_bytes_max() == 95

    def test_no_ledger_on_the_cpu(self):
        """Without an initialized CUDA context the real walk polls nothing."""
        thbm.set_stats_provider(None)
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            pytest.skip("this process holds a CUDA context")
        assert thbm.poll(max_age_s=0) == {"devices": {}, "headroom_fraction": None}
        assert thbm.under_pressure() is False

    def test_pressure_evicts_the_catalog_lru(self, stats_provider, catalog_items, port_items):  # noqa: F811
        """Three catalogs staged under pressure: the LRU shrinks to one
        entry each time, counted, as TPUSolver's does."""
        moved = []
        for pkg in ("torch", "jax"):
            solver = TorchSolver(device="cpu", g_max=G) if pkg == "torch" else TPUSolver(g_max=G)
            mod = tmetrics if pkg == "torch" else jmetrics
            items = port_items if pkg == "torch" else catalog_items
            before = mod.SOLVER_STAGED_PRESSURE_EVICTIONS.value(kind="catalog")
            # distinct list objects, kept alive: the LRU keys on identity
            lists = [list(items) for _ in range(5)]
            stats_provider["in_use"] = 10
            for mod_ in (thbm, jhbm):
                mod_.poll(max_age_s=0)
            for catalog in lists[:2]:
                solver._catalog(catalog)
            assert len(solver._catalog_cache) == 2          # capacity only
            stats_provider["in_use"] = 95
            for mod_ in (thbm, jhbm):
                mod_.poll(max_age_s=0)
            for catalog in lists[2:]:
                solver._catalog(catalog)
                assert len(solver._catalog_cache) == 1
            moved.append(mod.SOLVER_STAGED_PRESSURE_EVICTIONS.value(kind="catalog") - before)
        assert moved[0] == moved[1] == 4

    def test_staged_bytes_by_kind(self, port_items, catalog_items):  # noqa: F811
        jp, tp = both_pods(2)
        ts, js = TorchSolver(device="cpu", g_max=G), TPUSolver(g_max=G, packed_masks=True)
        ts.solve(TNodePool("default"), port_items, tp)
        js.solve(JNodePool("default"), catalog_items, jp)
        got, want = ts.staged_bytes_by_kind(), js.staged_bytes_by_kind()
        assert sorted(got) == sorted(want)
        assert got["catalog"] > 0 and got["solve_temporaries"] > 0
        # the packed masks: one bit a column against a byte
        assert got["class_masks"] * 8 <= got["class_masks_full_equiv"]
        assert got["class_masks_full_equiv"] == want["class_masks_full_equiv"]
        assert tmetrics.SOLVER_STAGED_BYTES.value(kind="catalog") == got["catalog"]
        assert tmetrics.SOLVER_PACKED_MASK_BYTES.value(form="full_equiv") == got["class_masks_full_equiv"]

    def test_sum_nbytes(self):
        a, t = np.zeros((3, 4), np.float32), torch.zeros(5, dtype=torch.int64)
        for obj, n in ((a, 48), (t, 40), ((a, t), 88), ({"x": a, "y": [t]}, 88), (None, 0)):
            assert thbm.sum_nbytes(obj) == n


# -- obs/profiler.py --------------------------------------------------------------------


class TestProfiler:
    def test_capture_brackets_the_armed_ticks(self, tmp_path, port_items):  # noqa: F811
        prof = tprofiler.ProfilerCapture()
        ts = TorchSolver(device="cpu", g_max=G)
        _, tp = both_pods(1)
        doc = prof.request(2, out_dir=str(tmp_path))
        assert doc["armed_ticks"] == 2 and doc["out_dir"].endswith("capture-1")
        for _ in range(3):
            prof.on_tick_start()
            ts.solve(TNodePool("default"), port_items, tp)
            prof.on_tick_end()
        st = prof.describe()
        assert st["captures"] == 1 and st["errors"] == 0 and not st["active"]
        with open(tmp_path / "capture-1" / tprofiler.TRACE_FILE) as f:
            events = json.load(f)["traceEvents"]
        assert any("ffd" in str(e.get("name", "")) or "aten::" in str(e.get("name", ""))
                   for e in events)

    def test_idle_and_reset(self, tmp_path):
        prof = tprofiler.ProfilerCapture()
        prof.on_tick_start()
        prof.on_tick_end()
        assert prof.describe()["captures"] == 0 and not prof.describe()["active"]
        prof.request(5000, out_dir=str(tmp_path))
        assert prof.describe()["armed_ticks"] == tprofiler.MAX_TICKS_PER_CAPTURE
        prof.reset()
        assert prof.describe()["armed_ticks"] == 0 and tprofiler.PROFILER_ARMED.value() == 0.0


# -- obs/flight.py ----------------------------------------------------------------------


class TestFlight:
    def test_tick_record_keys_match_jax(self, catalog_items, port_items):  # noqa: F811
        jp, tp = both_pods(6)
        js, ts = TPUSolver(g_max=G, packed_masks=True), TorchSolver(device="cpu", g_max=G)
        jroot = traced(jtracing, lambda: js.solve(JNodePool("default"), catalog_items, jp))
        troot = traced(ttracing, lambda: ts.solve(TNodePool("default"), port_items, tp))
        got = tflight.build_tick_record(troot, troot.start, solver=ts)
        want = jflight.build_tick_record(jroot, jroot.start, solver=js)
        # shed_total appears once a process has shed (each package's own count)
        assert set(got) - {"shed_total"} == set(want) - {"shed_total"}
        assert sorted(got["stages_ms"]) == sorted(want["stages_ms"]) == ["decode", "device", "encode"]
        assert got["device_ms"] == got["stages_ms"]["device"]
        assert sorted(got["staged_bytes"]) == sorted(want["staged_bytes"])
        assert sorted(got["quality"]) == sorted(want["quality"])
        assert got["optimality_gap"] == pytest.approx(want["optimality_gap"], rel=1e-6, abs=1e-6)
        # the operator's fields: the fleet counters read each package's own
        # registry; the brownout rung and the breaker only when given
        for key in ("deferred_pods", "nodes_ready", "pods_bound_total"):
            assert isinstance(got[key], int) and isinstance(want[key], int)
        assert not {"brownout_level", "breaker"} & set(got)
        assert tflight.STAGE_NAMES == jflight.STAGE_NAMES

    def test_ring_and_black_box(self, tmp_path):
        rec = tflight.FlightDataRecorder(capacity=3)
        for i in range(5):
            rec.record(tflight.build_tick_record(None, 0.0, clock=lambda: 1.0))
        assert [r["seq"] for r in rec.dump()["records"]] == [3, 4, 5]
        path = rec.flush_blackbox("manual", path=str(tmp_path / "fd.jsonl"))
        lines = [json.loads(line) for line in open(path)]
        assert lines[0]["flight_data"] == 1 and lines[0]["reason"] == "manual"
        assert lines[0]["records"] == 3 and [r["seq"] for r in lines[1:]] == [3, 4, 5]
        assert rec.dump()["flushes"] == 1 and rec.last()["seq"] == 5
        assert tflight.FlightDataRecorder().flush_blackbox("manual", str(tmp_path / "x")) is None


# -- analysis/sync_witness.py -----------------------------------------------------------


@pytest.fixture
def fake_sync(monkeypatch):
    """Every Tensor.cpu() warns as torch's sync debug mode does on the card."""
    real = torch.Tensor.cpu

    def cpu(self, *a, **k):
        warnings.warn(f"{sync_witness.SYNC_MESSAGE} (fake hook)", UserWarning)
        return real(self, *a, **k)

    monkeypatch.setattr(torch.Tensor, "cpu", cpu)
    sync_witness.reset()
    yield
    sync_witness.reset()


class TestSyncWitness:
    def test_the_tick_syncs_only_at_its_designed_fetches(self, fake_sync, port_items):  # noqa: F811
        """A tick with existing nodes, a convex tick and a sweep: every
        Tensor.cpu() on their paths is a sanctioned fetch."""
        _, tp = both_pods(4)
        ts = TorchSolver(device="cpu", g_max=G)
        cx = TorchSolver(device="cpu", g_max=G, tier="convex")
        tick1 = ts.solve(TNodePool("default"), port_items, tp)                # not hot
        assert sync_witness.stats()["sanctioned_fetches"] == 0
        nodes = workload.nodes_from_result(tick1)
        spec = workload.rampdown_sweep_spec(tick1, np.random.default_rng(1), n_cand=8)
        s_nodes, s_sets = workload.sweep_world(spec)
        pools, ovh = workload.sweep_pools("spot-od")
        with sync_witness.hot("tick"):
            ts.solve(TNodePool("default"), port_items, both_pods(5)[1], existing_nodes=nodes)
            cx.solve(TNodePool("default"), port_items, world("adversarial")[1])
            TEngine(solver=ts).evaluate(s_nodes, s_sets, pools=pools,
                                        catalogs={p.name: port_items for p in pools},
                                        daemon_overhead=ovh)
        st = sync_witness.stats()
        # pack_existing, fetch_fused, fetch_bound; fetch_fused, fetch_relax
        # (x, trace), fetch_bound; the sweep's totals and its passes
        assert st["unsanctioned"] == {} and st["hot"] == 0, st
        assert st["sanctioned_fetches"] >= 9, st

    def test_unsanctioned_sites_and_forwarding(self, fake_sync):
        with sync_witness.hot("outer"), sync_witness.hot("inner"):
            torch.zeros(3).cpu()
            with pytest.warns(UserWarning, match="unrelated"):
                warnings.warn("unrelated", UserWarning)
            assert sync_witness.stats()["hot"] == 2
        torch.zeros(3).cpu()                                  # outside hot(): not booked
        st = sync_witness.stats()
        assert st == {"sanctioned_fetches": 0, "unsanctioned": {"<outside-package>": 1},
                      "aot_exempt": 0, "hot": 0}

    def test_sanctioned_manifest_names_real_functions(self):
        import importlib

        for path, fn in sync_witness.SANCTIONED_FETCH:
            mod = importlib.import_module(path[:-3].replace("/", "."))
            src = open(mod.__file__).read()
            assert f"def {fn}(" in src, (path, fn)


def test_decisions_unchanged_by_tracing(port_items):  # noqa: F811
    """Tracing on or off, under a live profiler capture or not, the tick
    decides the same."""
    from torch.profiler import ProfilerActivity, profile

    _, tp = both_pods(11)
    ts = TorchSolver(device="cpu", g_max=G)
    plain = decision_sig(ts.solve(TNodePool("default"), port_items, tp))
    with ttracing.trace("tick", force=True):
        traced_sig = decision_sig(ts.solve(TNodePool("default"), port_items, tp))
    assert traced_sig == plain
    with profile(activities=[ProfilerActivity.CPU]):
        with ttracing.trace("tick", force=True):
            profiled_sig = decision_sig(ts.solve(TNodePool("default"), port_items, tp))
    assert profiled_sig == plain

