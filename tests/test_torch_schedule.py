"""TorchSolver.schedule against TPUSolver.schedule: the same routes and
the same decisions.

Each world is one spec (tests/test_torch_oracle.py `fuzz_spec`) built into
both packages; both solvers schedule it through a fresh Scheduler of
their own package. `last_route["path"]` and `result_sig` (decision_sig
plus each group's pool and requirements) must be equal, for each of the
six routes and both objectives. Worlds carry existing nodes with bound
pods (spread seeds), daemonset overhead and zone spread where the route
admits them. Tolerance: exact.
"""
import numpy as np
import pytest

import jax  # noqa: F401  -- both frameworks in one process; data crosses as numpy
import torch  # noqa: F401

from karpenter_tpu.solver import encode as jencode
from karpenter_tpu.solver.service import TPUSolver
from karpenter_tpu_torch.solver import encode as tencode
from karpenter_tpu_torch.solver.service import TorchSolver
from tests.test_packing import catalog_items  # noqa: F401
from karpenter_tpu_torch import workload
from karpenter_tpu_torch.apis import NodePool as TNodePool
from karpenter_tpu_torch.scheduling import Requirement as TRequirement
from karpenter_tpu_torch.solver.oracle import Scheduler as TScheduler
from tests.test_torch_catalog import jax_nodes, node_specs, port_items, port_nodes  # noqa: F401
from tests.test_torch_oracle import (  # noqa: F401
    MV_POOLS, SPOT_OD_POOLS, TAINTED_POOLS, build, fuzz_spec, result_sig, small_items,
)

# small tensors: one intra-op thread per test worker (several workers share the cores)
torch.set_num_threads(1)

G = 64

# route -> the spec that lands there (each checked to carry the route's
# partitions: a suffix, a minValues prefix, overlapping pools, ...)
ROUTE_WORLDS = {
    "device": dict(seed=2, spread=0.6, nodes=3, bound_spread=True, overhead=True),
    "device+suffix": dict(seed=4, affinity=0.35, preferences=0.15, nodes=2, n_templates=9),
    "prefix+device": dict(seed=6, pools=MV_POOLS, arch_pin=True, nodes=2, n_templates=8),
    "prefix+device+suffix": dict(seed=1, pools=MV_POOLS, arch_pin=True, affinity=0.3,
                                 nodes=2, n_templates=9),
    "merged": dict(seed=3, pools=SPOT_OD_POOLS, spread=0.5, nodes=2, bound_spread=True,
                   overhead=True),
    "oracle": dict(seed=5, hostname_spread=True, nodes=2),
}


def schedule_both(items, spec, objective, pipelined=False):
    """(JAX result sig, JAX route, port result sig, port route)."""
    j, t = build("jax", spec, items), build("torch", spec, items)
    js = TPUSolver(g_max=G, objective=objective)
    ts = TorchSolver(device="cpu", g_max=G, objective=objective)
    want = result_sig(js.schedule(j.scheduler(objective), list(j.pods)))
    if pipelined:
        got = result_sig(ts.schedule_finish(ts.schedule_begin(t.scheduler(objective), list(t.pods))))
    else:
        got = result_sig(ts.schedule(t.scheduler(objective), list(t.pods)))
    return want, js.last_route, got, ts.last_route


class TestRoutes:
    @pytest.mark.parametrize("objective", ["price", "fit"])
    @pytest.mark.parametrize("route", list(ROUTE_WORLDS))
    def test_route(self, small_items, route, objective):
        kw = dict(ROUTE_WORLDS[route])
        spec = fuzz_spec(kw.pop("seed"), **kw)
        want, jroute, got, troute = schedule_both(small_items, spec, objective)
        assert jroute["path"] == route, jroute
        assert troute == jroute
        assert got == want
        placed = want[0]
        assert placed[0] or placed[1], "the world placed nothing"

    @pytest.mark.parametrize("objective", ["price", "fit"])
    def test_merged_with_a_tainted_pool(self, small_items, objective):
        """The on-demand pool carries a taint: pods that do not tolerate it
        may neither open nor join there (the join mask's gate)."""
        spec = fuzz_spec(8, pools=TAINTED_POOLS, spread=0.3, nodes=2, n_templates=8)
        want, jroute, got, troute = schedule_both(small_items, spec, objective)
        assert jroute["path"] == "merged" and troute == jroute
        assert got == want

    @pytest.mark.parametrize("objective", ["price", "fit"])
    @pytest.mark.parametrize("seed", range(6))
    def test_fuzz(self, small_items, seed, objective):
        """TestDifferentialFuzz-shaped worlds with affinity, preferences,
        existing nodes seeding spread counts, and overhead mixed in: each
        takes whatever route the router picks, on both sides alike."""
        spec = fuzz_spec(100 + seed, affinity=0.2, preferences=0.1, bound_spread=True,
                         overhead=seed % 2 == 0)
        want, jroute, got, troute = schedule_both(small_items, spec, objective)
        assert troute == jroute
        assert got == want


class TestPipelined:
    @pytest.mark.parametrize("route", ["device", "device+suffix", "merged"])
    def test_begin_finish_equals_schedule(self, small_items, route):
        """schedule_begin/schedule_finish decides as schedule does on the
        JAX side; the single-pool device world is the one that pipelines."""
        kw = dict(ROUTE_WORLDS[route])
        spec = fuzz_spec(kw.pop("seed"), **kw)
        want, jroute, got, troute = schedule_both(small_items, spec, "price", pipelined=True)
        assert troute == jroute and troute["path"] == route
        assert got == want


def jax_pods(pods):
    """The port's pods rebuilt as the JAX package's: same names, requests,
    selectors, tolerations, labels, spread and affinity terms."""
    from karpenter_tpu.apis import Pod, PodAffinityTerm, TopologySpreadConstraint
    from karpenter_tpu.scheduling import Resources, Toleration

    return [
        Pod(p.metadata.name, requests=Resources.from_base_units(dict(p.requests.items())),
            node_selector=dict(p.node_selector),
            tolerations=[Toleration(t.key, t.operator, t.value, t.effect) for t in p.tolerations],
            labels=dict(p.metadata.labels),
            topology_spread=[TopologySpreadConstraint(t.max_skew, t.topology_key,
                                                      t.when_unsatisfiable, dict(t.label_selector))
                             for t in p.topology_spread],
            affinity_terms=[PodAffinityTerm(dict(t.label_selector), t.topology_key, t.anti)
                            for t in p.affinity_terms])
        for p in pods
    ]


def main_path_pools(which, merged):
    """The slice's pools in one package: `default`, or the weighted spot /
    on-demand pair."""
    if which == "jax":
        from karpenter_tpu.apis import NodePool
        from karpenter_tpu.scheduling import Requirement
    else:
        NodePool, Requirement = TNodePool, TRequirement
    if not merged:
        return [NodePool("default")]
    return [NodePool(name, weight=w, requirements=[
        Requirement("karpenter.sh/capacity-type", "In", [name])])
        for name, w in (("spot", 100), ("on-demand", 10))]


class TestMainPathWorlds:
    """The worlds of chip_smoke.py phase `schedule` at a small size, over
    the full catalog: the mixed-affinity batch, two zone-spread ticks
    (the second seeded with the first's pods on its nodes) and the
    merged spot / on-demand batch."""

    def run(self, catalog_items, port_items, pods, merged=False, nodes=(), node_pods=(),
            objective="price"):
        """Schedule `pods` in both packages; `nodes` are node specs and
        `node_pods` the pods bound to each, which seed the topology."""
        out = []
        for which, items, batch, node_list in (
            ("jax", catalog_items, jax_pods(pods), jax_nodes(nodes)),
            ("torch", port_items, list(pods), port_nodes(nodes)),
        ):
            from karpenter_tpu.solver.oracle import Scheduler as JScheduler

            pools = main_path_pools(which, merged)
            pbn = {n[0]: (jax_pods(bound) if which == "jax" else bound)
                   for n, bound in zip(nodes, node_pods)}
            sched = (JScheduler if which == "jax" else TScheduler)(
                nodepools=pools, instance_types={p.name: items for p in pools},
                existing_nodes=node_list, pods_by_node=pbn, zones=set(workload.ZONES),
                objective=objective)
            solver = (TPUSolver(g_max=G, objective=objective) if which == "jax"
                      else TorchSolver(device="cpu", g_max=G, objective=objective))
            out.append((result_sig(solver.schedule(sched, batch)), solver.last_route))
        assert out[1] == out[0]
        return out[1]

    @pytest.mark.parametrize("objective", ["price", "fit"])
    def test_suffix_world(self, catalog_items, port_items, objective):  # noqa: F811
        pods = workload.synth_pods(np.random.default_rng(21), workload.ZONES, 1_140, 21, 40)
        pods += workload.affinity_pods(21, 60)
        _, route = self.run(catalog_items, port_items, pods, objective=objective)
        assert route == {"device_pods": 1_140, "oracle_pods": 60, "path": "device+suffix"}

    def test_spread_world_two_ticks(self, catalog_items, port_items):  # noqa: F811
        pods = workload.synth_pods(np.random.default_rng(22), workload.ZONES, 1_200, 22, 40,
                                   spread=8)
        assert sum(bool(p.topology_spread) for p in pods) > 100
        _, route = self.run(catalog_items, port_items, pods)
        assert route["path"] == "device"
        tick1 = TorchSolver(device="cpu", g_max=G).schedule(TScheduler(
            nodepools=main_path_pools("torch", False), instance_types={"default": port_items},
            zones=set(workload.ZONES)), pods)
        nodes = workload.nodes_from_result(tick1)
        specs = node_specs(nodes)
        for _name, _labels, _alloc, used, _taints in specs[:12]:
            for k in used:
                used[k] *= 0.5
        wave = workload.synth_pods(np.random.default_rng(23), workload.ZONES, 400, 23, 40,
                                   spread=8)
        (sig2, _), route = self.run(catalog_items, port_items, wave, nodes=specs,
                                    node_pods=[g.pods for g in tick1.new_groups])
        assert route["path"] == "device"
        assert sig2[1], "the wave packed nothing onto the existing nodes"

    def test_merged_world(self, catalog_items, port_items):  # noqa: F811
        pods = workload.synth_pods(np.random.default_rng(24), workload.ZONES, 1_200, 24, 40)
        (sig, groups), route = self.run(catalog_items, port_items, pods, merged=True)
        assert route["path"] == "merged"
        assert {g[1] for g in groups} == {"spot", "on-demand"}

    def test_pipelined_main_path(self, port_items):  # noqa: F811
        pods = workload.synth_pods(np.random.default_rng(25), workload.ZONES, 1_200, 25, 40)
        pool = TNodePool("default")

        def sched():
            return TScheduler(nodepools=[pool], instance_types={pool.name: port_items},
                              zones=set(workload.ZONES))

        solver = TorchSolver(device="cpu", g_max=G)
        want = result_sig(solver.schedule(sched(), pods))
        pending = solver.schedule_begin(sched(), pods)
        assert pending.done is None, "the single-pool device batch did not pipeline"
        assert result_sig(solver.schedule_finish(pending)) == want


def classes_sig(classes):
    """tests/test_delta.py classes_sig: everything downstream reads."""
    return [
        (pc.key, [p.metadata.name for p in pc.pods], pc.requests.tobytes(),
         pc.requirements.stable_hash(), pc.has_affinity, pc.multi_node_affinity,
         pc.has_preferences, pc.env_count)
        for pc in classes
    ]


class TestIncrementalGrouper:
    def test_three_waves_equal_group_pods(self, small_items):
        """Three waves through one grouper: each equals a fresh
        group_pods of the same pods, in the port and in the JAX package."""
        grouper = tencode.IncrementalGrouper()
        jgrouper = jencode.IncrementalGrouper()
        stats = []
        for wave in range(3):
            spec = fuzz_spec(40 + wave % 2, affinity=0.3, preferences=0.2,
                             salt=f"w{wave}")
            t = build("torch", spec, small_items)
            j = build("jax", spec, small_items)
            got = classes_sig(grouper.group(t.pods))
            assert got == classes_sig(tencode.group_pods(t.pods))
            assert got == classes_sig(jgrouper.group(j.pods))
            stats.append(dict(grouper.last_stats))
            assert stats[-1] == jgrouper.last_stats
        assert stats[0]["full_rebuild"] and not stats[2]["full_rebuild"]

    def test_solver_records_group_stats(self, small_items):
        """The solver's grouping pass: the cross-tick cache by default
        (last_group_stats follows it), group_pods with incremental=False;
        the same classes either way."""
        spec = fuzz_spec(2)
        t = build("torch", spec, small_items)
        ts = TorchSolver(device="cpu", g_max=G)
        ts.schedule(t.scheduler(), list(t.pods))
        assert ts.last_group_stats["pods"] == len(t.pods)
        assert ts.last_group_stats["full_rebuild"]
        fresh = TorchSolver(device="cpu", incremental=False)
        assert classes_sig(fresh._group(t.pods)) == classes_sig(ts._group(t.pods))
        assert not ts.last_group_stats["full_rebuild"]
