"""TorchSolver.solve against TPUSolver.solve: the same decisions.

Each side builds its own pods from the same numpy draws and solves against
its own catalog; `decision_sig` (tests/test_packing.py) of the two results
must be equal -- groups by pod names and cheapest type, existing-node
assignments, unschedulable reasons. Worlds: the churn_pods worlds, a
small bench-style world, and the same two-tick shape as the slice's main
path, where tick 2 packs onto the nodes tick 1 opened (built from one
spec on both sides).
"""
import numpy as np
import pytest

import jax  # noqa: F401  -- both frameworks in one process; data crosses as numpy
import torch  # noqa: F401

import bench
from karpenter_tpu.apis import NodePool as JNodePool
from karpenter_tpu.apis import Pod as JPod
from karpenter_tpu.apis import PodAffinityTerm as JAffinity
from karpenter_tpu.scheduling import Resources as JResources
from karpenter_tpu.solver.service import TPUSolver
from karpenter_tpu_torch import workload
from karpenter_tpu_torch.apis import NodePool as TNodePool
from karpenter_tpu_torch.apis import Pod as TPod
from karpenter_tpu_torch.apis import PodAffinityTerm as TAffinity
from karpenter_tpu_torch.apis import TopologySpreadConstraint as TSpread
from karpenter_tpu_torch.scheduling import Resources as TResources
from karpenter_tpu_torch.solver import ffd as tffd
from karpenter_tpu_torch.solver.service import TorchSolver
from tests.test_packing import catalog_items, churn_pods  # noqa: F401
from tests.test_torch_catalog import (  # noqa: F401
    decision_sig, jax_nodes, node_specs, port_churn_pods, port_items, port_nodes,
)
from tests.test_torch_oracle import build, fuzz_spec

# small tensors: one intra-op thread per test worker (several workers share the cores)
torch.set_num_threads(1)

G = 64


@pytest.fixture(scope="module")
def solvers():
    return TPUSolver(g_max=G), TorchSolver(device="cpu", g_max=G)


def bench_pods(seed, n, salt, templates=40):
    return (
        bench.synth_pods(np.random.default_rng(seed), list(workload.ZONES), n, salt, templates),
        workload.synth_pods(np.random.default_rng(seed), workload.ZONES, n, salt, templates),
    )


class TestSolveIdentity:
    @pytest.mark.parametrize("tick", [0, 1, 2])
    def test_churn_worlds(self, solvers, catalog_items, port_items, tick):  # noqa: F811
        js, ts = solvers
        n = 30 + 20 * tick
        jp = churn_pods(np.random.default_rng(100 + tick), tick, n)
        tp = port_churn_pods(np.random.default_rng(100 + tick), tick, n)
        want = decision_sig(js.solve(JNodePool("default"), catalog_items, jp))
        assert decision_sig(ts.solve(TNodePool("default"), port_items, tp)) == want
        assert want[0]

    @pytest.mark.parametrize("objective", ["price", "fit"])
    def test_bench_world(self, catalog_items, port_items, objective):  # noqa: F811
        jp, tp = bench_pods(11, 1_500, salt=1)
        want = decision_sig(TPUSolver(g_max=G, objective=objective).solve(
            JNodePool("default"), catalog_items, jp))
        got = decision_sig(TorchSolver(device="cpu", g_max=G, objective=objective).solve(
            TNodePool("default"), port_items, tp))
        assert got == want

    def test_two_ticks_with_existing_nodes(self, solvers, catalog_items, port_items):  # noqa: F811
        """The main path's shape: tick 2 packs a new wave onto the nodes
        of tick 1 (kernel B's pre-pass), then opens groups for the rest."""
        js, ts = solvers
        jp1, tp1 = bench_pods(12, 1_200, salt=1)
        tick1 = ts.solve(TNodePool("default"), port_items, tp1)
        assert decision_sig(tick1) == decision_sig(
            js.solve(JNodePool("default"), catalog_items, jp1))
        specs = node_specs(workload.nodes_from_result(tick1))
        # headroom: the first nodes half-empty, so the wave has room to pack
        for name, _labels, _alloc, used, _taints in specs[:10]:
            for k in used:
                used[k] *= 0.5
        jp2, tp2 = bench_pods(13, 400, salt=2)
        want = decision_sig(js.solve(
            JNodePool("default"), catalog_items, jp2, existing_nodes=jax_nodes(specs)))
        got = decision_sig(ts.solve(
            TNodePool("default"), port_items, tp2, existing_nodes=port_nodes(specs)))
        assert got == want
        assert got[1], "no pod packed onto an existing node"

    def test_existing_nodes_with_taints(self, solvers, catalog_items, port_items):  # noqa: F811
        js, ts = solvers
        alloc = {"cpu": 4000.0, "memory": 8 * 2.0**30, "pods": 20.0}
        specs = [
            (f"n{i}", {"kubernetes.io/arch": "arm64" if i % 2 else "amd64",
                       "karpenter.sh/capacity-type": "on-demand"},
             alloc, {"cpu": 500.0 * i, "pods": float(i)},
             [("dedicated", "NoSchedule", "")] if i % 3 == 0 else [])
            for i in range(6)
        ]
        jp = churn_pods(np.random.default_rng(14), 0, 80)
        tp = port_churn_pods(np.random.default_rng(14), 0, 80)
        want = decision_sig(js.solve(JNodePool("default"), catalog_items, jp,
                                     existing_nodes=jax_nodes(specs)))
        got = decision_sig(ts.solve(TNodePool("default"), port_items, tp,
                                    existing_nodes=port_nodes(specs)))
        assert got == want

    def test_sparse_overflow_decides_the_same(self, solvers, catalog_items, port_items,
                                              monkeypatch):  # noqa: F811
        js, ts = solvers
        monkeypatch.setattr(tffd, "nnz_budget", lambda c_pad, g_max: 1)
        calls = []
        dense = tffd.solve_dense_tuple
        monkeypatch.setattr(tffd, "solve_dense_tuple",
                            lambda *a, **k: calls.append(1) or dense(*a, **k))
        jp = churn_pods(np.random.default_rng(15), 0, 50)
        tp = port_churn_pods(np.random.default_rng(15), 0, 50)
        want = decision_sig(js.solve(JNodePool("default"), catalog_items, jp))
        assert decision_sig(ts.solve(TNodePool("default"), port_items, tp)) == want
        assert calls == [1]

    def test_nodepool_limits(self, catalog_items, port_items):  # noqa: F811
        jp = churn_pods(np.random.default_rng(16), 0, 80)
        tp = port_churn_pods(np.random.default_rng(16), 0, 80)
        want = decision_sig(TPUSolver(g_max=G).solve(
            JNodePool("default", limits=JResources({"cpu": "20"})), catalog_items, jp))
        got = decision_sig(TorchSolver(device="cpu", g_max=G).solve(
            TNodePool("default", limits=TResources({"cpu": "20"})), port_items, tp))
        assert got == want
        assert got[2], "the limit left every pod schedulable"


class TestOutOfScope:
    """solve() raises on what only schedule() routes (affinity), as
    TPUSolver.solve does, and takes zone spread itself."""

    def test_affinity_raises_on_both(self, catalog_items, port_items):  # noqa: F811
        req = {"cpu": "500m", "memory": "1Gi"}
        jpod = JPod("a", requests=JResources(req), affinity_terms=[JAffinity({"app": "x"})])
        tpod = TPod("a", requests=TResources(req), affinity_terms=[TAffinity({"app": "x"})])
        with pytest.raises(ValueError):
            TPUSolver(g_max=G).solve(JNodePool("default"), catalog_items, [jpod])
        with pytest.raises(ValueError):
            TorchSolver(device="cpu", g_max=G).solve(TNodePool("default"), port_items, [tpod])

    def test_zone_spread_raises(self, catalog_items, port_items):  # noqa: F811
        """solve() takes zone spread itself: it runs the split pass and,
        given the same zones and seeded counts, decides as TPUSolver.solve."""
        spec = fuzz_spec(3, spread=1.0)
        items = {"jax": catalog_items, "torch": port_items}
        j, t = build("jax", spec, items), build("torch", spec, items)
        seeds = {(("app", "w0"),): {"us-central-1a": 2}, (("app", "w1"),): {"us-central-1c": 1}}
        kw = dict(zones=spec["zones"], spread_seeds=seeds)
        want = decision_sig(TPUSolver(g_max=G).solve(j.pools[0], catalog_items, j.pods, **kw))
        got = decision_sig(TorchSolver(device="cpu", g_max=G).solve(
            t.pools[0], port_items, t.pods, **kw))
        assert got == want
        assert any(TSpread is type(c) for p in t.pods for c in p.topology_spread)
