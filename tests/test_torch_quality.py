"""The port's quality bound and quality document against the JAX package's.

- `bound.fractional_price_bound` on byte-identical encoded inputs (the
  JAX package encodes a world; `ffd.inputs_from_numpy` carries its arrays
  over): the [R] totals equal the JAX entry's at rel=1e-6 and the float64
  `reference_bound` at rel=1e-5, with the same binding axis; worlds with
  masked join rows, partly placed and zero placed pods, and the pods in
  another order.
- `TorchSolver.last_quality` equals `TPUSolver.last_quality` key for key
  after the same solve: with and without existing nodes, through
  `schedule()` on the device, suffix and merged routes and pipelined,
  and with pods left unplaced. `bound_per_h` and `optimality_gap` come
  from a float32 sum over classes that may round differently in torch
  (the port accumulates in float64 and rounds once); the document rounds
  both to 6 decimals, so they are compared at rel=1e-6 with one unit of
  the 6th decimal allowed. Every other key is host arithmetic on an exact
  decode and must be equal.
- `obs/quality.py`'s host helpers against the JAX module's, and its four
  `karpenter_quality_*` gauges against the JAX module's after the same
  solve.
- The bound's degrade rung: a bound whose dispatch or fetch raises costs
  the tick its certificate only. The decision is the unpatched tick's,
  `karpenter_handled_errors_total{site="solver.quality_dispatch"|
  "solver.quality_finish"}` moves by one in each package, and both publish
  the same document without a gap.
"""
import numpy as np
import pytest

import jax  # noqa: F401  -- both frameworks in one process; data crosses as numpy
import torch

from karpenter_tpu import metrics as jmetrics
from karpenter_tpu.apis import NodePool as JNodePool
from karpenter_tpu.apis import Pod as JPod
from karpenter_tpu.obs import quality as jquality
from karpenter_tpu.scheduling import Resources as JResources
from karpenter_tpu.solver import bound as jbound
from karpenter_tpu.solver import encode as jencode
from karpenter_tpu.solver import ffd as jffd
from karpenter_tpu.solver.service import TPUSolver
from karpenter_tpu_torch import metrics as tmetrics
from karpenter_tpu_torch import workload
from karpenter_tpu_torch.apis import NodePool as TNodePool
from karpenter_tpu_torch.apis import Pod as TPod
from karpenter_tpu_torch.obs import quality as tquality
from karpenter_tpu_torch.scheduling import Resources as TResources
from karpenter_tpu_torch.solver import bound as tbound
from karpenter_tpu_torch.solver.service import TorchSolver
from tests.test_packing import _masked_inputs, catalog_items, churn_pods  # noqa: F401
from tests.test_torch_catalog import (  # noqa: F401
    decision_sig, jax_nodes, node_specs, port_items, port_nodes,
)
from tests.test_torch_ffd import port_inputs
from tests.test_torch_oracle import build, fuzz_spec, small_items  # noqa: F401
from tests.test_torch_schedule import ROUTE_WORLDS

# small tensors: one intra-op thread per test worker (several workers share the cores)
torch.set_num_threads(1)

G = 64


def random_pods(pkg, rng, n):
    """tests/test_quality.py random_pods in either package's types."""
    Pod, Resources = (JPod, JResources) if pkg == "jax" else (TPod, TResources)
    pods = []
    for i in range(n):
        cpu = f"{int(rng.integers(100, 4000))}m"
        mem = f"{int(rng.integers(128, 8192))}Mi"
        pods.append(Pod(f"p{i}", requests=Resources({"cpu": cpu, "memory": mem})))
    return pods


def both_pods(seed, n=28):
    """The same seeded pods built in both packages (one class a pod:
    28 pods keep every solve at one class bucket, C=32)."""
    return (random_pods("jax", np.random.default_rng(seed), n),
            random_pods("torch", np.random.default_rng(seed), n))


def both_totals(catalog, cs, placed, packed=False):
    """([R] totals of the JAX entry, of the port's) on the same encoded inputs."""
    jinp, offsets, words = jffd.make_inputs(catalog, cs, packed_masks=packed)
    tinp, toffsets, twords = port_inputs(catalog, cs, packed)
    assert (toffsets, twords) == (offsets, words)
    want = np.asarray(jbound.fractional_price_bound(
        jinp, placed, word_offsets=offsets, words=words))
    got = tbound.fractional_price_bound(
        tinp, torch.from_numpy(placed), word_offsets=offsets, words=words)
    return want, got


def assert_totals_equal(want, got):
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0.0)
    assert tbound.fetch_bound(got)[1] == jbound.fetch_bound(want)[1]


def encoded_world(catalog, pods):
    classes = jencode.group_pods(pods, extra_requirements=JNodePool("default").requirements())
    cs = jencode.encode_classes(classes, catalog)
    placed = np.zeros(cs.req.shape[0], dtype=np.float32)
    placed[: len(classes)] = [len(pc.pods) for pc in classes]
    return cs, placed


@pytest.fixture(scope="module")
def catalog(catalog_items):  # noqa: F811
    return jencode.encode_catalog(catalog_items)


class TestBoundEntry:
    @pytest.mark.parametrize("packed", [False, True])
    @pytest.mark.parametrize("seed", [0, 11, 23])
    def test_totals_match_jax_and_reference(self, catalog, seed, packed):
        jp, _ = both_pods(seed)
        cs, placed = encoded_world(catalog, jp)
        want, got = both_totals(catalog, cs, placed, packed)
        assert_totals_equal(want, got)
        ref, ref_r = jbound.reference_bound(catalog, cs, placed)
        dev, dev_r = tbound.fetch_bound(got)
        assert dev > 0.0 and dev == pytest.approx(ref, rel=1e-5) and dev_r == ref_r

    @pytest.mark.parametrize("packed", [False, True])
    def test_masked_join_rows(self, catalog_items, packed):  # noqa: F811
        """Random open/join masks (tests/test_packing.py): the join gate
        is part of the feasible set."""
        entry = TPUSolver(g_max=G)._catalog(list(catalog_items))
        cs, _ = _masked_inputs(entry, churn_pods(np.random.default_rng(31), 0, 52),
                               c_pad=32, seed=32, packed=packed)
        placed = np.asarray(cs.count, dtype=np.float32)
        want, got = both_totals(entry.tensors, cs, placed, packed)
        assert_totals_equal(want, got)
        assert float(got.max()) > 0.0

    def test_partly_and_zero_placed(self, catalog):
        jp, _ = both_pods(5, 60)
        cs, placed = encoded_world(catalog, jp)
        part = np.random.default_rng(5).integers(0, placed.astype(np.int64) + 1).astype(np.float32)
        assert 0 < part.sum() < placed.sum()
        assert_totals_equal(*both_totals(catalog, cs, part))
        want, got = both_totals(catalog, cs, np.zeros_like(placed))
        assert float(np.abs(want).max()) == 0.0 and float(got.abs().max()) == 0.0
        assert tbound.fetch_bound(got) == (0.0, 0)

    def test_pod_permutation(self, catalog):
        """The bound is a sum over classes: pods in another order give
        other class rows and the same bound."""
        jp, _ = both_pods(6, 40)
        cs, placed = encoded_world(catalog, jp)
        _, got = both_totals(catalog, cs, placed)
        for seed in (1, 2):
            perm = list(jp)
            np.random.default_rng(seed).shuffle(perm)
            cs2, placed2 = encoded_world(catalog, perm)
            want2, got2 = both_totals(catalog, cs2, placed2)
            assert_totals_equal(want2, got2)
            np.testing.assert_allclose(got2.numpy(), got.numpy(), rtol=1e-6)


def assert_quality_equal(got, want):
    """Key for key; the bound and the gap at rel=1e-6 plus one unit of
    the document's 6th decimal (module docstring)."""
    assert got is not None and want is not None
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        if key in ("bound_per_h", "optimality_gap"):
            assert got[key] == pytest.approx(value, rel=1e-6, abs=1e-6), key
        else:
            assert got[key] == value, key


class TestLastQuality:
    @pytest.mark.parametrize("seed", [0, 42])
    def test_solve(self, catalog_items, port_items, seed):  # noqa: F811
        jp, tp = both_pods(seed)
        js, ts = TPUSolver(g_max=G), TorchSolver(device="cpu", g_max=G)
        js.solve(JNodePool("default"), catalog_items, jp)
        ts.solve(TNodePool("default"), port_items, tp)
        assert_quality_equal(ts.last_quality, js.last_quality)
        assert ts.last_quality["optimality_gap"] >= 1.0
        assert tquality.snapshot() == ts.last_quality

    def test_with_existing_nodes(self, catalog_items, port_items):  # noqa: F811
        """Tick 2 packs onto tick 1's half-empty nodes first (kernel B's
        pre-pass): the bound bills only the pods placed on new groups."""
        js, ts = TPUSolver(g_max=G), TorchSolver(device="cpu", g_max=G)
        jp, tp = both_pods(7)
        tick1 = ts.solve(TNodePool("default"), port_items, tp)
        js.solve(JNodePool("default"), catalog_items, jp)
        specs = node_specs(workload.nodes_from_result(tick1))
        for _name, _labels, _alloc, used, _taints in specs[:6]:
            for k in used:
                used[k] *= 0.5
        jp2 = [JPod(f"w{p.metadata.name}", requests=p.requests) for p in jp]
        tp2 = [TPod(f"w{p.metadata.name}", requests=p.requests) for p in tp]
        jr = js.solve(JNodePool("default"), catalog_items, jp2, existing_nodes=jax_nodes(specs))
        tr = ts.solve(TNodePool("default"), port_items, tp2, existing_nodes=port_nodes(specs))
        assert tr.existing_assignments and tr.new_groups
        assert len(jr.existing_assignments) == len(tr.existing_assignments)
        assert_quality_equal(ts.last_quality, js.last_quality)

    def test_unplaced_pods(self, catalog_items, port_items):  # noqa: F811
        """A starved group budget leaves pods unplaced: the bound bills
        the take-row sums, so the gap stays >= 1."""
        jp, tp = both_pods(8)
        js, ts = TPUSolver(g_max=2), TorchSolver(device="cpu", g_max=2)
        js.solve(JNodePool("default"), catalog_items, jp)
        res = ts.solve(TNodePool("default"), port_items, tp)
        assert res.unschedulable
        assert_quality_equal(ts.last_quality, js.last_quality)
        assert ts.last_quality["optimality_gap"] >= 1.0

    @pytest.mark.parametrize("route,pipelined", [
        ("device", False), ("device", True), ("device+suffix", False), ("merged", False),
    ])
    def test_schedule_routes(self, small_items, route, pipelined):  # noqa: F811
        kw = dict(ROUTE_WORLDS[route])
        spec = fuzz_spec(kw.pop("seed"), **kw)
        j, t = build("jax", spec, small_items), build("torch", spec, small_items)
        js, ts = TPUSolver(g_max=G), TorchSolver(device="cpu", g_max=G)
        js.schedule(j.scheduler(), list(j.pods))
        if pipelined:
            ts.schedule_finish(ts.schedule_begin(t.scheduler(), list(t.pods)))
        else:
            ts.schedule(t.scheduler(), list(t.pods))
        assert ts.last_route == js.last_route and js.last_route["path"] == route
        assert_quality_equal(ts.last_quality, js.last_quality)

    def test_no_device_solve_keeps_the_last_document(self, catalog_items, port_items):  # noqa: F811
        """A solve whose pods all fit existing nodes runs nothing on the
        device after the pre-pass: last_quality stays the previous one,
        as in TPUSolver."""
        js, ts = TPUSolver(g_max=G), TorchSolver(device="cpu", g_max=G)
        jp, tp = both_pods(9)
        tick1 = ts.solve(TNodePool("default"), port_items, tp)
        js.solve(JNodePool("default"), catalog_items, jp)
        before = dict(ts.last_quality)
        specs = node_specs(workload.nodes_from_result(tick1))
        for _name, _labels, _alloc, used, _taints in specs:
            for k in used:
                used[k] = 0.0
        jp2 = [JPod(f"x{p.metadata.name}", requests=p.requests) for p in jp[:2]]
        tp2 = [TPod(f"x{p.metadata.name}", requests=p.requests) for p in tp[:2]]
        js.solve(JNodePool("default"), catalog_items, jp2, existing_nodes=jax_nodes(specs))
        tr = ts.solve(TNodePool("default"), port_items, tp2, existing_nodes=port_nodes(specs))
        assert len(tr.existing_assignments) == 2 and not tr.new_groups
        assert ts.last_quality == before
        assert_quality_equal(ts.last_quality, js.last_quality)


class TestQualityModule:
    def test_stranded_and_fragmentation(self):
        for args in ((0.0, 0.0), (10.0, 7.5), (10.0, 12.0), (3.0, 1.0)):
            assert tquality.stranded_fraction(*args) == jquality.stranded_fraction(*args)
        for free in ([], [4.0], [4.0, 0.0], [1.0, 1.0, 1.0, 1.0], [3.0, 1.0, 0.5]):
            assert tquality.fragmentation_index(free) == jquality.fragmentation_index(free)

    def test_dump_json_and_reset(self):
        import json

        tquality.reset()
        assert json.loads(tquality.dump_json()) == {"configured": False}
        tquality.record({"groups": 1})
        assert json.loads(tquality.dump_json()) == {"groups": 1}
        tquality.reset()

    def test_fleet_bound(self, catalog_items, port_items):  # noqa: F811
        jp, tp = both_pods(4, 30)
        b = tquality.fleet_bound(tp, port_items)
        assert b > 0.0 and b == jquality.fleet_bound(jp, catalog_items)
        assert tquality.fleet_bound(list(reversed(tp)), port_items) == pytest.approx(b, rel=1e-9)

    def test_fleet_waste_and_price_decomposition(self, port_items):  # noqa: F811
        _, tp = both_pods(10)
        res = TorchSolver(device="cpu", g_max=G).solve(TNodePool("default"), port_items, tp)
        nodes = workload.nodes_from_result(res)
        usage = {n.name: n.used for n in nodes}

        class _Meta:
            def __init__(self, name, labels):
                self.name, self.labels = name, labels

        class _Node:
            def __init__(self, n):
                self.metadata = _Meta(n.name, n.labels)
                self.allocatable = n.allocatable

        live = [_Node(n) for n in nodes]
        waste = tquality.fleet_waste(live, usage)
        assert set(waste) == {"stranded_cpu_fraction", "stranded_memory_fraction",
                              "fragmentation_index"}
        assert all(0.0 <= v <= 1.0 for v in waste.values())
        dec = tquality.fleet_price_decomposition(live, lambda n: 1.0)
        assert sum(dec["price_by_pool"].values()) == len(live)
        assert dec["price_by_pool"] == {"default": float(len(live))}


class TestGauges:
    @pytest.mark.parametrize("seed", [0, 42])
    def test_gauges_match_jax(self, catalog_items, port_items, seed):  # noqa: F811
        jp, tp = both_pods(seed)
        TPUSolver(g_max=G).solve(JNodePool("default"), catalog_items, jp)
        gauges = lambda mod: (  # noqa: E731
            mod.QUALITY_GAP.value(), mod.QUALITY_BOUND.value(),
            mod.QUALITY_STRANDED.value(resource="cpu"),
            mod.QUALITY_STRANDED.value(resource="memory"), mod.QUALITY_FRAGMENTATION.value())
        want = gauges(jquality)
        ts = TorchSolver(device="cpu", g_max=G)
        ts.solve(TNodePool("default"), port_items, tp)
        got = gauges(tquality)
        assert got == pytest.approx(want, rel=1e-6, abs=1e-6)
        assert got[0] == ts.last_quality["optimality_gap"]


def handled(site):
    return (tmetrics.HANDLED_ERRORS.value(site=site), jmetrics.HANDLED_ERRORS.value(site=site))


class TestBoundRung:
    @pytest.mark.parametrize("stage,site", [("fractional_price_bound", "solver.quality_dispatch"),
                                            ("fetch_bound", "solver.quality_finish")])
    def test_a_failing_bound_costs_only_the_certificate(
            self, catalog_items, port_items, monkeypatch, stage, site):  # noqa: F811
        jp, tp = both_pods(5)
        clean = decision_sig(TorchSolver(device="cpu", g_max=G).solve(
            TNodePool("default"), port_items, tp))

        def broken(*a, **k):
            raise RuntimeError("injected bound failure")

        monkeypatch.setattr(tbound, stage, broken)
        monkeypatch.setattr(jbound, stage, broken)
        before = handled(site)
        js, ts = TPUSolver(g_max=G), TorchSolver(device="cpu", g_max=G)
        jr = js.solve(JNodePool("default"), catalog_items, jp)
        tr = ts.solve(TNodePool("default"), port_items, tp)
        assert decision_sig(tr) == decision_sig(jr) == clean
        assert [a - b for a, b in zip(handled(site), before)] == [1.0, 1.0]
        if stage == "fetch_bound":
            # the finish rung drops the whole document, as TPUSolver does
            assert ts.last_quality is None and js.last_quality is None
        else:
            assert_quality_equal(ts.last_quality, js.last_quality)
            assert "optimality_gap" not in ts.last_quality
