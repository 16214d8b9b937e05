"""The port's convex tier against the JAX package's.

- `convex_relax` on byte-identical encoded inputs (the JAX package
  encodes tests/test_convex.py's random worlds; `ffd.inputs_from_numpy`
  carries its arrays over): the feasible set equal, and `x`, `lower` and
  `trace` within atol=5e-5 of the JAX entry and of the float64
  `reference_relax` (the JAX test's own tolerance). The port accumulates
  every sum in float64 and rounds once, XLA sums in float32: they differ
  in the last bits.
- `host_feasibility`, `assign_types`, `round_solution` and `choose` are
  numpy copies: exactly equal, with the seeded tie-break under
  `seeding.apply(77)` and every rung of the never-worse choice.
- `TorchSolver(tier="convex")` against `TPUSolver(tier="convex")`:
  decision_sig, and in `last_convex` the winner, both prices and the
  iteration count exactly; `lower` (a float32 iterate) within 5e-5.
  Rounding reads `x` only to break ties between equal amortized prices,
  so the decision is exact although `x` is not.
- The degrade rungs, drilled in both packages alike: `convex.rounding`
  and `rpc.convex.dispatch` armed to raise, and rounding that returns
  None. Each tick decides as the `tier="ffd"` tick (decision_sig) and as
  `TPUSolver` under the same drill, `karpenter_convex_fallbacks_total`
  moves by one in each package, the rung logs once per change of its
  exception type, the next disarmed tick is convex again, and
  `OperatorCrashed` escapes every rung.
"""
import logging

import numpy as np
import pytest

import jax  # noqa: F401  -- both frameworks in one process; data crosses as numpy
import torch

import bench
from karpenter_tpu import metrics as jmetrics
from karpenter_tpu import seeding as jseeding
from karpenter_tpu.apis import NodePool as JNodePool
from karpenter_tpu.apis import Pod as JPod
from karpenter_tpu.scheduling import Resources as JResources
from karpenter_tpu.solver import encode as jencode
from karpenter_tpu.solver import ffd as jffd
from karpenter_tpu.solver.convex import relax as jrelax
from karpenter_tpu.solver.convex import repack as jrepack
from karpenter_tpu.solver.convex import rounding as jrounding
from karpenter_tpu.solver.convex import tier as jtier
from karpenter_tpu.solver.service import TPUSolver
from karpenter_tpu_torch import failpoints as tfailpoints
from karpenter_tpu_torch import metrics as tmetrics
from karpenter_tpu_torch import seeding as tseeding
from karpenter_tpu_torch import workload
from karpenter_tpu_torch.apis import NodePool as TNodePool
from karpenter_tpu_torch.apis import Pod as TPod
from karpenter_tpu_torch.scheduling import Resources as TResources
from karpenter_tpu_torch.solver import encode as tencode
from karpenter_tpu_torch.solver.convex import relax as trelax
from karpenter_tpu_torch.solver.convex import repack as trepack
from karpenter_tpu_torch.solver.convex import rounding as trounding
from karpenter_tpu_torch.solver.convex import tier as ttier
from karpenter_tpu_torch.solver.service import TorchSolver
from tests.test_packing import catalog_items  # noqa: F401
from tests.test_torch_catalog import decision_sig, port_items  # noqa: F401
from tests.test_torch_ffd import port_inputs
from tests.test_torch_quality import assert_quality_equal

# small tensors: one intra-op thread per test worker (several workers share the cores)
torch.set_num_threads(1)

G = 64
ATOL = 5e-5
SHAPES = (("1100m", "2200Mi"), ("700m", "1400Mi"), ("1700m", "3400Mi"))


def random_pods(pkg, rng, n):
    """tests/test_convex.py random_pods in either package's types."""
    Pod, Resources = (JPod, JResources) if pkg == "jax" else (TPod, TResources)
    return [Pod(f"p{i}", requests=Resources({"cpu": f"{int(rng.integers(100, 4000))}m",
                                             "memory": f"{int(rng.integers(128, 8192))}Mi"}))
            for i in range(n)]


def adversarial_pods(pkg, n=30):
    """tests/test_convex.py adversarial_pods: pods just over 1/2 and 1/3
    of the common node shapes."""
    Pod, Resources = (JPod, JResources) if pkg == "jax" else (TPod, TResources)
    return [Pod(f"adv{i}", requests=Resources({"cpu": SHAPES[i % 3][0], "memory": SHAPES[i % 3][1]}))
            for i in range(n)]


def world(name):
    """(JAX pods, port pods) of a named world: "adversarial" or "random-<seed>"
    (tests/test_convex.py TestDifferential's draws)."""
    if name == "adversarial":
        return adversarial_pods("jax"), adversarial_pods("torch")
    seed = int(name.split("-")[1])
    n = int(np.random.default_rng(seed).integers(20, 70))
    out = []
    for pkg in ("jax", "torch"):
        rng = np.random.default_rng(seed)
        rng.integers(20, 70)
        out.append(random_pods(pkg, rng, n))
    return tuple(out)


@pytest.fixture(scope="module")
def catalog(catalog_items):  # noqa: F811
    return jencode.encode_catalog(catalog_items)


def relax_world(catalog, seed):
    """tests/test_convex.py TestRelaxParity's world: (class set, pods)."""
    rng = np.random.default_rng(seed)
    pods = random_pods("jax", rng, int(rng.integers(30, 90)))
    classes = jencode.group_pods(pods, extra_requirements=JNodePool("default").requirements())
    return jencode.encode_classes(classes, catalog), pods


class TestRelax:
    @pytest.mark.parametrize("packed", [False, True])
    @pytest.mark.parametrize("seed", [0, 3])
    def test_matches_jax_entry_and_reference(self, catalog, seed, packed):
        cs, _ = relax_world(catalog, seed)
        jinp, offsets, words = jffd.make_inputs(catalog, cs, packed_masks=packed)
        tinp, _, _ = port_inputs(catalog, cs, packed)
        kw = dict(iters=jrelax.DEFAULT_ITERS, word_offsets=offsets, words=words)
        jout = jrelax.convex_relax(jinp, **kw)
        tout = trelax.convex_relax(tinp, **kw)
        assert torch.equal(tout.feas, torch.from_numpy(np.array(jout.feas)))
        assert tout.x.dtype == tout.trace.dtype == tout.lower.dtype == torch.float32
        jx, jlower, jtrace = jrelax.fetch_relax(jout)
        tx, tlower, ttrace = trelax.fetch_relax(tout)
        rx, rlower, rtrace = jrelax.reference_relax(catalog, cs)
        for want_x, want_lower, want_trace in ((jx, jlower, jtrace), (rx, rlower, rtrace)):
            np.testing.assert_allclose(tx, want_x, atol=ATOL, rtol=0)
            assert abs(tlower - want_lower) <= ATOL * max(want_lower, 1.0)
            np.testing.assert_allclose(ttrace, want_trace, atol=ATOL, rtol=0)
        # every class's fractional mass sums to its pod count
        np.testing.assert_allclose(tx.sum(axis=-1), np.asarray(cs.count, np.float64), atol=1e-3)
        assert trelax.iterations_to_convergence(ttrace) == jrelax.iterations_to_convergence(jtrace)

    @pytest.mark.parametrize("seed", [0, 3])
    def test_reference_relax_equal(self, catalog, seed):
        """The host float64 reference the repack oracle runs: the same
        numpy operations in both packages, so equal to the last bit."""
        cs, _ = relax_world(catalog, seed)
        (tx, tlower, ttrace), (jx, jlower, jtrace) = (
            trelax.reference_relax(catalog, cs), jrelax.reference_relax(catalog, cs))
        np.testing.assert_array_equal(tx, jx)
        np.testing.assert_array_equal(ttrace, jtrace)
        assert tlower == jlower

    def test_repack_oracle_proposes_as_jax(self, catalog_items, port_items):  # noqa: F811
        """The disruption controller's stage 6 under a convex solver:
        tests/test_convex.py's regret world, the same nominations, regrets
        and lower bound in both packages (exact: one numpy float64 path)."""
        def candidates(pkg):
            pod_t, res_t = (JPod, JResources) if pkg == "jax" else (TPod, TResources)
            return [type("Candidate", (), {"pods": [pod_t(f"r{i}", requests=res_t(
                {"cpu": cpu, "memory": "256Mi"}))], "price": price})()
                for i, (cpu, price) in enumerate((("200m", 0.001), ("300m", 40.0), ("250m", 5.0)))]

        jo, to = jrepack.RepackOracle(), trepack.RepackOracle()
        want = jo.propose(candidates("jax"), [JNodePool("default")], {"default": catalog_items})
        got = to.propose(candidates("torch"), [TNodePool("default")], {"default": port_items})
        assert want and got == want
        np.testing.assert_array_equal(to.last_regret, jo.last_regret)
        assert to.last_lower == jo.last_lower > 0.0

    def test_host_feasibility_equal(self, catalog):
        cs, _ = relax_world(catalog, 1)
        for got, want in zip(trelax.host_feasibility(catalog, cs), jrelax.host_feasibility(catalog, cs)):
            np.testing.assert_array_equal(got, want)

    def test_iterations_to_convergence(self):
        for trace in ([], [3.0], [5.0, 4.0, 3.001, 3.0], [1.0, 2.0, 1.0, 2.0], np.linspace(9, 1, 48)):
            assert trelax.iterations_to_convergence(trace) == jrelax.iterations_to_convergence(trace)


@pytest.fixture()
def seeded():
    """Both packages' seed state, restored after the test."""
    jt, tt = jseeding.snapshot(), tseeding.snapshot()
    yield
    jseeding.restore(jt)
    tseeding.restore(tt)


class TestSeeding:
    @pytest.mark.parametrize("seed", [None, 0, 77, 123])
    def test_same_stream_as_jax(self, seeded, seed):
        jseeding.apply(seed)
        tseeding.apply(seed)
        a = [tseeding.convex_rng().random() for _ in range(3)]
        assert a == [jseeding.convex_rng().random() for _ in range(3)]
        # fresh per call: every rounding pass restarts the stream
        assert a == [tseeding.convex_rng().random() for _ in range(3)]
        perm_t, perm_j = list(range(640)), list(range(640))
        tseeding.convex_rng().shuffle(perm_t)
        jseeding.convex_rng().shuffle(perm_j)
        assert perm_t == perm_j
        assert tseeding.seeded_rng("x", 5).random() == jseeding.seeded_rng("x", 5).random()

    def test_snapshot_restore(self, seeded):
        token = tseeding.snapshot()
        tseeding.apply(999)
        assert tseeding._convex_seed == 999
        tseeding.restore(token)
        assert tseeding.snapshot() == token


class TestRounding:
    def test_assign_types_concentrates(self):
        price_ck = np.array([[3.0, 1.0, 2.0], [0.5, 9.0, 9.0]])
        fit0 = np.array([[1, 2, 1], [1, 1, 1]])
        feas = np.ones((2, 3), dtype=bool)
        x = np.zeros((2, 3))
        count = np.array([7, 4])
        n = trounding.assign_types(x, feas, count, price_ck=price_ck, fit0=fit0)
        assert n[0, 1] == 7 and n[1, 0] == 4 and ((n > 0).sum(axis=-1) == 1).all()
        np.testing.assert_array_equal(
            n, jrounding.assign_types(x, feas, count, price_ck=price_ck, fit0=fit0))

    @pytest.mark.parametrize("seed", [None, 77])
    def test_seeded_tiebreak(self, seeded, seed):
        """Equal amortized prices: the larger LP mass wins, then the
        seeded type permutation, the same in both packages."""
        jseeding.apply(seed)
        tseeding.apply(seed)
        rng = np.random.default_rng(3)
        price_ck = np.ones((6, 16))
        fit0 = np.ones((6, 16), dtype=np.int64)
        feas = rng.random((6, 16)) < 0.8
        x = np.zeros((6, 16))
        x[0, 5] = x[0, 9] = 0.5                         # mass ties too
        x[1, 3] = 0.9                                   # mass decides
        count = np.array([5, 4, 3, 2, 1, 0])
        kw = dict(price_ck=price_ck, fit0=fit0)
        got = trounding.assign_types(x, feas, count, **kw)
        np.testing.assert_array_equal(got, jrounding.assign_types(x, feas, count, **kw))
        np.testing.assert_array_equal(got, trounding.assign_types(x, feas, count, **kw))
        assert got[1, 3] == 4 and got[5].sum() == 0

    @pytest.mark.parametrize("seed", [4, 6])
    def test_round_solution_equal(self, catalog, port_items, seed):  # noqa: F811
        """The JAX relaxation's x rounded by both packages, each against
        its own encoding of the same pods."""
        cs, pods = relax_world(catalog, seed)
        x, _, _ = jrelax.reference_relax(catalog, cs)
        tcat = tencode.encode_catalog(port_items)
        tpods = [TPod(p.metadata.name, requests=TResources(dict(p.requests.items())))
                 for p in pods]
        tcs = tencode.encode_classes(
            tencode.group_pods(tpods, extra_requirements=TNodePool("default").requirements()), tcat)
        want = jrounding.round_solution(x, catalog, cs, g_max=G)
        got = trounding.round_solution(x, tcat, tcs, g_max=G)
        assert want is not None and got is not None
        for a, b in zip(got, want):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        # a budget too small for the placement is the None rung in both
        assert trounding.round_solution(x, tcat, tcs, g_max=2) is None
        assert jrounding.round_solution(x, catalog, cs, g_max=2) is None


def dense(take, unplaced, gmask, gzone=None, gcap=None):
    take = np.asarray(take, dtype=np.int32)
    gmask = np.asarray(gmask, dtype=bool)
    G = gmask.shape[0]
    gzone = np.ones((G, 2), bool) if gzone is None else np.asarray(gzone, bool)
    gcap = np.ones((G, 1), bool) if gcap is None else np.asarray(gcap, bool)
    return (take, np.asarray(unplaced, dtype=np.int32), G, gmask, gzone, gcap)


class TestChoose:
    # [K=3, Z=2, CT=1] offerings; type 2 has none in zone 1
    PRICE = np.array([[[1.0], [1.5]], [[2.0], [2.0]], [[0.7], [np.inf]]])
    # two classes; FFD opens type 0 (1.0) and type 1 (2.0), one pod of
    # class 1 left behind
    FFD = dense([[2, 1], [0, 1]], [0, 1], [[1, 0, 0], [0, 1, 0]])

    @pytest.mark.parametrize("name,cx,winner", [
        ("rounding returned None", None, "ffd"),
        ("a tie", dense([[3, 0], [0, 1]], [0, 1], [[1, 0, 0], [0, 1, 0]]), "ffd"),
        ("dearer", dense([[2, 1], [0, 1]], [0, 1], [[0, 1, 0], [0, 1, 0]]), "ffd"),
        # cheaper and as many pods left in all, but one more of class 0
        ("more unplaced in one class", dense([[2], [2]], [1, 0], [[0, 0, 1]], gzone=[[1, 0]]),
         "ffd"),
        ("no finite offering", dense([[3], [1]], [0, 1], [[0, 0, 1]], gzone=[[0, 1]]), "ffd"),
        ("cheaper", dense([[3], [1]], [0, 1], [[0, 0, 1]], gzone=[[1, 0]]), "convex"),
        ("cheaper, fewer left", dense([[3], [2]], [0, 0], [[0, 0, 1]], gzone=[[1, 0]]), "convex"),
    ])
    def test_rungs(self, name, cx, winner):
        got = ttier.choose(self.FFD, cx, self.PRICE)
        want = jtier.choose(self.FFD, cx, self.PRICE)
        assert got[0] == want[0] == winner, name
        assert got[2:] == want[2:] and got[2] == 3.0
        assert got[1] is (cx if winner == "convex" else self.FFD)


def solve_both(tier, name, g_max=G):
    jp, tp = world(name)
    js = TPUSolver(g_max=g_max, tier=tier)
    ts = TorchSolver(device="cpu", g_max=g_max, tier=tier)
    jr = js.solve(JNodePool("default"), catalog_items_cache["jax"], jp)
    tr = ts.solve(TNodePool("default"), catalog_items_cache["torch"], tp)
    return js, ts, jr, tr, tp


catalog_items_cache = {}


@pytest.fixture(scope="module", autouse=True)
def _items(catalog_items, port_items):  # noqa: F811
    catalog_items_cache.update(jax=catalog_items, torch=port_items)
    yield
    catalog_items_cache.clear()


def assert_convex_equal(got, want):
    assert sorted(got) == sorted(want) == ["iterations", "lower", "price_convex", "price_ffd",
                                           "winner"]
    for key in ("winner", "price_ffd", "price_convex", "iterations"):
        assert got[key] == want[key], key
    assert abs(got["lower"] - want["lower"]) <= ATOL * max(want["lower"], 1.0)


class TestTier:
    @pytest.mark.parametrize("name", ["adversarial", "random-0", "random-1", "random-2"])
    def test_decides_as_jax(self, name):
        js, ts, jr, tr, tp = solve_both("convex", name)
        assert decision_sig(tr) == decision_sig(jr)
        assert_convex_equal(ts.last_convex, js.last_convex)
        assert_quality_equal(ts.last_quality, js.last_quality)
        lc = ts.last_convex
        chosen = lc["price_convex"] if lc["winner"] == "convex" else lc["price_ffd"]
        assert chosen <= lc["price_ffd"]
        assert 1 <= lc["iterations"] <= trelax.DEFAULT_ITERS and lc["lower"] > 0.0
        placed = sum(len(g.pods) for g in tr.new_groups)
        assert placed + len(tr.existing_assignments) + len(tr.unschedulable) == len(tp)
        if name == "adversarial":
            assert lc["winner"] == "convex" and lc["price_convex"] < lc["price_ffd"]

    def test_ffd_rung_is_the_ffd_tick(self):
        """Where FFD wins, the convex tier's decisions are the FFD tier's,
        and the FFD tier publishes no differential."""
        _, ts, _, tr, _ = solve_both("convex", "random-0")
        assert ts.last_convex["winner"] == "ffd"
        _, tf, _, fr, _ = solve_both("ffd", "random-0")
        assert decision_sig(tr) == decision_sig(fr) and tf.last_convex is None

    def test_bench_convex_world(self):
        """bench.py's convex stage at 2,000 pods (`--convex-only`,
        BENCH_N_PODS=2000: rng 42, salt 99,000), g_max 1024: convex wins."""
        jp = bench.synth_pods(np.random.default_rng(42), list(workload.ZONES), 2_000, 99_000)
        tp = workload.synth_pods(np.random.default_rng(42), workload.ZONES, 2_000, 99_000)
        js = TPUSolver(g_max=1024, tier="convex")
        ts = TorchSolver(device="cpu", g_max=1024, tier="convex")
        jr = js.solve(JNodePool("default"), catalog_items_cache["jax"], jp)
        tr = ts.solve(TNodePool("default"), catalog_items_cache["torch"], tp)
        assert decision_sig(tr) == decision_sig(jr)
        assert_convex_equal(ts.last_convex, js.last_convex)
        assert_quality_equal(ts.last_quality, js.last_quality)
        assert ts.last_convex["winner"] == "convex"

    def test_tier_validation(self):
        with pytest.raises(ValueError, match="tier"):
            TorchSolver(device="cpu", tier="simplex")
        assert TorchSolver(device="cpu").tier == "ffd"
        assert TorchSolver(device="cpu", tier="convex").last_convex is None


@pytest.fixture
def drills(failpoints):
    """(the JAX registry, the port's), both disarmed after the test."""
    tfailpoints.FAILPOINTS.reset()
    yield failpoints, tfailpoints.FAILPOINTS
    tfailpoints.FAILPOINTS.reset()


def fallbacks(reason):
    return (tmetrics.CONVEX_FALLBACKS.value(reason=reason),
            jmetrics.CONVEX_FALLBACKS.value(reason=reason))


@pytest.fixture
def solver_log():
    """The warning records the port's solver logs (its logger does not
    propagate to the root, so caplog does not see it)."""
    records = []
    handler = logging.Handler()
    handler.emit = records.append
    logger = logging.getLogger("karpenter.solver")
    logger.addHandler(handler)
    yield records
    logger.removeHandler(handler)


class TestRungs:
    @pytest.mark.parametrize("site,reason", [("convex.rounding", "rounding"),
                                             ("rpc.convex.dispatch", "dispatch")])
    def test_failpoint_rung_is_the_ffd_tick(self, drills, site, reason):
        before = fallbacks(reason)
        for registry in drills:
            registry.arm(site, "error", "RuntimeError", times=1)
        jp, tp = world("adversarial")
        js, ts = TPUSolver(g_max=G, tier="convex"), TorchSolver(device="cpu", g_max=G, tier="convex")
        jr = js.solve(JNodePool("default"), catalog_items_cache["jax"], jp)
        tr = ts.solve(TNodePool("default"), catalog_items_cache["torch"], tp)
        assert [registry.fires(site) for registry in drills] == [1, 1]
        _, _, _, fr, _ = solve_both("ffd", "adversarial")
        assert decision_sig(tr) == decision_sig(fr) == decision_sig(jr)
        assert [a - b for a, b in zip(fallbacks(reason), before)] == [1.0, 1.0]
        if reason == "dispatch":
            # the relaxation never ran: no differential to publish
            assert ts.last_convex is None and js.last_convex is None
        else:
            assert_convex_equal(ts.last_convex, js.last_convex)
            assert ts.last_convex["winner"] == "ffd" and ts.last_convex["price_convex"] == float("inf")
        assert_quality_equal(ts.last_quality, js.last_quality)
        # the next, disarmed tick is convex again, the counter flat
        ts.solve(TNodePool("default"), catalog_items_cache["torch"], tp)
        assert ts.last_convex["winner"] == "convex"
        assert fallbacks(reason)[0] - before[0] == 1.0

    def test_rounding_none_rung(self):
        """A group budget rounding cannot meet: None, counted, FFD's placement."""
        before = fallbacks("rounding")
        js, ts, jr, tr, _ = solve_both("convex", "random-0", g_max=4)
        _, _, _, fr, _ = solve_both("ffd", "random-0", g_max=4)
        assert decision_sig(tr) == decision_sig(fr) == decision_sig(jr)
        assert [a - b for a, b in zip(fallbacks("rounding"), before)] == [1.0, 1.0]
        assert_convex_equal(ts.last_convex, js.last_convex)

    def test_rungs_log_once_per_change(self, drills, solver_log):
        ts = TorchSolver(device="cpu", g_max=G, tier="convex")
        _, tp = world("adversarial")
        for site, exc in (("convex.rounding", "RuntimeError"), ("convex.rounding", "RuntimeError"),
                          ("convex.rounding", "ValueError"), ("rpc.convex.dispatch", "RuntimeError")):
            drills[1].arm(site, "error", exc, times=1)
            ts.solve(TNodePool("default"), catalog_items_cache["torch"], tp)
            drills[1].reset()
        msgs = [r.getMessage() for r in solver_log]
        assert msgs == ["convex rounding failed; tick stays on FFD"] * 2 + [
            "convex relaxation dispatch failed; tick stays on FFD"]
        assert [r.error.split(":")[0] for r in solver_log] == ["RuntimeError", "ValueError",
                                                               "RuntimeError"]

    @pytest.mark.parametrize("site", ["convex.rounding", "rpc.convex.dispatch",
                                      "solver.solve_begin", "solver.solve_finish"])
    def test_operator_crashed_escapes(self, drills, site):
        drills[1].arm(site, "crash")
        ts = TorchSolver(device="cpu", g_max=G, tier="convex")
        with pytest.raises(tfailpoints.OperatorCrashed):
            ts.solve(TNodePool("default"), catalog_items_cache["torch"], world("adversarial")[1])
        assert drills[1].fires(site) == 1
