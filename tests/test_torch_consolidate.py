"""The port's consolidation engine against the JAX package's, on the CPU.

`DisruptEngine(device="cpu").evaluate` (karpenter_tpu_torch) against
`karpenter_tpu.solver.disrupt.DisruptEngine().evaluate` -- the JAX
engine's local route, the only one it takes without a sidecar client --
on the same worlds, each built once from a plain spec in both packages
(or, for catalogs and pools the JAX Operator makes, converted field by
field). Verdicts must be repr-equal: `SetVerdict` is the same dataclass
in both, so its repr compares every field exactly.

Worlds: tests/test_consolidate.py's repack, replacement and startup-taint
cases; tests/test_disrupt.py's `_fleet()` with and without pools; a
delete-only call and an empty-pods set; the bench and ramp-down sweeps of
`workload` cut to a small size; and every `evaluate` call the JAX
disruption controller makes in tests/test_consolidate.py's controller
worlds, recorded and replayed. Also `disrupt_replace` alone (exact on
integer requests; within two float32 ulps of `agg` on fractional ones),
its ties, `enumerate_pairs`, `device_eligible`, and the three-pool
merged catalog (K=1920) that kernel A now solves in its scratch layout.
"""
import numpy as np
import pytest

import jax  # noqa: F401  -- both frameworks in one process; data crosses as numpy
import jax.numpy as jnp
import torch

import karpenter_tpu.apis as japis
import karpenter_tpu.scheduling as jsched
import karpenter_tpu_torch.apis as tapis
import karpenter_tpu_torch.scheduling as tsched
from karpenter_tpu.apis import NodeClaim, NodePool as JNodePool, Pod as JPod, TPUNodeClass
from karpenter_tpu.cache.ttl import FakeClock
from karpenter_tpu.controllers.disruption import MIN_NODE_LIFETIME
from karpenter_tpu.operator import Operator
from karpenter_tpu.solver.disrupt import DisruptEngine as JEngine
from karpenter_tpu.solver.disrupt import kernel as jkernel
from karpenter_tpu.solver.oracle import ExistingNode as JNode
from karpenter_tpu.solver.oracle import Scheduler as JScheduler
from karpenter_tpu.solver.service import TPUSolver
from karpenter_tpu_torch import workload
from karpenter_tpu_torch.providers.instancetype.types import InstanceType as TInstanceType
from karpenter_tpu_torch.providers.instancetype.types import Offering as TOffering
from karpenter_tpu_torch.scheduling.requirements import Requirement as TRequirement
from karpenter_tpu_torch.solver import consolidate as tconsolidate
from karpenter_tpu_torch.solver import disrupt as tdisrupt
from karpenter_tpu_torch.solver.disrupt import kernel as tkernel
from karpenter_tpu_torch.solver.kernels import ffd_scan
from karpenter_tpu_torch.solver.oracle import ExistingNode as TNode
from karpenter_tpu_torch.solver.oracle import Scheduler as TScheduler
from karpenter_tpu_torch.solver.service import TorchSolver
from tests.test_packing import catalog_items  # noqa: F401  -- the JAX chain fixture
from tests.test_torch_catalog import port_items  # noqa: F401
from tests.test_torch_oracle import result_sig

# small tensors: one intra-op thread per test worker (several workers share the cores)
torch.set_num_threads(1)

ZONE_A = "us-central-1a"
CAPTYPE = "karpenter.sh/capacity-type"


def sig(verdicts):
    return [repr(v) for v in verdicts]


# -- worlds in both packages ------------------------------------------------------


class Pkg:
    """One package's constructors, so a world builds in either."""

    def __init__(self, which):
        apis, sched = (japis, jsched) if which == "jax" else (tapis, tsched)
        self.which = which
        self.Pod, self.NodePool = apis.Pod, apis.NodePool
        self.Resources, self.Requirement = sched.Resources, sched.Requirement
        self.Taint, self.Toleration = sched.Taint, sched.Toleration
        self.Node = JNode if which == "jax" else TNode
        self.Spread, self.Affinity = apis.TopologySpreadConstraint, apis.PodAffinityTerm

    def engine(self, **kw):
        return JEngine(**kw) if self.which == "jax" else tdisrupt.DisruptEngine(device="cpu", **kw)


PKGS = {"jax": Pkg("jax"), "torch": Pkg("torch")}


def mk_node(pkg, name, cpu_m, mem_mib, used_cpu_m=0, used_mem_mib=0, pods_cap=110):
    """tests/test_consolidate.py mk_node, in package `pkg`."""
    return pkg.Node(
        name=name,
        labels={"kubernetes.io/hostname": name, "topology.kubernetes.io/zone": ZONE_A},
        allocatable=pkg.Resources.from_base_units(
            {"cpu": cpu_m, "memory": mem_mib * 2**20, "pods": pods_cap}),
        used=pkg.Resources.from_base_units({"cpu": used_cpu_m, "memory": used_mem_mib * 2**20}),
    )


def mk_pods(pkg, n, cpu_m, mem_mib, prefix="p"):
    """tests/test_consolidate.py mk_pods, in package `pkg`."""
    return [
        pkg.Pod(f"{prefix}-{i}",
                requests=pkg.Resources.from_base_units({"cpu": cpu_m, "memory": mem_mib * 2**20}))
        for i in range(n)
    ]


def both(world, **eval_kw):
    """(JAX verdicts, port verdicts) of `world(pkg) -> (nodes, sets, kw)`."""
    out = []
    for which in ("jax", "torch"):
        pkg = PKGS[which]
        nodes, sets, kw = world(pkg)
        out.append(sig(pkg.engine().evaluate(nodes, sets, **kw, **eval_kw)))
    return out


def jax_sweep(spec):
    """workload.sweep_world with the JAX package's types."""
    pkg = PKGS["jax"]
    nodes = [pkg.Node(name, dict(labels), pkg.Resources.from_base_units(alloc),
                      [pkg.Taint(k, e, v) for k, e, v in taints],
                      pkg.Resources.from_base_units(used))
             for name, labels, alloc, used, taints in spec["nodes"]]
    pods = [[pkg.Pod(p["name"], requests=pkg.Resources.from_base_units(p["req"]),
                     node_selector=p.get("selector") or {},
                     tolerations=[pkg.Toleration(*t) for t in p.get("tol", ())],
                     labels=dict(p.get("labels") or {}))
             for p in cand] for cand in spec["pods"]]
    sets = [([p for i in idx for p in pods[i]], [spec["candidates"][i] for i in idx])
            for idx in spec["sets"]]
    return nodes, sets


def sweep_pools(which, kind):
    """workload.sweep_pools in either package."""
    if which == "torch":
        return workload.sweep_pools(kind)
    pkg = PKGS["jax"]
    if kind == "default":
        return [pkg.NodePool("default")], {}
    pools = [pkg.NodePool(name, weight=w, requirements=[pkg.Requirement(CAPTYPE, "In", [name])])
             for name, w in workload.SWEEP_POOLS]
    return pools, {n: pkg.Resources.from_base_units(v) for n, v in workload.SWEEP_OVERHEAD.items()}


# -- JAX objects converted to the port's ---------------------------------------------


def port_requirement(r):
    out = object.__new__(TRequirement)
    for slot in TRequirement.__slots__:
        value = getattr(r, slot)
        setattr(out, slot, set(value) if slot == "values" else value)
    return out


def port_requirements(reqs):
    return tsched.Requirements(port_requirement(r) for r in reqs)


def port_resources(r):
    return tsched.Resources.from_base_units(dict(r.items()))


def port_nodes(nodes):
    return [TNode(n.name, dict(n.labels), port_resources(n.allocatable),
                  [tsched.Taint(t.key, t.effect, t.value) for t in n.taints], port_resources(n.used))
            for n in nodes]


def port_pod(p):
    reqs = lambda terms: [port_requirement(r) for r in terms]  # noqa: E731
    out = tapis.Pod(
        p.metadata.name, namespace=p.metadata.namespace, requests=port_resources(p.requests),
        node_selector=dict(p.node_selector),
        node_affinity_terms=[reqs(t) for t in p.node_affinity_terms],
        preferred_node_affinity_terms=[(w, reqs(t)) for w, t in p.preferred_node_affinity_terms],
        tolerations=[tsched.Toleration(t.key, t.operator, t.value, t.effect) for t in p.tolerations],
        topology_spread=[tapis.TopologySpreadConstraint(t.max_skew, t.topology_key,
                                                        t.when_unsatisfiable, dict(t.label_selector))
                         for t in p.topology_spread],
        affinity_terms=[tapis.PodAffinityTerm(dict(t.label_selector), t.topology_key, t.anti)
                        for t in p.affinity_terms],
        preferred_affinity_terms=[
            (w, tapis.PodAffinityTerm(dict(t.label_selector), t.topology_key, t.anti))
            for w, t in p.preferred_affinity_terms],
        priority=p.priority, labels=dict(p.metadata.labels), owner_kind=p.owner_kind,
        volume_claims=p.volume_claims,
    )
    return out


def port_pool(pool):
    out = tapis.NodePool(pool.name, limits=None if pool.limits is None else port_resources(pool.limits),
                         weight=pool.weight)
    t = pool.template
    out.template.labels = dict(t.labels)
    out.template.requirements = [port_requirement(r) for r in t.requirements]
    out.template.taints = [tsched.Taint(x.key, x.effect, x.value) for x in t.taints]
    out.template.startup_taints = [tsched.Taint(x.key, x.effect, x.value) for x in t.startup_taints]
    return out


def port_catalog(items):
    return [
        TInstanceType(
            name=it.name, requirements=port_requirements(it.requirements),
            capacity=port_resources(it.capacity), overhead=port_resources(it.overhead),
            offerings=[TOffering(o.capacity_type, o.zone, o.zone_id, o.price, o.available,
                                 o.reservation_id, o.reservation_capacity) for o in it.offerings])
        for it in items
    ]


def port_call(nodes, sets, pools=(), catalogs=None, daemon_overhead=None):
    """One evaluate call's arguments as the port's objects."""
    return dict(
        nodes=port_nodes(nodes),
        sets=[([port_pod(p) for p in pods], list(excluded)) for pods, excluded in sets],
        pools=[port_pool(p) for p in pools],
        catalogs=None if catalogs is None else {k: port_catalog(v) for k, v in catalogs.items()},
        daemon_overhead=None if daemon_overhead is None else {
            k: None if v is None else port_resources(v) for k, v in daemon_overhead.items()},
    )


# -- tests/test_consolidate.py worlds ------------------------------------------------


class TestRepackWorlds:
    def test_simple_fit_and_overflow(self):
        def world(pkg):
            nodes = [mk_node(pkg, "n0", 4000, 8192), mk_node(pkg, "n1", 4000, 8192)]
            return nodes, [(mk_pods(pkg, 4, 1000, 1024), []), (mk_pods(pkg, 9, 1000, 1024), [])], {}

        want, got = both(world)
        assert got == want
        assert "can_delete=False, leftover=1" in want[1]

    @pytest.mark.parametrize("n_pods", [4, 5])
    def test_excluded_node_capacity_removed(self, n_pods):
        def world(pkg):
            nodes = [mk_node(pkg, "n0", 4000, 8192), mk_node(pkg, "n1", 4000, 8192)]
            return nodes, [(mk_pods(pkg, n_pods, 1000, 1024), ["n1"])], {}

        want, got = both(world)
        assert got == want

    def test_randomized(self):
        """The 25 trials of TestRepackDifferential.test_randomized_against_oracle."""
        rng = np.random.default_rng(7)
        trials = []
        for trial in range(25):
            nodes = [(f"n{i}", int(rng.choice([2000, 4000, 8000, 16000])),
                      int(rng.choice([4096, 8192, 16384])), int(rng.integers(0, 2000)),
                      int(rng.integers(0, 2048)))
                     for i in range(int(rng.integers(1, 8)))]
            pods = [(int(rng.integers(1, 12)), int(rng.choice([100, 250, 500, 1000, 2000])),
                     int(rng.choice([128, 512, 1024, 4096])), f"t{trial}s{s}")
                    for s in range(int(rng.integers(1, 4)))]
            trials.append((nodes, pods))

        def world(pkg):
            nodes, sets = [], []
            for t, (node_spec, pod_spec) in enumerate(trials):
                nodes += [mk_node(pkg, f"{name}-{t}", c, m, uc, um) for name, c, m, uc, um in node_spec]
                pods = [p for n, c, m, pre in pod_spec for p in mk_pods(pkg, n, c, m, prefix=pre)]
                sets.append((pods, []))
            return nodes, sets, {}

        # one node list per trial: each evaluate sees only its own trial's nodes
        for t in range(len(trials)):
            def one(pkg, t=t):
                nodes, sets, kw = world(pkg)
                mine = [n for n in nodes if n.name.endswith(f"-{t}")]
                return mine, [sets[t]], kw

            want, got = both(one)
            assert got == want, t

    def test_taints_and_selectors_respected(self):
        def world(pkg, tolerate, pinned):
            tainted = mk_node(pkg, "n0", 8000, 16384)
            tainted.taints = [pkg.Taint("dedicated", value="batch", effect="NoSchedule")]
            plain = mk_node(pkg, "n1", 2000, 4096)
            if pinned:
                pods = [pkg.Pod(f"z-{i}", requests=pkg.Resources({"cpu": "100m"}),
                                node_selector={"topology.kubernetes.io/zone": "us-central-1d"})
                        for i in range(2)]
                return [plain], [(pods, [])], {}
            pods = mk_pods(pkg, 3, 1000, 1024)
            if tolerate:
                for p in pods:
                    p.tolerations = [pkg.Toleration("dedicated", value="batch", effect="NoSchedule")]
            return [tainted, plain], [(pods, [])], {}

        for tolerate, pinned in ((False, False), (True, False), (False, True)):
            want, got = both(lambda pkg: world(pkg, tolerate, pinned))
            assert got == want

    def test_first_fit_order(self):
        def world(pkg):
            nodes = [mk_node(pkg, "n0", 2500, 8192), mk_node(pkg, "n1", 2500, 8192)]
            return nodes, [(mk_pods(pkg, 4, 1000, 512), [])], {}

        want, got = both(world)
        assert got == want


def operator_catalog(taints=(), startup_taints=()):
    """tests/test_consolidate.py's replacement context: the Operator's
    default pool and its cloud provider's catalog (JAX objects)."""
    op = Operator(clock=FakeClock(100_000.0))
    op.cluster.create(TPUNodeClass("default"))
    pool = JNodePool("default")
    pool.template.taints = list(taints)
    pool.template.startup_taints = list(startup_taints)
    op.cluster.create(pool)
    op.nodeclass_controller.reconcile_all()
    pool = op.cluster.get(JNodePool, "default")
    return pool, op.cloud_provider.get_instance_types(pool)


@pytest.fixture(scope="module")
def op_catalog():
    pool, items = operator_catalog()
    return pool, items, port_pool(pool), port_catalog(items)


def replace_both(pool_cat, nodes_fn, sets_fn):
    jpool, jitems, tpool, titems = pool_cat
    want = JEngine().evaluate(nodes_fn(PKGS["jax"]), sets_fn(PKGS["jax"]), pools=[jpool],
                              catalogs={jpool.name: jitems})
    got = tdisrupt.DisruptEngine(device="cpu").evaluate(
        nodes_fn(PKGS["torch"]), sets_fn(PKGS["torch"]), pools=[tpool], catalogs={tpool.name: titems})
    return sig(want), sig(got)


class TestReplacementWorlds:
    def test_converted_catalog_encodes_byte_equal(self, op_catalog):
        from karpenter_tpu.solver import encode as jencode
        from karpenter_tpu_torch.solver import encode as tencode

        _, jitems, _, titems = op_catalog
        j, t = jencode.encode_catalog(jitems), tencode.encode_catalog(titems)
        for field in ("names", "cap", "tcode", "tnum", "tzone", "tcap", "price"):
            assert np.asarray(getattr(j, field)).tobytes() == np.asarray(getattr(t, field)).tobytes()

    @pytest.mark.parametrize("n, cpu_m, mem_mib", [(3, 1000, 2048), (600, 1000, 1024), (2, 500, 1024)])
    def test_replacement_search(self, op_catalog, n, cpu_m, mem_mib):
        """No live capacity: found (3 pods), impossible aggregate (600),
        the on-demand price tracked apart (2)."""
        want, got = replace_both(op_catalog, lambda pkg: [],
                                 lambda pkg: [(mk_pods(pkg, n, cpu_m, mem_mib), [])])
        assert got == want
        assert ("replace_price=inf" in want[0]) == (n == 600)

    @pytest.mark.parametrize("startup", [True, False])
    def test_template_taints(self, startup):
        """Startup taints do not block the replacement; template taints do."""
        taint = jsched.Taint("node.cilium.io/agent-not-ready" if startup else "dedicated",
                             value="true" if startup else "gpu", effect="NoSchedule")
        jpool, jitems = operator_catalog(**({"startup_taints": [taint]} if startup else {"taints": [taint]}))
        pool_cat = (jpool, jitems, port_pool(jpool), port_catalog(jitems))
        want, got = replace_both(pool_cat, lambda pkg: [], lambda pkg: [(mk_pods(pkg, 3, 1000, 2048), [])])
        assert got == want
        assert ("replace_price=inf" in want[0]) == (not startup)


def fleet(pkg):
    """tests/test_disrupt.py _fleet()."""
    nodes = [mk_node(pkg, "n0", 4000, 8192), mk_node(pkg, "n1", 4000, 8192)]
    sets = [
        (mk_pods(pkg, 4, 1000, 1024), []),
        (mk_pods(pkg, 9, 1000, 1024, prefix="q"), ["n1"]),
        (mk_pods(pkg, 40, 1000, 2048, prefix="r"), []),
    ]
    return nodes, sets


class TestFleet:
    def test_with_pools(self, op_catalog):
        want, got = replace_both(op_catalog, lambda pkg: fleet(pkg)[0], lambda pkg: fleet(pkg)[1])
        assert got == want
        assert [v.split("(")[0] for v in want] == ["SetVerdict"] * 3

    def test_delete_only(self):
        want, got = both(lambda pkg: (*fleet(pkg), {}))
        assert got == want
        assert "nodepool=None" in want[2] and "can_delete=False" in want[2]

    def test_empty_pods_set(self, op_catalog):
        """A set with no pods deletes; with every set empty the engine
        answers without a dispatch."""
        def sets(pkg):
            return [([], ["n0"])] + fleet(pkg)[1]

        want, got = replace_both(op_catalog, lambda pkg: fleet(pkg)[0], sets)
        assert got == want and "can_delete=True, leftover=0" in want[0]
        engine = tdisrupt.DisruptEngine(device="cpu")
        assert sig(engine.evaluate(fleet(PKGS["torch"])[0], [([], [])])) == \
            sig(JEngine().evaluate(fleet(PKGS["jax"])[0], [([], [])]))
        assert engine.last_dispatch["path"] == "none"
        assert engine.evaluate([], []) == []


# -- the sweeps, cut to a small size -------------------------------------------------


@pytest.fixture(scope="module")
def small_tick(port_items):  # noqa: F811
    """A solve tick on the CPU: the cluster the ramp-down sweep starts from."""
    pods = workload.synth_pods(np.random.default_rng(5), workload.ZONES, 3_000, 5, 40)
    return TorchSolver(device="cpu", g_max=128).solve(tapis.NodePool("default"), port_items, pods)


def sweep_both(spec, kind, catalog_items, port_items):  # noqa: F811
    out = []
    for which, items in (("jax", catalog_items), ("torch", port_items)):
        nodes, sets = jax_sweep(spec) if which == "jax" else workload.sweep_world(spec)
        pools, ovh = sweep_pools(which, kind)
        engine = PKGS[which].engine()
        out.append(sig(engine.evaluate(nodes, sets, pools=pools,
                                       catalogs={p.name: items for p in pools},
                                       daemon_overhead=ovh or None)))
    return out


class TestSweeps:
    def test_bench_sweep(self, catalog_items, port_items):  # noqa: F811
        spec = workload.bench_sweep_spec(64, 16)
        assert len(spec["sets"]) == 16 + 15 + 14
        want, got = sweep_both(spec, "default", catalog_items, port_items)
        assert got == want

    def test_bench_sweep_full_set_count(self):
        """The 50k tier's enumeration: 256 singletons, prefixes 2..32 and
        14 pairs, 301 sets (bench.py `_consolidation_stage`)."""
        spec = workload.bench_sweep_spec()
        assert len(spec["nodes"]) == 1024 and len(spec["sets"]) == 301
        assert [len(p) for p in spec["pods"][:4]] == [1, 2, 3, 1]

    @pytest.mark.parametrize("kind", ["default", "spot-od"])
    @pytest.mark.parametrize("keep", [0.25, 1.0])
    def test_rampdown_sweep(self, small_tick, catalog_items, port_items, kind, keep):  # noqa: F811
        """After the ramp-down every set deletes; in the cluster as the
        tick left it (keep 1.0) the replacement search decides some sets."""
        spec = workload.rampdown_sweep_spec(small_tick, np.random.default_rng(11), n_cand=16,
                                            keep=keep)
        want, got = sweep_both(spec, kind, catalog_items, port_items)
        assert got == want
        if keep == 1.0:
            assert any("replace_type='" in v for v in want), "no set took the replacement search"
        else:
            assert all("can_delete=True" in v for v in want)

    def test_rampdown_keeps_a_quarter(self, small_tick):
        spec = workload.rampdown_sweep_spec(small_tick, np.random.default_rng(11), n_cand=16)
        by_node = workload.pods_by_node(small_tick)
        kept = {p["name"] for cand in spec["pods"] for p in cand}
        for name, cand in zip(spec["candidates"], spec["pods"]):
            n = len(by_node[name])
            assert len(cand) == n - (3 * n) // 4 >= 1
        cpu = [sum(p["req"]["cpu"] for p in cand) for cand in spec["pods"]]
        assert cpu == sorted(cpu) and len(kept) == sum(len(c) for c in spec["pods"])


# -- the controller's own calls, recorded and replayed --------------------------------


class RecordingEngine(JEngine):
    """The JAX engine, keeping each evaluate call converted to the port's
    objects (at call time: the controller mutates its cluster after) beside
    the verdicts it returned."""

    def __init__(self):
        super().__init__()
        self.calls = []

    def evaluate(self, nodes, sets, pools=(), catalogs=None, daemon_overhead=None):
        verdicts = super().evaluate(nodes, sets, pools=pools, catalogs=catalogs,
                                    daemon_overhead=daemon_overhead)
        self.calls.append((port_call(nodes, sets, pools, catalogs, daemon_overhead), sig(verdicts)))
        return verdicts


def overprovisioned(evaluator, n_nodes):
    """tests/test_consolidate.py build_overprovisioned (2 nodes) and the
    multi-node prefix world (3): nodes left holding one small pod each."""
    op = Operator(clock=FakeClock(100_000.0), consolidation_evaluator=evaluator)
    op.cluster.create(TPUNodeClass("default"))
    op.cluster.create(JNodePool("default"))
    for i in range(n_nodes):
        op.cluster.create(JPod(f"big{i}", requests=jsched.Resources({"cpu": "3", "memory": "4Gi"})))
        op.settle(max_ticks=30)
        op.cluster.create(JPod(f"small{i}", requests=jsched.Resources({"cpu": "600m", "memory": "512Mi"})))
        op.settle(max_ticks=30)
    for i in range(n_nodes):
        big = op.cluster.get(JPod, f"big{i}")
        big.metadata.finalizers = []
        op.cluster.delete(JPod, f"big{i}")
    op.clock.step(MIN_NODE_LIFETIME + 60)
    return op


class TestControllerReplay:
    @pytest.mark.parametrize("n_nodes", [2, 3])
    def test_replayed_calls_decide_alike(self, n_nodes):
        """TestControllerEquivalence's worlds (2 nodes: the decision
        world; 3: the multi-node prefix batch): every evaluate call the
        JAX controller makes, replayed through the port's engine."""
        rec = RecordingEngine()
        op = overprovisioned(rec, n_nodes)
        if len(op.cluster.list(NodeClaim)) < n_nodes:
            pytest.skip("pods packed onto fewer nodes; nothing to consolidate")
        decisions = op.disruption.reconcile(max_disruptions=5)
        assert decisions and rec.calls
        assert any(call["pools"] for call, _ in rec.calls), "no call carried a replacement context"
        engine = tconsolidate.ConsolidationEvaluator(device="cpu")
        for call, want in rec.calls:
            assert sig(engine.evaluate(**call)) == want


# -- disrupt_replace alone ------------------------------------------------------------


def replace_operands(seed, S=16, C=6, K=40, Z=8, CT=3, R=9, fractional=False):
    rng = np.random.default_rng(seed)
    leftover = rng.integers(0, 4, (S, C)).astype(np.int32)
    leftover[rng.random((S, C)) < 0.4] = 0
    leftover[0] = 0                                 # a set with nothing left over
    if fractional:
        req = rng.uniform(0.1, 0.8, (C, R)).astype(np.float32)
    else:
        req = rng.integers(0, 500, (C, R)).astype(np.float32)
    compat = rng.random((C, K)) < 0.8
    azone = rng.random((C, Z)) < 0.8
    acap = rng.random((C, CT)) < 0.8
    cap = (rng.integers(0, 8000, (K, R)) if not fractional else rng.uniform(0, 12, (K, R)))
    cap = cap.astype(np.float32)
    ovh = np.zeros((R,), np.float32)
    ovh[:2] = 100.0 if not fractional else 0.5
    price = rng.uniform(0.01, 5.0, (K, Z, CT)).astype(np.float32)
    price[rng.random((K, Z, CT)) < 0.3] = np.inf
    return leftover, req, compat, azone, acap, cap, ovh, price


def run_replace(ops, od_col=2):
    want = [np.asarray(x) for x in jkernel.disrupt_replace(*(jnp.asarray(a) for a in ops), od_col=od_col)]
    got = [x.numpy() for x in tkernel.disrupt_replace(*(torch.from_numpy(a) for a in ops), od_col=od_col)]
    return want, got


class TestDisruptReplace:
    @pytest.mark.parametrize("seed", range(4))
    def test_integer_requests_exact(self, seed):
        ops = replace_operands(seed)
        want, got = run_replace(ops)
        for a, b in zip(want, got):
            assert a.dtype == b.dtype and np.array_equal(a, b)
        assert np.isfinite(want[0]).any() and (want[2] >= 0).any() and (want[2] == -1).any()

    def test_counts_and_dtypes(self):
        before = tkernel.replace_calls
        _, got = run_replace(replace_operands(9))
        assert tkernel.replace_calls == before + 1
        assert [g.dtype for g in got] == [np.float32, np.float32, np.int32]

    @pytest.mark.parametrize("seed", range(3))
    def test_fractional_requests_within_two_ulps(self, seed):
        """Tolerance: `agg` within 2 float32 ulps of the JAX einsum, and
        verdicts equal unless some capacity lies within that band of `agg`
        (the fit test may then go either way). Why 2: the port's `agg` is
        the exact sum rounded once, while the JAX einsum sums in float32 in
        XLA's own order; on these inputs (C = 32 fractional requests) that
        sum lands up to 2 ulps from the exact one, 1 on about a third of the
        entries."""
        ops = replace_operands(seed, S=64, C=32, fractional=True)
        leftover, req, _, _, _, cap, ovh, _ = ops
        jagg = np.asarray(jnp.einsum("sc,cr->sr", jnp.asarray(leftover).astype(jnp.float32),
                                     jnp.asarray(req)))
        tagg = tkernel.aggregate(torch.from_numpy(leftover), torch.from_numpy(req)).numpy()
        band = 2 * np.maximum(np.spacing(np.abs(jagg)), np.spacing(np.abs(tagg)))
        assert np.all(np.abs(tagg - jagg) <= band)
        exact = (np.asarray(leftover, np.float64) @ np.asarray(req, np.float64)).astype(np.float32)
        assert np.array_equal(tagg, exact)
        want, got = run_replace(ops)
        cap_eff = np.maximum(cap - ovh[None, :], 0.0)
        for s in range(leftover.shape[0]):
            if not all(np.array_equal(a[s], b[s]) for a, b in zip(want, got)):
                near = np.abs(cap_eff - jagg[s][None, :]) <= band[s][None, :]
                assert near.any(), f"set {s} differs with no capacity within 2 ulps of its aggregate"

    def test_tied_prices_take_the_first_type(self):
        leftover, req, compat, azone, acap, cap, ovh, price = replace_operands(4)
        price = np.where(np.isfinite(price), np.float32(1.5), price).astype(np.float32)
        price[3] = 1.5                                 # one type offered everywhere at the tie
        want, got = run_replace((leftover, req, compat, azone, acap, cap, ovh, price))
        for a, b in zip(want, got):
            assert np.array_equal(a, b)
        assert (want[2] >= 0).any()

    def test_all_inf_rows(self):
        leftover, req, compat, azone, acap, cap, ovh, price = replace_operands(5)
        price[:] = np.inf
        want, got = run_replace((leftover, req, compat, azone, acap, cap, ovh, price))
        for a, b in zip(want, got):
            assert np.array_equal(a, b)
        assert np.all(got[2] == -1) and np.all(np.isinf(got[0]))


# -- enumeration, eligibility, the engine's device ------------------------------------


class TestHelpers:
    def test_enumerate_pairs(self):
        """tests/test_disrupt.py TestPairEnumeration, on both packages."""
        from karpenter_tpu.solver.disrupt import enumerate_pairs as jpairs

        pairs = tdisrupt.enumerate_pairs(10, window=4)
        assert pairs == [(0, 2), (0, 3), (1, 2), (1, 3), (2, 3)]
        assert tdisrupt.enumerate_pairs(1) == [] and tdisrupt.enumerate_pairs(2) == []
        for n in range(0, 12):
            assert tdisrupt.enumerate_pairs(n) == jpairs(n)

    def test_device_eligible(self):
        from karpenter_tpu.solver.disrupt import device_eligible as jeligible

        def cases(pkg):
            R = pkg.Resources({"cpu": "100m"})
            zone = "topology.kubernetes.io/zone"
            return [
                [pkg.Pod("plain", requests=R)],
                [pkg.Pod("aff", requests=R, affinity_terms=[pkg.Affinity({"a": "b"})])],
                [pkg.Pod("paff", requests=R, preferred_affinity_terms=[(5, pkg.Affinity({"a": "b"}))])],
                [pkg.Pod("pnode", requests=R, preferred_node_affinity_terms=[
                    (5, [pkg.Requirement(zone, "In", [ZONE_A])])])],
                [pkg.Pod("hard", requests=R, topology_spread=[pkg.Spread(1, zone, "DoNotSchedule")])],
                [pkg.Pod("soft", requests=R, topology_spread=[pkg.Spread(1, zone, "ScheduleAnyway")])],
                [pkg.Pod("terms", requests=R, node_affinity_terms=[
                    [pkg.Requirement(zone, "In", [ZONE_A])], [pkg.Requirement(zone, "In", ["x"])]])],
                [pkg.Pod("one-term", requests=R, node_affinity_terms=[
                    [pkg.Requirement(zone, "In", [ZONE_A])]])],
            ]

        got = [tdisrupt.device_eligible(c) for c in cases(PKGS["torch"])]
        assert got == [jeligible(c) for c in cases(PKGS["jax"])]
        assert got == [True, False, False, False, False, True, False, True]

    def test_engine_needs_the_card_unless_told(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="CUDA"):
            tdisrupt.DisruptEngine()
        assert tdisrupt.DisruptEngine(device="cpu").device.type == "cpu"
        assert tdisrupt.DisruptEngine(solver=TorchSolver(device="cpu")).device.type == "cpu"

    def test_solver_lends_its_catalog(self, port_items):  # noqa: F811
        solver = TorchSolver(device="cpu")
        engine = tdisrupt.DisruptEngine(solver=solver)
        nodes, sets = fleet(PKGS["torch"])
        pool = tapis.NodePool("default")
        got = engine.evaluate(nodes, sets, pools=[pool], catalogs={"default": port_items})
        assert id(port_items) in solver._catalog_cache and not engine._catalog_cache
        assert sig(got) == sig(tdisrupt.DisruptEngine(device="cpu").evaluate(
            nodes, sets, pools=[pool], catalogs={"default": port_items}))
        assert engine.last_dispatch["path"] == "local" and engine.last_dispatch["sets"] == 3


# -- three pools over the full catalog: kernel A's scratch layout ---------------------


def three_pools(pkg):
    return [pkg.NodePool(name, weight=w, requirements=[pkg.Requirement(CAPTYPE, "In", [name])])
            for name, w in (("spot", 100), ("on-demand", 10))] + [pkg.NodePool("default")]


class TestThreePoolMergedCatalog:
    def test_layout_is_scratch(self, port_items):  # noqa: F811
        solver = TorchSolver(device="cpu")
        pools = three_pools(PKGS["torch"])
        sched = TScheduler(nodepools=pools, instance_types={p.name: port_items for p in pools},
                           zones=set(workload.ZONES))
        _, entry = solver._merged_catalog(sched)
        K = entry.tensors.k_pad
        assert K == 1920
        assert ffd_scan.layout(1024, K, 9) == "scratch"

    def test_schedule_equals_the_jax_package(self, catalog_items, port_items):  # noqa: F811
        from tests.test_torch_schedule import jax_pods

        pods = workload.synth_pods(np.random.default_rng(31), workload.ZONES, 600, 31, 40)
        out = []
        for which, items, batch in (("jax", catalog_items, jax_pods(pods)), ("torch", port_items, pods)):
            pkg = PKGS[which]
            pools = three_pools(pkg)
            Sched = TScheduler if which == "torch" else JScheduler
            sched = Sched(nodepools=pools, instance_types={p.name: items for p in pools},
                          zones=set(workload.ZONES))
            solver = TPUSolver(g_max=64) if which == "jax" else TorchSolver(device="cpu", g_max=64)
            out.append((result_sig(solver.schedule(sched, list(batch))), solver.last_route))
        assert out[1] == out[0]
        assert out[0][1]["path"] == "merged"
        assert {g[1] for g in out[0][0][1]} >= {"spot"}
