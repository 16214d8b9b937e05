"""The port's oracle Scheduler against the JAX package's, on the same worlds.

A world is one plain spec (`fuzz_spec`: numpy draws in the shape of
tests/test_solver.py TestDifferentialFuzz, widened to affinity,
anti-affinity, preferences, minValues pools, pool limits and daemonset
overhead), built into each package's own objects by `build`. Both
`Scheduler.schedule` runs must give the same `decision_sig` -- groups by
pod names and cheapest type, existing-node assignments, unschedulable
reasons -- and the same group requirements. Tolerance: exact. The helpers
at the bottom are shared by tests/test_torch_schedule.py,
test_torch_spread.py and test_torch_multipool.py.
"""
import copy

import numpy as np
import pytest

import jax  # noqa: F401  -- both frameworks in one process; data crosses as numpy
import torch  # noqa: F401

import karpenter_tpu.apis as japis
import karpenter_tpu.scheduling as jsched
import karpenter_tpu_torch.apis as tapis
import karpenter_tpu_torch.scheduling as tsched
from karpenter_tpu.solver import oracle as joracle
from karpenter_tpu_torch.solver import oracle as toracle
from tests.test_packing import catalog_items  # noqa: F401  -- the JAX chain fixture
from tests.test_torch_catalog import decision_sig, port_items  # noqa: F401

# small tensors: one intra-op thread per test worker (several workers share the cores)
torch.set_num_threads(1)

ZONE = "topology.kubernetes.io/zone"
HOST = "kubernetes.io/hostname"
ARCH = "kubernetes.io/arch"
CAPTYPE = "karpenter.sh/capacity-type"
FAMILY = "karpenter.tpu/instance-family"


class TestSchedulerIdentity:
    @pytest.mark.parametrize("objective", ["price", "fit"])
    @pytest.mark.parametrize("seed", range(8))
    def test_fuzz_world(self, small_items, seed, objective):
        spec = fuzz_spec(seed)
        want = run_oracle("jax", spec, small_items, objective)
        got = run_oracle("torch", spec, small_items, objective)
        assert got == want
        assert want[0][0] or want[0][1], "the world placed nothing"

    @pytest.mark.parametrize("objective", ["price", "fit"])
    def test_min_values_limits_and_overhead(self, small_items, objective):
        """A minValues pool, a limited pool and daemonset overhead on the
        same world: every oracle-only feature at once."""
        spec = fuzz_spec(3, pools=MV_POOLS, overhead=True,
                         limits={"arm": {"cpu": "4"}, "amd": {"cpu": "4"}})
        want = run_oracle("jax", spec, small_items, objective)
        assert run_oracle("torch", spec, small_items, objective) == want
        assert {g[1] for g in want[1]} == {"arm", "amd"}
        assert want[0][2], "the limits left every pod schedulable"

    def test_affinity_and_preferences(self, small_items):
        spec = fuzz_spec(5, affinity=1.0, preferences=1.0)
        want = run_oracle("jax", spec, small_items, "price")
        assert run_oracle("torch", spec, small_items, "price") == want

    def test_seeded_topology_counts(self, small_items):
        """Existing nodes whose bound pods match the spread selectors seed
        the zone counts on both sides."""
        spec = fuzz_spec(3, spread=1.0, nodes=3, bound_spread=True)
        j = build("jax", spec, small_items)
        t = build("torch", spec, small_items)
        assert t.scheduler().topology._counts == j.scheduler().topology._counts
        assert j.scheduler().topology._counts, "no zone count was seeded"
        assert result_sig(t.scheduler().schedule(list(t.pods))) == \
            result_sig(j.scheduler().schedule(list(j.pods)))


# -- helpers shared by the tests/test_torch_*.py files -------------------------


@pytest.fixture(scope="module")
def small_items(catalog_items, port_items):  # noqa: F811
    """Every fourth type of both catalogs (157 of 627, the same names on
    both sides): small enough that the oracle's per-pod type scans stay
    quick, wide enough to keep every zone, captype, arch and family."""
    return {"jax": catalog_items[::4], "torch": port_items[::4]}


class Pkg:
    """One package's constructors, so a spec builds in either."""

    def __init__(self, which):
        apis, sched, orc = (
            (japis, jsched, joracle) if which == "jax" else (tapis, tsched, toracle))
        self.Pod, self.NodePool = apis.Pod, apis.NodePool
        self.Spread, self.Affinity = apis.TopologySpreadConstraint, apis.PodAffinityTerm
        self.Resources, self.Requirement = sched.Resources, sched.Requirement
        self.Taint, self.Toleration = sched.Taint, sched.Toleration
        self.ExistingNode, self.Scheduler = orc.ExistingNode, orc.Scheduler


class World:
    """A spec built in one package: pods, pools, catalogs and a fresh
    Scheduler per call (each owns deep copies of the existing nodes)."""

    def __init__(self, pkg, spec, items):
        self.pkg = pkg
        self.spec = spec
        self.pools = [_pool(pkg, p) for p in spec["pools"]]
        self.catalogs = {p.name: items for p in self.pools}
        self.pods = [_pod(pkg, t, name) for t, name in _pod_names(spec)]
        self.nodes = [
            pkg.ExistingNode(name, dict(labels), pkg.Resources.from_base_units(alloc),
                             [pkg.Taint(k, e, v) for k, e, v in taints],
                             pkg.Resources.from_base_units(used))
            for name, labels, alloc, used, taints in spec["nodes"]
        ]
        self.pods_by_node = {
            node: [_pod(pkg, t, name) for t, name in bound]
            for node, bound in spec["bound"].items()
        }
        self.overhead = {
            name: pkg.Resources.from_base_units(v) for name, v in spec["overhead"].items()
        } or None

    def scheduler(self, objective="price"):
        return self.pkg.Scheduler(
            nodepools=list(self.pools), instance_types=self.catalogs,
            existing_nodes=copy.deepcopy(self.nodes), pods_by_node=self.pods_by_node,
            zones=set(self.spec["zones"]), objective=objective,
            daemon_overhead=self.overhead,
        )


def build(which, spec, items) -> World:
    return World(Pkg(which), spec, items[which])


def run_oracle(which, spec, items, objective):
    w = build(which, spec, items)
    return result_sig(w.scheduler(objective).schedule(list(w.pods)))


def result_sig(res):
    """decision_sig plus each group's pool and requirement hash."""
    groups = sorted(
        (tuple(sorted(p.metadata.name for p in g.pods)), g.nodepool.name,
         g.requirements.stable_hash())
        for g in res.new_groups)
    return decision_sig(res), groups


def _pool(pkg, p):
    reqs = [pkg.Requirement(k, op, vals, min_values=mv) for k, op, vals, mv in p["reqs"]]
    limits = pkg.Resources(p["limits"]) if p.get("limits") else None
    pool = pkg.NodePool(p["name"], requirements=reqs, limits=limits, weight=p["weight"])
    pool.template.taints = [pkg.Taint(k, e, v) for k, e, v in p.get("taints", ())]
    return pool


def _pod_names(spec):
    for t in spec["templates"]:
        for i in range(t["count"]):
            yield t, f"{t['name']}-{i}"


def _pod(pkg, t, name):
    """One pod of template `t` (a spec dict) in package `pkg`."""
    reqs = lambda terms: [pkg.Requirement(k, op, vals) for k, op, vals in terms]  # noqa: E731
    return pkg.Pod(
        name,
        requests=pkg.Resources.from_base_units(t["req"]),
        node_selector=t.get("selector") or {},
        tolerations=[pkg.Toleration(key="dedicated", operator="Exists")] if t.get("tol") else [],
        labels=dict(t.get("labels") or {}),
        topology_spread=[pkg.Spread(max_skew=s, topology_key=k, when_unsatisfiable=w,
                                    label_selector=dict(sel))
                         for s, k, w, sel in t.get("spread", ())],
        affinity_terms=[pkg.Affinity(label_selector=dict(sel), topology_key=k, anti=anti)
                        for sel, k, anti in t.get("aff", ())],
        preferred_affinity_terms=[
            (w, pkg.Affinity(label_selector=dict(sel), topology_key=k, anti=anti))
            for w, sel, k, anti in t.get("paff", ())],
        preferred_node_affinity_terms=[(w, reqs(terms)) for w, terms in t.get("pnode", ())],
        node_affinity_terms=[reqs(terms) for terms in t.get("naff", ())],
    )


DEFAULT_POOLS = [{"name": "default", "weight": 0, "reqs": []}]
# a minValues pool for arm64 pods and a plain pool for amd64 pods: every
# class is admitted by exactly one of them
MV_POOLS = [
    {"name": "arm", "weight": 10,
     "reqs": [(ARCH, "In", ["arm64"], None), (FAMILY, "Exists", [], 3)]},
    {"name": "amd", "weight": 1, "reqs": [(ARCH, "In", ["amd64"], None)]},
]
# two overlapping pools, the weighted spot / on-demand NodePool pattern
SPOT_OD_POOLS = [
    {"name": "spot", "weight": 100, "reqs": [(CAPTYPE, "In", ["spot"], None)]},
    {"name": "on-demand", "weight": 10, "reqs": [(CAPTYPE, "In", ["on-demand"], None)]},
]
# the same two pools, the on-demand one tainted `dedicated`
TAINTED_POOLS = [
    SPOT_OD_POOLS[0],
    dict(SPOT_OD_POOLS[1], taints=[("dedicated", "NoSchedule", "")]),
]


def fuzz_spec(seed, pools=DEFAULT_POOLS, spread=0.4, affinity=0.0, preferences=0.0,
              nodes=None, bound_spread=False, overhead=False, limits=None, arch_pin=None,
              hostname_spread=False, n_templates=None, salt=""):
    """A world in the shape of tests/test_solver.py TestDifferentialFuzz:
    templates of 1-6 replicas with selectors, tolerations, volume-backed
    requests and zone spread (hard and soft); existing nodes with bound
    pods. `affinity`/`preferences` are the fractions of templates that
    carry hostname/zone (anti-)affinity or preferences; `arch_pin` pins
    every template to one arch per template (so each is admitted by one
    of MV_POOLS); `limits` maps pool name -> limits."""
    rng = np.random.default_rng(9000 + seed)
    zones = ["us-central-1a", "us-central-1b", "us-central-1c", "us-central-1d"]
    templates = []
    for t in range(n_templates or int(rng.integers(3, 10))):
        cpu_m = int(rng.choice([100, 250, 500, 1000, 2000, 3000]))
        mem_mi = int(rng.choice([128, 512, 1024, 4096]))
        selector = {}
        u = rng.random()
        if u < 0.2:
            selector[ZONE] = zones[int(rng.integers(0, len(zones)))]
        elif u < 0.35:
            selector[CAPTYPE] = "on-demand"
        elif u < 0.45:
            selector[ARCH] = "arm64" if rng.random() < 0.5 else "amd64"
        if arch_pin:
            selector[ARCH] = "arm64" if rng.random() < 0.5 else "amd64"
        tpl = {"name": f"f{seed}{salt}-{t}", "selector": selector,
               "tol": bool(rng.random() < 0.15), "labels": {"app": f"w{t}"}}
        if rng.random() < spread and not (set(selector) - {ARCH}):
            tpl["spread"] = [(int(rng.choice([1, 2])), ZONE,
                              "ScheduleAnyway" if rng.random() < 0.3 else "DoNotSchedule",
                              {"app": f"w{t}"})]
        if hostname_spread and t == 0:
            tpl["spread"] = [(1, HOST, "DoNotSchedule", {"app": f"w{t}"})]
        if rng.random() < affinity:
            # cpu values no plain template draws: the suffix carve is
            # never blocked by an envelope-key collision
            cpu_m = int(rng.choice([150, 350, 650]))
            tier = f"tier-{seed}-{t}"
            tpl["labels"] = {"tier": tier}
            tpl.pop("spread", None)
            kind = int(rng.integers(0, 3))
            if kind == 0:
                tpl["aff"] = [({"tier": tier}, HOST, False)]
            elif kind == 1:
                tpl["aff"] = [({"tier": tier}, HOST, True)]
            else:
                tpl["aff"] = [({"tier": tier}, ZONE, False)]
        if rng.random() < preferences:
            cpu_m = int(rng.choice([150, 350, 650]))
            tpl["labels"] = {"pref": f"p-{seed}-{t}"}
            tpl.pop("spread", None)
            if rng.random() < 0.5:
                tpl["pnode"] = [(int(rng.integers(1, 100)),
                                 [(CAPTYPE, "In", ["spot"])])]
            else:
                tpl["paff"] = [(int(rng.integers(1, 100)), {"pref": f"p-{seed}-{t}"}, ZONE, True)]
        req = {"cpu": float(cpu_m), "memory": float(mem_mi) * 2**20}
        if rng.random() < 0.15:
            req["attachable-volumes"] = float(rng.integers(1, 7))
        tpl["req"] = req
        tpl["count"] = int(rng.integers(1, 7))
        templates.append(tpl)

    node_list, bound = [], {}
    for ni in range(int(rng.integers(0, 4)) if nodes is None else nodes):
        z = zones[int(rng.integers(0, len(zones)))]
        name = f"f{seed}{salt}-n{ni}"
        alloc = {"cpu": 4000.0, "memory": 8.0 * 2**30, "pods": 20.0, "attachable-volumes": 8.0}
        labels = {ZONE: z, ARCH: "amd64", HOST: name}
        bound_tpls = []
        for j in range(int(rng.integers(0, 3))):
            lbl = {"app": "resident"}
            spread_b = ()
            if bound_spread and templates:
                src = templates[j % len(templates)]
                lbl = dict(src["labels"])
                spread_b = src.get("spread", ())
            bound_tpls.append(({"name": f"b{ni}", "req": {"cpu": 200.0, "memory": 128.0 * 2**20},
                                "labels": lbl, "spread": spread_b, "count": 1},
                               f"f{seed}{salt}-b{ni}-{j}"))
        used = {"cpu": 200.0 * len(bound_tpls), "memory": 128.0 * 2**20 * len(bound_tpls),
                "pods": float(len(bound_tpls))}
        node_list.append((name, labels, alloc, used, []))
        bound[name] = bound_tpls
    pool_specs = []
    for p in pools:
        p = dict(p)
        if limits and p["name"] in limits:
            p["limits"] = limits[p["name"]]
        pool_specs.append(p)
    ovh = {}
    if overhead:
        ovh = {p["name"]: {"cpu": 300.0, "memory": 256.0 * 2**20} for p in pools}
    return {"zones": zones, "templates": templates, "nodes": node_list, "bound": bound,
            "pools": pool_specs, "overhead": ovh}
