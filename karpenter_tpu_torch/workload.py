"""The slice's workload: the generated catalog, the seeded pod sets, and
the nodes one tick leaves for the next.

- `build_catalog_items()` yields the same InstanceType list that the JAX
  package's FakeCloud -> InstanceTypeProvider -> offerings -> pricing
  chain yields for a default node class with a subnet in
  every zone (bench.py `build_catalog_items`): same names, capacities,
  offerings and prices, from the deterministic generator.
- `synth_pods()` is bench.py's seeded pod generator (`synth_pods`): the
  same numpy draws give the same pods. `spread=` gives some of its
  templates a zone topology spread constraint, drawing nothing more.
- `affinity_pods()` are the required hostname-affinity pods of bench.py's
  mixed-affinity datapoint (`_mixed_affinity`).
- `nodes_from_result()` launches a tick's NewNodeGroups as ExistingNodes,
  so a second tick packs onto them; `pods_by_node()` names the pods each
  such node carries, which seeds a Scheduler's topology counts.
- The consolidation sweeps, as plain specs (numbers, strings, dicts) that
  either package builds into its own objects: `bench_sweep_spec()` is
  bench.py's consolidation stage (`_consolidation_stage`) and
  `rampdown_sweep_spec()` the cluster a solve tick leaves after traffic
  falls (or, with `keep=1.0`, as the tick left it); `sweep_world()`
  builds a spec with this package's types.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from karpenter_tpu_torch.apis import Pod, PodAffinityTerm, TPUNodeClass, TopologySpreadConstraint, labels as wk
from karpenter_tpu_torch.providers.instancetype import gen_catalog
from karpenter_tpu_torch.providers.instancetype.types import (
    InstanceType, Offering, Resolver,
)
from karpenter_tpu_torch.scheduling import Resources, Taint, Toleration
from karpenter_tpu_torch.scheduling import resources as res
from karpenter_tpu_torch.solver.disrupt.engine import enumerate_pairs
from karpenter_tpu_torch.solver.oracle import ExistingNode, SchedulingResult

ZONES = list(gen_catalog.ZONE_NAMES)
N_SPEC_TEMPLATES = 160


def build_catalog_items() -> List[InstanceType]:
    """The resolved catalog: every generated type, offered on-demand and
    (where its usage classes allow) spot in each of its zones, priced from
    the generator's static tables; no reservations, nothing unavailable."""
    zone_ids = {z.name: z.zone_id for z in gen_catalog.ZONES}

    def offerings_for(info) -> List[Offering]:
        out = []
        for zone in info.zones:
            if "on-demand" in info.supported_usage_classes:
                out.append(Offering(
                    capacity_type=wk.CAPACITY_TYPE_ON_DEMAND, zone=zone,
                    zone_id=zone_ids[zone], price=gen_catalog.on_demand_price(info)))
            if "spot" in info.supported_usage_classes:
                out.append(Offering(
                    capacity_type=wk.CAPACITY_TYPE_SPOT, zone=zone,
                    zone_id=zone_ids[zone], price=gen_catalog.spot_price(info, zone)))
        return out

    return Resolver(gen_catalog.REGION).resolve(
        gen_catalog.generate_instance_types(), TPUNodeClass("default"), offerings_for)


def synth_pods(rng: np.random.Generator, zones, n_pods: int, salt: int,
               templates: int = 0, spread: int = 0) -> List[Pod]:
    """A pending set of real Pod objects: many replicas over ~160
    deployment specs -- mostly small web pods, some medium services, a few
    large; ~20% zone-pinned, ~15% on-demand-only, some arch constrained,
    some tolerating dedicated taints. Pods of one template share one spec
    object, as ReplicaSet replicas do. `templates` overrides the number of
    templates. `spread` gives the first that many templates without a node
    selector one zone spread constraint on their own label, maxSkew 1:
    every fourth ScheduleAnyway, the rest DoNotSchedule."""
    cpu_choices = np.array([100, 100, 250, 250, 500, 500, 1000, 2000, 4000, 8000])
    mem_choices = np.array([128, 256, 512, 512, 1024, 2048, 4096, 8192, 16384, 32768])

    T = templates or N_SPEC_TEMPLATES
    sizes = rng.integers(0, len(cpu_choices), size=T)
    weights = rng.dirichlet(np.ones(T) * 0.5)
    counts = np.maximum(1, (weights * n_pods).astype(np.int64))
    counts[0] += n_pods - counts.sum()

    specs = []
    for t in range(T):
        selector = {}
        u = rng.random()
        if u < 0.20:
            selector[wk.ZONE_LABEL] = str(zones[int(rng.integers(0, len(zones)))])
        elif u < 0.35:
            selector[wk.CAPACITY_TYPE_LABEL] = wk.CAPACITY_TYPE_ON_DEMAND
        elif u < 0.42:
            selector[wk.ARCH_LABEL] = "arm64" if rng.random() < 0.5 else "amd64"
        tolerations = []
        if rng.random() < 0.1:
            tolerations.append(Toleration(key="dedicated", operator="Exists"))
        requests = Resources.from_base_units({
            res.CPU: float(cpu_choices[sizes[t]]),
            res.MEMORY: float(mem_choices[sizes[t]]) * 2**20,
        })
        specs.append((requests, selector, tolerations))

    pods = []
    i = 0
    n_spread = 0
    for t in range(T):
        requests, selector, tolerations = specs[t]
        labels = {"app": f"app-{salt}-{t}"}
        tsc = []
        if n_spread < spread and not selector:
            when = "ScheduleAnyway" if n_spread % 4 == 3 else "DoNotSchedule"
            tsc = [TopologySpreadConstraint(1, wk.ZONE_LABEL, when, dict(labels))]
            n_spread += 1
        for _ in range(int(counts[t])):
            pods.append(Pod(
                f"bench-{salt}-{i}", requests=requests, node_selector=selector,
                tolerations=tolerations, labels=labels, topology_spread=tsc,
            ))
            i += 1
    return pods


def affinity_pods(salt: int, n: int) -> List[Pod]:
    """`n` pods with required hostname pod affinity to their own tier (16
    tiers), cpu 150/350/650 m and 256 Mi: values synth_pods never draws,
    so the oracle-suffix carve is never blocked by a shared envelope."""
    out = []
    for a in range(n):
        tier = f"bench-aff-{salt}-{a % 16}"
        out.append(Pod(
            f"aff-{salt}-{a}",
            requests=Resources.from_base_units(
                {res.CPU: [150.0, 350.0, 650.0][a % 3], res.MEMORY: 256.0 * 2**20}),
            labels={"tier": tier},
            affinity_terms=[PodAffinityTerm(label_selector={"tier": tier},
                                            topology_key=wk.HOSTNAME_LABEL)],
        ))
    return out


def nodes_from_result(result: SchedulingResult, prefix: str = "node") -> List[ExistingNode]:
    """Each NewNodeGroup launched as one node: the group's cheapest
    surviving type, in the zone and capacity type of that type's cheapest
    offering the group's requirements admit, carrying the group's pods
    (its `requested` is the node's used capacity)."""
    nodes = []
    for i, group in enumerate(result.new_groups):
        it = group.instance_types[0]
        offers = [o for o in it.available_offerings()
                  if group.requirements.compatible(o.requirements())] or it.offerings
        offer = min(offers, key=lambda o: o.price)
        labels = dict(it.requirements.labels())
        labels.update({
            wk.ZONE_LABEL: offer.zone,
            wk.LABEL_ZONE_ID: offer.zone_id,
            wk.CAPACITY_TYPE_LABEL: offer.capacity_type,
            wk.NODEPOOL_LABEL: group.nodepool.name,
            wk.HOSTNAME_LABEL: f"{prefix}-{i}",
        })
        nodes.append(ExistingNode(
            name=f"{prefix}-{i}", labels=labels, allocatable=it.allocatable(),
            taints=list(group.taints), used=group.requested,
        ))
    return nodes


def pods_by_node(result: SchedulingResult, prefix: str = "node") -> Dict[str, List[Pod]]:
    """The pods each node of `nodes_from_result(result, prefix)` carries."""
    return {f"{prefix}-{i}": list(group.pods) for i, group in enumerate(result.new_groups)}


# -- the consolidation sweeps ---------------------------------------------------

SWEEP_CANDIDATES = 256         # candidate nodes a sweep judges
SWEEP_PREFIX_MAX = 32          # the longest price-ranked multi-node prefix
# the rampdown sweep's weighted pools and their daemonset reserve (base units)
SWEEP_POOLS = ((wk.CAPACITY_TYPE_SPOT, 100), (wk.CAPACITY_TYPE_ON_DEMAND, 10))
SWEEP_OVERHEAD = {
    wk.CAPACITY_TYPE_SPOT: {res.CPU: 300.0, res.MEMORY: 256.0 * 2**20},
    wk.CAPACITY_TYPE_ON_DEMAND: {res.CPU: 200.0, res.MEMORY: 128.0 * 2**20},
}


def sweep_sets(n_cand: int, prefix_max: int = SWEEP_PREFIX_MAX) -> List[Tuple[int, ...]]:
    """The disruption controller's enumeration over candidates in cost
    order, as candidate indices: singletons, prefixes 2..prefix_max, and
    the underutilized pairs (`enumerate_pairs`)."""
    sets = [(i,) for i in range(n_cand)]
    sets += [tuple(range(k)) for k in range(2, min(prefix_max, n_cand) + 1)]
    sets += list(enumerate_pairs(n_cand))
    return sets


def bench_sweep_spec(n_nodes: int = 1024, n_cand: int = SWEEP_CANDIDATES, seed: int = 7) -> dict:
    """bench.py `_consolidation_stage` at its 50k tier: `n_nodes` nodes of
    three shapes with seeded usage, in one zone; the first `n_cand` are the
    candidates, each holding 1-3 residual pods of 500m / 512Mi."""
    rng = np.random.default_rng(seed)
    shapes = ((4000, 8 << 30), (8000, 16 << 30), (16000, 32 << 30))
    nodes = []
    for i in range(n_nodes):
        cpu_m, mem = shapes[int(rng.integers(0, len(shapes)))]
        used_cpu = int(rng.integers(200, cpu_m // 4))
        name = f"bench-n{i}"
        nodes.append((name, {wk.HOSTNAME_LABEL: name, wk.ZONE_LABEL: "us-central-1a"},
                      {res.CPU: float(cpu_m), res.MEMORY: float(mem), res.PODS: 110.0},
                      {res.CPU: float(used_cpu), res.MEMORY: float(mem // 8)}, []))
    pods = [
        [{"name": f"bench-c{i}-{j}", "req": {res.CPU: 500.0, res.MEMORY: 512.0 * 2**20}}
         for j in range(1 + i % 3)]
        for i in range(min(n_cand, n_nodes))
    ]
    return {"nodes": nodes, "candidates": [n[0] for n in nodes[: len(pods)]], "pods": pods,
            "sets": sweep_sets(len(pods))}


def _pod_spec(p: Pod) -> dict:
    return {"name": p.metadata.name, "req": dict(p.requests.items()),
            "selector": dict(p.node_selector),
            "tol": [(t.key, t.operator, t.value, t.effect) for t in p.tolerations],
            "labels": dict(p.metadata.labels)}


def rampdown_sweep_spec(result: SchedulingResult, rng: np.random.Generator,
                        n_cand: int = SWEEP_CANDIDATES, prefix: str = "node",
                        keep: float = 0.25) -> dict:
    """The cluster a solve tick leaves (`nodes_from_result`), after traffic
    falls: a seeded 75 % of each node's pods are gone (`keep` is the share
    that stays; 1.0 is the cluster as the tick left it) and its used
    capacity counts only the pods that stay. The `n_cand` nodes with the
    least remaining requested cpu are the candidates, in that order."""
    one = Resources.from_base_units({res.PODS: 1})
    by_node = pods_by_node(result, prefix)
    specs, stay, cpu_left = [], [], []
    for node in nodes_from_result(result, prefix):
        pods = by_node[node.name]
        n = len(pods)
        kept = np.sort(rng.choice(n, n - int((1.0 - keep) * n), replace=False))
        left = [pods[int(i)] for i in kept]
        used = Resources.from_base_units({res.PODS: 0})
        for p in left:
            used = used + p.requests + one
        specs.append((node.name, dict(node.labels), dict(node.allocatable.items()),
                      dict(used.items()), [(t.key, t.effect, t.value) for t in node.taints]))
        stay.append([_pod_spec(p) for p in left])
        cpu_left.append(used.get(res.CPU))
    order = sorted(range(len(specs)), key=lambda i: (cpu_left[i], i))[:n_cand]
    return {"nodes": specs, "candidates": [specs[i][0] for i in order],
            "pods": [stay[i] for i in order], "sets": sweep_sets(len(order))}


def sweep_world(spec: dict) -> Tuple[List[ExistingNode], List[Tuple[List[Pod], List[str]]]]:
    """(nodes, candidate sets) of a sweep spec, as DisruptEngine.evaluate
    takes them: each set is (its candidates' pods, their node names)."""
    nodes = [
        ExistingNode(name, dict(labels), Resources.from_base_units(alloc),
                     [Taint(k, e, v) for k, e, v in taints], Resources.from_base_units(used))
        for name, labels, alloc, used, taints in spec["nodes"]
    ]
    pods = [
        [Pod(p["name"], requests=Resources.from_base_units(p["req"]),
             node_selector=p.get("selector") or {},
             tolerations=[Toleration(*t) for t in p.get("tol", ())],
             labels=dict(p.get("labels") or {}))
         for p in cand]
        for cand in spec["pods"]
    ]
    sets = [([p for i in idx for p in pods[i]], [spec["candidates"][i] for i in idx])
            for idx in spec["sets"]]
    return nodes, sets


def sweep_pools(which: str) -> Tuple[list, Dict[str, Resources]]:
    """(pools, daemonset overhead) of a sweep: `default` (one pool, no
    overhead) or `spot-od` (SWEEP_POOLS with SWEEP_OVERHEAD)."""
    from karpenter_tpu_torch.apis import NodePool
    from karpenter_tpu_torch.scheduling import Requirement

    if which == "default":
        return [NodePool("default")], {}
    pools = [NodePool(name, weight=w, requirements=[Requirement(wk.CAPACITY_TYPE_LABEL, "In", [name])])
             for name, w in SWEEP_POOLS]
    return pools, {name: Resources.from_base_units(v) for name, v in SWEEP_OVERHEAD.items()}
