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
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

from karpenter_tpu_torch.apis import Pod, PodAffinityTerm, TopologySpreadConstraint, labels as wk
from karpenter_tpu_torch.providers.instancetype import gen_catalog
from karpenter_tpu_torch.providers.instancetype.types import (
    InstanceType, NodeClassConfig, Offering, Resolver,
)
from karpenter_tpu_torch.scheduling import Resources, Toleration
from karpenter_tpu_torch.scheduling import resources as res
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
        gen_catalog.generate_instance_types(), NodeClassConfig(), offerings_for)


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
