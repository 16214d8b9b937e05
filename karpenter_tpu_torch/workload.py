"""The slice's workload: the generated catalog, the seeded pod sets, and
the nodes one tick leaves for the next.

- `build_catalog_items()` yields the same InstanceType list that the JAX
  package's FakeCloud -> InstanceTypeProvider -> offerings -> pricing
  chain yields for a default node class with a subnet in
  every zone (bench.py `build_catalog_items`): same names, capacities,
  offerings and prices, from the deterministic generator.
- `synth_pods()` is bench.py's seeded pod generator (`synth_pods`): the
  same numpy draws give the same pods.
- `nodes_from_result()` launches a tick's NewNodeGroups as ExistingNodes,
  so a second tick packs onto them.
"""
from __future__ import annotations

from typing import List

import numpy as np

from karpenter_tpu_torch.apis import Pod, labels as wk
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
               templates: int = 0) -> List[Pod]:
    """A pending set of real Pod objects: many replicas over ~160
    deployment specs -- mostly small web pods, some medium services, a few
    large; ~20% zone-pinned, ~15% on-demand-only, some arch constrained,
    some tolerating dedicated taints. Pods of one template share one spec
    object, as ReplicaSet replicas do. `templates` overrides the number of
    templates."""
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
    for t in range(T):
        requests, selector, tolerations = specs[t]
        for _ in range(int(counts[t])):
            pods.append(Pod(
                f"bench-{salt}-{i}", requests=requests, node_selector=selector,
                tolerations=tolerations, labels={"app": f"app-{salt}-{t}"},
            ))
            i += 1
    return pods


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
