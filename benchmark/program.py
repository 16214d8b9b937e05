"""The system under test, seen from the benchmark: karpenter_tpu_torch's
objects built from the plain inputs, its solver as the binary builds it,
and its results turned back into the plain form the reference reads.

This is the only module of the benchmark that imports the program.
"""
from __future__ import annotations

import os
from typing import Dict, List, Sequence

from gen.catalog import CAPACITY_TYPE_LABEL, ZONE_ID_LABEL, ZONE_LABEL

CAPTYPES = ("reserved", "spot", "on-demand")


def load(cache_dir: str):
    """Import the program with its kernel-library store at `cache_dir`."""
    os.environ["KARPENTER_TPU_COMPILE_CACHE"] = cache_dir
    import karpenter_tpu_torch  # noqa: F401


def instance_types(entries: Sequence[dict]) -> list:
    """The program's InstanceType for each plain catalog entry."""
    from karpenter_tpu_torch.providers.instancetype.types import InstanceType, Offering
    from karpenter_tpu_torch.scheduling import Operator, Requirement, Requirements, Resources

    out = []
    for e in entries:
        reqs = Requirements([Requirement(k, Operator.IN, [v]) for k, v in e["labels"].items()])
        offers = e["offerings"]
        reqs.add(
            Requirement(ZONE_LABEL, Operator.IN, sorted({o[1] for o in offers})),
            Requirement(ZONE_ID_LABEL, Operator.IN, sorted({o[2] for o in offers})),
            Requirement(CAPACITY_TYPE_LABEL, Operator.IN, sorted({o[0] for o in offers})),
        )
        out.append(InstanceType(
            name=e["name"], requirements=reqs,
            capacity=Resources.from_base_units(e["capacity"]),
            overhead=Resources.from_base_units(e["overhead"]),
            offerings=[Offering(capacity_type=ct, zone=z, zone_id=zid, price=p)
                       for ct, z, zid, p in offers]))
    return out


def nodepools(config: dict) -> list:
    """The config's NodePools; a pool with a capacity type requires it, and
    carries its taints ((key, value, effect)) on its template."""
    from karpenter_tpu_torch.apis import NodePool
    from karpenter_tpu_torch.apis.nodepool import NodeClaimTemplate
    from karpenter_tpu_torch.scheduling import Requirement, Taint

    out = []
    for p in config["pools"]:
        reqs = [Requirement(CAPACITY_TYPE_LABEL, "In", [p["captype"]])] if p["captype"] else []
        template = NodeClaimTemplate(taints=[Taint(key, effect, value)
                                             for key, value, effect in p.get("taints", ())])
        out.append(NodePool(p["name"], weight=p["weight"], requirements=reqs, template=template))
    return out


def daemon_overhead(config: dict) -> Dict[str, object]:
    from karpenter_tpu_torch.scheduling import Resources

    return {p["name"]: Resources.from_base_units(p["overhead"])
            for p in config["pools"] if p["overhead"]}


class PodFactory:
    """Pods of the deployment templates; replicas of one template share its
    spec objects, as a ReplicaSet's do."""

    def __init__(self, templates: Sequence[dict]):
        from karpenter_tpu_torch.scheduling import Resources, Toleration

        self.specs = [(Resources.from_base_units(t["requests"]), dict(t["selector"]),
                       [Toleration(*tol) for tol in t["tolerations"]], dict(t["labels"]))
                      for t in templates]

    def pods(self, pods) -> list:
        """Pod objects of (template, name) pods, in their order."""
        from karpenter_tpu_torch.apis import Pod

        out = []
        specs = self.specs
        for t, name in pods:
            requests, selector, tolerations, labels = specs[t]
            out.append(Pod(name, requests=requests, node_selector=selector,
                           tolerations=tolerations, labels=labels))
        return out


def existing_nodes(nodes: Sequence[dict]) -> list:
    from karpenter_tpu_torch.scheduling import Resources
    from karpenter_tpu_torch.solver.oracle import ExistingNode

    return [ExistingNode(n["name"], dict(n["labels"]), Resources.from_base_units(n["alloc"]), [],
                         Resources.from_base_units(n["used"])) for n in nodes]


def solver(device: str, g_max: int, objective: str, cache_dir: str):
    """TorchSolver as the binary builds it: on a card with background
    bucket warm-up, the kernel-library store and the warm-up ladder; on
    the CPU (the benchmark's own tests) with none of them. Returns
    (solver, ladder manager or None)."""
    from karpenter_tpu_torch.solver.service import TorchSolver
    from karpenter_tpu_torch.utils import enable_compilation_cache

    on_card = device.startswith("cuda")
    s = TorchSolver(g_max=g_max, objective=objective, device=device, auto_warm=on_card)
    if not on_card:
        return s, None
    home = enable_compilation_cache(cache_dir)
    # the whole ladder runs in set-up (duty 1.0), not paced beside live ticks
    return s, s.enable_aot(home, duty=1.0)


def warm(s, mgr, items, timeout_s: float = 600.0) -> None:
    """On a card: stage the catalog, warm every class-count bucket and let
    the ladder arm them before anything is timed."""
    if mgr is None:
        return
    s.warm(items)
    if s._warm_thread is not None:
        s._warm_thread.join(timeout_s)
    if mgr is not None and not mgr.drain(timeout_s):
        raise RuntimeError("the warm-up ladder did not finish in set-up")


def latency_gc() -> None:
    """The binary's collector policy (utils.configure_gc_for_latency)."""
    from karpenter_tpu_torch.utils import configure_gc_for_latency

    configure_gc_for_latency()


def scheduler(pools, items, zones, existing=(), overhead=None):
    from karpenter_tpu_torch.solver.oracle import Scheduler

    return Scheduler(nodepools=pools, instance_types={p.name: items for p in pools},
                     existing_nodes=list(existing), zones=set(zones),
                     daemon_overhead=overhead)


def decision(result, zones: Sequence[str]) -> dict:
    """A SchedulingResult in the reference's plain form, each new node's
    NodePool beside it."""
    nodes = []
    for g in result.new_groups:
        zr = g.requirements.get(ZONE_LABEL)
        cr = g.requirements.get(CAPACITY_TYPE_LABEL)
        nodes.append((
            tuple(it.name for it in g.instance_types),
            tuple(p.metadata.name for p in g.pods),
            frozenset(z for z in zones if zr is None or zr.matches(z)),
            frozenset(c for c in CAPTYPES if cr is None or cr.matches(c)),
        ))
    return {"nodes": nodes, "pools": [g.nodepool.name for g in result.new_groups],
            "unschedulable": sorted(result.unschedulable),
            "existing": dict(result.existing_assignments)}


def verdicts(vs) -> List[tuple]:
    """SetVerdicts as the reference's plain tuples."""
    return [(bool(v.can_delete), int(v.leftover), float(v.replace_price),
             float(v.replace_od_price), v.replace_type, v.nodepool) for v in vs]
