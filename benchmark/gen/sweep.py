"""A standing cluster and its consolidation sweeps, as plain data.

A frozen copy of the port's sweep generators (karpenter_tpu_torch/
workload.py `nodes_from_result`, `sweep_sets`, disrupt/engine.py
`enumerate_pairs`), over a cluster that the benchmark's own plain
provisioning tick (reference/ffd.py) builds from a pod batch: each node
it opens is launched as its cheapest type, in the zone and capacity type
of that type's cheapest offering the node admits, and carries the pods
the tick put there beside its NodePool's daemonset reserve.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

from gen.catalog import (
    CAPACITY_TYPE_LABEL, CPU, HOSTNAME_LABEL, NODEPOOL_LABEL, PODS, ZONE_ID_LABEL, ZONE_LABEL,
    allocatable,
)

PAIR_WINDOW = 6


def enumerate_pairs(n: int, window: int = PAIR_WINDOW) -> List[Tuple[int, int]]:
    """Underutilized pairs among the first `window` candidates, (0, 1)
    left out (it is the 2-prefix)."""
    m = min(n, window)
    return [(i, j) for i in range(m) for j in range(i + 1, m) if (i, j) != (0, 1)]


def sweep_sets(n_cand: int, prefix_max: int) -> List[Tuple[int, ...]]:
    """Singletons, price-order prefixes 2..prefix_max, and the pairs."""
    sets = [(i,) for i in range(n_cand)]
    sets += [tuple(range(k)) for k in range(2, min(prefix_max, n_cand) + 1)]
    sets += list(enumerate_pairs(n_cand))
    return sets


def cluster(catalog_entries: Sequence[dict], decision: dict, template_of: dict, templates,
            pools, prefix: str = "node") -> List[dict]:
    """The nodes of a provisioning decision (reference/ffd.py's plain
    form): name, labels, allocatable, the pods each carries, as
    (template, name), and the capacity in use: those pods and the
    daemonset reserve of the node's pool. A node belongs to the first of
    `pools` (the configuration's) that admits its capacity type."""
    by_name = {e["name"]: e for e in catalog_entries}
    nodes = []
    for i, (types, pods, zones, captypes) in enumerate(decision["nodes"]):
        e = by_name[types[0]]
        offers = [o for o in e["offerings"] if o[1] in zones and o[0] in captypes] or e["offerings"]
        captype, zone, zone_id, _ = min(offers, key=lambda o: o[3])
        name = f"{prefix}-{i}"
        labels = dict(e["labels"])
        pool = next(p for p in pools if p["captype"] in ("", captype))
        labels.update({ZONE_LABEL: zone, ZONE_ID_LABEL: zone_id, CAPACITY_TYPE_LABEL: captype,
                       NODEPOOL_LABEL: pool["name"], HOSTNAME_LABEL: name})
        carried = [(template_of[p], p) for p in pods]
        nodes.append({"name": name, "labels": labels, "alloc": allocatable(e), "pods": carried,
                      "used": used(templates, carried, pool["overhead"])})
    return nodes


def used(templates, pods, reserve=None) -> dict:
    """Base units a node's daemonset `reserve` and its (template, name)
    pods request, one pod slot a pod, summed in that order."""
    out: dict = dict(reserve or {})
    for t, _ in pods:
        for k, v in list(templates[t]["requests"].items()) + [(PODS, 1.0)]:
            out[k] = out.get(k, 0.0) + v
    return {k: v for k, v in out.items() if v != 0.0}


def steady(nodes: Sequence[dict], n_cand: int) -> dict:
    """A sweep's world over a steady cluster: the `n_cand` nodes with the
    least requested cpu are the candidates, in that order, each holding
    its pods."""
    order = sorted(range(len(nodes)), key=lambda i: (nodes[i]["used"].get(CPU, 0.0), i))[:n_cand]
    return {"nodes": [{k: n[k] for k in ("name", "labels", "alloc", "used")} for n in nodes],
            "candidates": [nodes[i]["name"] for i in order],
            "pods": [nodes[i]["pods"] for i in order]}
