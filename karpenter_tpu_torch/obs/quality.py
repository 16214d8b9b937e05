"""Solution-quality document: waste attribution and the optimality gap.

Copy of karpenter_tpu/obs/quality.py. ``solver/bound.py`` computes the
fractional lower bound on hourly fleet price on the device;
``TorchSolver.solve_finish`` fetches it after decode and this module
turns the decode outputs into the quality document: realized price,
stranded CPU/memory fractions, the fragmentation index, price by pool
and capacity type, and the optimality gap = realized / bound. The
document is key for key the JAX package's.

Left out until the port has a metrics registry: the JAX module's
Prometheus gauges (``karpenter_quality_*``). Observe-only: nothing
downstream of a scheduling decision reads any of it.
"""
from __future__ import annotations

import json
import threading
from typing import Any, Dict, List, Optional

from karpenter_tpu_torch.scheduling import resources as res

# last computed quality document, process-wide: solve_quality records
# here, readers (the JAX package's /debug/quality and flight recorder)
# take it without plumbing
_LOCK = threading.Lock()
_LAST: Dict[str, Any] = {}


def record(q: Dict[str, Any]) -> None:
    global _LAST
    with _LOCK:
        _LAST = q


def snapshot() -> Dict[str, Any]:
    with _LOCK:
        return dict(_LAST)


def reset() -> None:
    record({})


def dump_json(indent: Optional[int] = None) -> str:
    doc = snapshot()
    return json.dumps(doc if doc else {"configured": False}, indent=indent,
                      default=repr)


def solve_quality(
    result, bound_per_h: Optional[float], binding_resource: Optional[int],
) -> Dict[str, Any]:
    """One solve's quality document from the DECODE outputs: realized
    price (sum of each new group's cheapest surviving type -- exactly
    what the launch pays), waste attribution against those same chosen
    types, and the optimality gap against the device bound. Records the
    doc (the solver also keeps it on ``last_quality``). Pure dict/object
    reads -- no device values anywhere near this."""
    realized = 0.0
    by_pool: Dict[str, float] = {}
    by_captype: Dict[str, float] = {}
    alloc_tot = {res.CPU: 0.0, res.MEMORY: 0.0}
    used_tot = {res.CPU: 0.0, res.MEMORY: 0.0}
    free_cpus: List[float] = []
    for g in result.new_groups:
        chosen = g.instance_types[0]
        price = chosen.cheapest_price()
        realized += price
        pool_name = getattr(g.nodepool, "name", "?")
        by_pool[pool_name] = by_pool.get(pool_name, 0.0) + price
        offerings = chosen.available_offerings()
        ct = min(offerings, key=lambda o: o.price).capacity_type if offerings else "?"
        by_captype[ct] = by_captype.get(ct, 0.0) + price
        alloc = chosen.allocatable()
        for axis in (res.CPU, res.MEMORY):
            a = alloc.get(axis)
            u = min(g.requested.get(axis), a)
            alloc_tot[axis] += a
            used_tot[axis] += u
        free_cpus.append(max(alloc.get(res.CPU) - g.requested.get(res.CPU), 0.0))
    q: Dict[str, Any] = {
        "groups": len(result.new_groups),
        "realized_per_h": round(realized, 6),
        "price_by_pool": {k: round(v, 6) for k, v in sorted(by_pool.items())},
        "price_by_capacity_type": {
            k: round(v, 6) for k, v in sorted(by_captype.items())
        },
        "stranded_cpu_fraction": stranded_fraction(
            alloc_tot[res.CPU], used_tot[res.CPU]),
        "stranded_memory_fraction": stranded_fraction(
            alloc_tot[res.MEMORY], used_tot[res.MEMORY]),
        "fragmentation_index": fragmentation_index(free_cpus),
    }
    if bound_per_h is not None and bound_per_h > 0.0 and realized > 0.0:
        q["bound_per_h"] = round(bound_per_h, 6)
        q["optimality_gap"] = round(realized / bound_per_h, 6)
        if binding_resource is not None:
            q["binding_resource"] = res.RESOURCE_AXES[binding_resource]
    record(q)
    return q


def stranded_fraction(alloc_total: float, used_total: float) -> float:
    """Fraction of bought allocatable capacity left unusable by the
    packing. 0 when nothing was bought (an empty fleet strands nothing)."""
    if alloc_total <= 0.0:
        return 0.0
    return round(max(alloc_total - used_total, 0.0) / alloc_total, 6)


def fragmentation_index(free_per_node: List[float]) -> float:
    """1 - (largest single-node free CPU / total free CPU), in [0, 1].
    All free capacity concentrated on one node scores 0 (a big hole a
    big pod can use); the same total scattered evenly over N nodes
    scores 1 - 1/N (residue too thin to host anything)."""
    total = sum(free_per_node)
    if total <= 0.0 or len(free_per_node) <= 1:
        return 0.0
    return round(1.0 - max(free_per_node) / total, 6)


# -- sim-replay reference quality (host, any backend) -------------------------
#
# Wire-mode rigs stage nothing locally, so the device bound only runs
# in-process; replays instead compute the SAME fractional bound on host
# from the catalog the operator's provider serves -- coarser (no
# per-class feasibility masks: the min ranges over the whole catalog,
# which only loosens the bound, never unsounds it) but backend-uniform,
# so host/wire/pipelined KPIs are comparable. Per-type price rates are
# memoized by catalog-list identity (providers rebuild the list when
# pricing changes; a stale tick between price event and refresh can dip
# a tick's gap below 1, which is why the corpus gate pins UPPER bounds).

_rates_cache: Dict[int, tuple] = {}


def _fleet_rates(instance_types) -> Optional[list]:
    """[R] $/h per base unit of each resource axis: min over catalog
    types of cheapest_price / capacity -- the whole-fleet analogue of
    bound.py's per-class rate."""
    key = id(instance_types)
    hit = _rates_cache.get(key)
    if hit is not None and hit[0] is instance_types:
        return hit[1]
    R = res.NUM_RESOURCE_AXES
    rates = [float("inf")] * R
    for it in instance_types:
        price = it.cheapest_price()
        if price == float("inf"):
            continue
        cap = it.capacity.to_vector()
        for r in range(R):
            if cap[r] > 0.0:
                rate = price / cap[r]
                if rate < rates[r]:
                    rates[r] = rate
    if all(r == float("inf") for r in rates):
        return None
    _rates_cache[key] = (instance_types, rates)
    while len(_rates_cache) > 64:
        _rates_cache.pop(next(iter(_rates_cache)))
    return rates


def fleet_bound(bound_pods, instance_types) -> float:
    """Fractional lower bound on the hourly price of any fleet hosting
    ``bound_pods``: max over resource axes of (total demand * cheapest
    per-unit rate). Sound because a node of type t hosting usage u_r
    has price >= cheapest_price(t) >= rate_r * cap_r(t) >= rate_r * u_r,
    and usage sums to at least the bound pods' requests."""
    rates = _fleet_rates(instance_types)
    if rates is None:
        return 0.0
    R = res.NUM_RESOURCE_AXES
    demand = [0.0] * R
    pods_axis = res.RESOURCE_AXES.index(res.PODS) if res.PODS in res.RESOURCE_AXES else None
    for p in bound_pods:
        vec = p.requests.to_vector()
        for r in range(R):
            demand[r] += vec[r]
        if pods_axis is not None:
            demand[pods_axis] += 1.0  # every pod occupies one pod slot
    best = 0.0
    for r in range(R):
        if rates[r] != float("inf") and demand[r] > 0.0:
            best = max(best, demand[r] * rates[r])
    return best


def fleet_waste(nodes, usage_map) -> Dict[str, float]:
    """Live-fleet waste attribution for sim replays: stranded CPU/mem
    fractions (allocatable bought vs used) and the fragmentation index,
    from the node set + the usage map the invariant check already
    built."""
    alloc_cpu = used_cpu = alloc_mem = used_mem = 0.0
    free_cpus: List[float] = []
    for n in nodes:
        alloc = n.allocatable
        used = usage_map.get(n.metadata.name)
        a_cpu, a_mem = alloc.get(res.CPU), alloc.get(res.MEMORY)
        u_cpu = min(used.get(res.CPU), a_cpu) if used is not None else 0.0
        u_mem = min(used.get(res.MEMORY), a_mem) if used is not None else 0.0
        alloc_cpu += a_cpu
        used_cpu += u_cpu
        alloc_mem += a_mem
        used_mem += u_mem
        free_cpus.append(max(a_cpu - u_cpu, 0.0))
    return {
        "stranded_cpu_fraction": stranded_fraction(alloc_cpu, used_cpu),
        "stranded_memory_fraction": stranded_fraction(alloc_mem, used_mem),
        "fragmentation_index": fragmentation_index(free_cpus),
    }


def fleet_price_decomposition(nodes, node_price) -> Dict[str, Dict[str, float]]:
    """Hourly fleet price decomposed by nodepool and capacity type from
    live node labels (sim replays; the per-solve decomposition in
    solve_quality reads decode outputs instead)."""
    from karpenter_tpu_torch.apis import labels as wk

    by_pool: Dict[str, float] = {}
    by_captype: Dict[str, float] = {}
    for n in nodes:
        p = node_price(n)
        pool = n.metadata.labels.get(wk.NODEPOOL_LABEL, "?")
        ct = n.metadata.labels.get(wk.CAPACITY_TYPE_LABEL, "?")
        by_pool[pool] = by_pool.get(pool, 0.0) + p
        by_captype[ct] = by_captype.get(ct, 0.0) + p
    return {
        "price_by_pool": {k: round(v, 6) for k, v in sorted(by_pool.items())},
        "price_by_capacity_type": {
            k: round(v, 6) for k, v in sorted(by_captype.items())
        },
    }
