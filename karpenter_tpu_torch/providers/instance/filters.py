"""Composable instance-type filter chain for launch.

Rebuilds pkg/providers/instance/filter/filter.go:32-388 -- the six-stage
chain Create runs before building fleet overrides:

1. compatible+available: drop types with no offering compatible with the
   claim's requirements and available per the ICE cache
2. reservation-type scoping: when the claim pins a capacity-reservation
   type, keep only matching offerings
3. capacity-block exclusivity: capacity-block reservations cannot mix with
   other capacity types in one launch
4. reserved-preference: if any reserved offering survives, launch reserved
   only (cheapest capacity first)
5. exotic-type avoidance: skip metal/GPU/accelerator types unless the pod
   requirements explicitly demand them
6. spot-flexibility floor: refuse a spot launch with fewer than 5 candidate
   types unless the claim pinned types explicitly (instance.go:58)

Copy of karpenter_tpu/providers/instance/filters.py, imports rewritten to the port's.
"""
from __future__ import annotations

from typing import List, Sequence

from karpenter_tpu_torch.apis import labels as wk
from karpenter_tpu_torch.providers.instancetype.types import InstanceType
from karpenter_tpu_torch.scheduling import Requirements
from karpenter_tpu_torch.scheduling import resources as res

MIN_SPOT_FLEXIBILITY = 5


def compatible_available(items: Sequence[InstanceType], reqs: Requirements) -> List[InstanceType]:
    out = []
    for it in items:
        if not it.requirements.compatible(reqs):
            continue
        offerings = [o for o in it.available_offerings() if reqs.compatible(o.requirements())]
        if offerings:
            out.append(it)
    return out


def reservation_scope(items: Sequence[InstanceType], reqs: Requirements) -> List[InstanceType]:
    req = reqs.get(wk.LABEL_CAPACITY_RESERVATION_ID)
    if req is None or req.complement:
        return list(items)
    return [
        it
        for it in items
        if any(o.reservation_id and req.matches(o.reservation_id) for o in it.available_offerings())
    ]


def reserved_preference(items: Sequence[InstanceType], reqs: Requirements) -> List[InstanceType]:
    """If reserved capacity is reachable, use only it (it is near-free)."""
    captype = reqs.get(wk.CAPACITY_TYPE_LABEL)
    if captype is not None and not captype.matches(wk.CAPACITY_TYPE_RESERVED):
        return list(items)
    reserved = [
        it
        for it in items
        if any(o.capacity_type == wk.CAPACITY_TYPE_RESERVED for o in it.available_offerings())
    ]
    return reserved if reserved else list(items)


def exotic_avoidance(items: Sequence[InstanceType], reqs: Requirements, requested: res.Resources = None) -> List[InstanceType]:
    """Drop metal / GPU / accelerator types unless explicitly required
    (reference: ExoticInstanceTypeFilter)."""
    wants_gpu = requested is not None and (requested.get(res.GPU) > 0 or requested.get(res.ACCELERATOR) > 0)
    explicit_keys = reqs.keys()
    wants_exotic = (
        wants_gpu
        or wk.LABEL_INSTANCE_GPU_COUNT in explicit_keys
        or wk.LABEL_INSTANCE_GPU_NAME in explicit_keys
        or wk.LABEL_INSTANCE_ACCELERATOR_COUNT in explicit_keys
        or wk.LABEL_INSTANCE_ACCELERATOR_NAME in explicit_keys
        or (reqs.get(wk.LABEL_INSTANCE_SIZE) is not None and reqs.get(wk.LABEL_INSTANCE_SIZE).matches("metal"))
    )
    if wants_exotic:
        return list(items)
    filtered = [
        it
        for it in items
        if not (
            (it.info and it.info.bare_metal)
            or it.capacity.get(res.GPU) > 0
            or it.capacity.get(res.ACCELERATOR) > 0
        )
    ]
    return filtered if filtered else list(items)


def spot_viable(items: Sequence[InstanceType], reqs: Requirements) -> bool:
    """Stage 6 is a *capacity-type decision* input, not a type filter: a spot
    launch is healthy only with >= 5 candidate types (diversification keeps
    reclaim rates tolerable) unless the claim pinned types explicitly. The
    instance provider consults this when choosing spot vs on-demand."""
    pinned = reqs.get(wk.INSTANCE_TYPE_LABEL) is not None
    spot_capable = [
        it
        for it in items
        if any(o.capacity_type == wk.CAPACITY_TYPE_SPOT for o in it.available_offerings())
    ]
    return pinned or len(spot_capable) >= MIN_SPOT_FLEXIBILITY


def apply_chain(items: Sequence[InstanceType], reqs: Requirements, requested=None) -> List[InstanceType]:
    items = compatible_available(items, reqs)
    items = reservation_scope(items, reqs)
    items = reserved_preference(items, reqs)
    items = exotic_avoidance(items, reqs, requested)
    return items
