"""Cross-pool group carry: overlapping-compat multi-pool batches on device.

Copy of karpenter_tpu/solver/multipool.py.

VERDICT round 3 weak #4 / item 6: a class compatible with SEVERAL pools can
join another class's open group across the pool boundary in the oracle's
first-fit order (in-flight capacity beats weight preference, as in the
reference core) -- pool-sequential device solves cannot express that, so
these batches used to take the sequential oracle. The cliff closes with a
MERGED-CATALOG formulation that rides the existing FFD kernel:

- one column per (pool, type): the pool's requirements (incl. its
  `karpenter.sh/nodepool` pin, zone/captype restrictions, custom labels)
  are baked into the column's requirement set, so the packed-bitset compat
  the kernel already computes covers pool admission for joins AND opens;
- OPENING is restricted to the class's FIRST feasible ADMITTED pool in
  weight order (ffd.SolveInputs.open_allowed), where admission is the
  oracle's _open_group gate (pool reqs compatible under
  well-known-undefined semantics) computed host-side. JOINS stay free
  wherever the natural requirement compat allows -- the oracle's
  _try_group gate is group-requirements compatibility with PERMISSIVE
  undefined keys, so a bare pod may join a custom-labeled pool's open
  group it could never have opened;
- a group's surviving columns therefore stay within ONE pool (the open
  mask seeds gmask single-pool; joins only narrow), and decode attributes
  the group to that pool, emitting the ORIGINAL instance types.

Per-pool daemonset overhead bakes into each column's allocatable
(build_merged below), and per-pool TAINTS gate joins through
ffd.SolveInputs.join_allowed (a [C, K] mask ANDed into compat: the
oracle's _try_group toleration gate, sound because groups are
single-pool by construction) -- both stay on device.

Scope carve-outs (service._try_solve_merged routes to the oracle): pools
with limits (per-pool usage accounting is not in the scan), minValues
pools (the class-level partition handles those separately), and spread
classes (already oracle-routed for multi-pool by supports()).
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from karpenter_tpu_torch.apis import NodePool, labels as wk
from karpenter_tpu_torch.providers.instancetype.types import InstanceType
from karpenter_tpu_torch.scheduling import tolerates_all


def build_merged(
    pools: Sequence[NodePool], catalogs: Dict[str, list], overheads: Sequence = (),
) -> Tuple[List[InstanceType], List[InstanceType], np.ndarray]:
    """(merged_items, original_items, col_pools). Pools must arrive in
    weight-descending order (the oracle's iteration order); column order
    follows it, so per-pool column ranges are contiguous.

    `overheads` (one Resources per pool, same order) is each pool's
    daemonset reserve: it ADDS to the column's overhead, so the column's
    allocatable -- what the kernel's capacity tensor is built from --
    already reflects the pool the column belongs to. This is how the
    merged solve supports UNEQUAL per-pool overhead with one [R] global
    node_overhead vector (left at zero): the oracle's per-group
    `requested + ovh(group.nodepool) <= allocatable` is algebraically the
    same check."""
    if overheads and len(overheads) != len(pools):
        # a partial list would silently zero the reserve for trailing
        # pools and overstate their columns' allocatable
        raise ValueError(
            f"build_merged: {len(overheads)} overheads for {len(pools)} pools"
        )
    merged: List[InstanceType] = []
    originals: List[InstanceType] = []
    col_pools: List[int] = []
    for pi, pool in enumerate(pools):
        preqs = pool.requirements()
        zreq = preqs.get(wk.ZONE_LABEL)
        creq = preqs.get(wk.CAPACITY_TYPE_LABEL)
        ovh = overheads[pi] if overheads else None
        for it in catalogs.get(pool.name, []):
            if not it.requirements.compatible(preqs):
                continue  # the pool's requirements exclude this type
            offerings = [
                o
                for o in it.offerings
                if (zreq is None or zreq.matches(o.zone))
                and (creq is None or creq.matches(o.capacity_type))
            ]
            if not any(o.available for o in offerings):
                continue
            merged.append(
                InstanceType(
                    name=f"{pool.name}/{it.name}",
                    requirements=it.requirements.copy().add(*preqs),
                    capacity=it.capacity,
                    overhead=it.overhead + ovh if ovh is not None else it.overhead,
                    offerings=offerings,
                    info=it.info,
                )
            )
            originals.append(it)
            col_pools.append(pi)
    return merged, originals, np.array(col_pools, dtype=np.int32)


def first_compat_pool(pc, pools: Sequence[NodePool]) -> int:
    """Index of the first (highest-weight) pool whose requirements are
    compatible with the class, or -1. TOLERATION IS NOT CONSIDERED: this
    mirrors the oracle's `_zone_choice` pool selection exactly (it derives
    spread domains from the first requirements-compatible pool's catalog,
    oracle.py), which is where this helper is used -- spread-domain
    restriction on the merged path must diverge from the oracle in
    neither direction, including for pods that do not tolerate their
    first-compatible pool."""
    from karpenter_tpu_torch.solver.oracle import _ALLOW_UNDEFINED

    for pi, pool in enumerate(pools):
        if pool.requirements().compatible(
            pc.requirements, allow_undefined=_ALLOW_UNDEFINED
        ):
            return pi
    return -1


def admitted_pools(pc, pools: Sequence[NodePool]) -> List[int]:
    """Pool indices (weight order) whose OPEN-admission gate the class
    passes: the oracle's _open_group checks pool-reqs compatibility under
    well-known-undefined semantics plus taint toleration. Joining is NOT
    gated here (the oracle's _try_group is permissive on undefined keys,
    which the device compat matches natively)."""
    from karpenter_tpu_torch.solver.oracle import _ALLOW_UNDEFINED

    rep = pc.pods[0]
    out = []
    for pi, pool in enumerate(pools):
        if not pool.requirements().compatible(
            pc.requirements, allow_undefined=_ALLOW_UNDEFINED
        ):
            continue
        if not tolerates_all(rep.tolerations, pool.template.taints):
            continue
        out.append(pi)
    return out


def join_allowed_mask(
    classes, pools: Sequence[NodePool], col_pools: np.ndarray,
    c_pad: int, k_pad: int,
) -> np.ndarray:
    """[C_pad, K_pad] bool: columns class c may use AT ALL (ANDed into the
    kernel's compat, so it gates joins and opens alike): columns of pools
    whose taints the class representative tolerates. Mirrors the oracle's
    _try_group `tolerates_all(pod.tolerations, group.taints)` -- a merged
    group's surviving columns stay within one pool, so a column gate IS
    the group gate. Padding rows/columns stay True (compat gates them)."""
    mask = np.ones((c_pad, k_pad), dtype=bool)
    k_real = col_pools.shape[0]
    for pi, pool in enumerate(pools):
        if not pool.template.taints:
            continue
        cols = np.zeros((k_pad,), dtype=bool)
        cols[:k_real] = col_pools == pi
        for c, pc in enumerate(classes):
            if not tolerates_all(pc.pods[0].tolerations, pool.template.taints):
                mask[c, cols] = False
    return mask


def open_allowed_mask(
    classes, admitted_all: List[List[int]], col_pools: np.ndarray,
    compat: np.ndarray, fits_one: np.ndarray, c_pad: int, k_pad: int,
) -> Tuple[np.ndarray, List[int]]:
    """([C_pad, K_pad] bool, per-class opening pool index or -1): the
    columns each class may OPEN on -- all columns of its first
    (highest-weight) admitted pool with any feasible column, the oracle's
    first-pool-with-candidates preference. Classes with no feasible pool
    open nowhere (their pods come back unplaced, matching the oracle's
    unschedulable verdict). The chosen pool index is returned so envelope
    unification keys to the SAME pool the kernel opens in (one
    feasibility definition, not two copies)."""
    mask = np.zeros((c_pad, k_pad), dtype=bool)
    k_real = col_pools.shape[0]
    feasible = compat[:, :k_real] & fits_one[:, :k_real]
    open_pool = []
    for c, admitted in enumerate(admitted_all):
        chosen = -1
        for pi in admitted:
            cols = col_pools == pi
            if feasible[c, cols].any():
                mask[c, :k_real] = cols
                chosen = pi
                break
        open_pool.append(chosen)
    return mask, open_pool
