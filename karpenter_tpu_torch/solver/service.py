"""TorchSolver: the single-NodePool provisioning solve on the GPU.

Counterpart of the in-process, single-pool path of TPUSolver
(karpenter_tpu/solver/service.py): `solve` = `solve_finish(solve_begin(...))`.

    host    group_pods, encode_classes     pods -> classes -> dense arrays
    device  _pack_existing                 kernel B (S=1) packs pending pods
                                           onto existing nodes
    device  ffd.ffd_solve_fused            prologue, kernel A, fused buffer
    host    one fetch, expand_fused, _decode -> NewNodeGroups

The catalog is staged on the device once per catalog list. Each tick
fetches one fused buffer; the dense refetch runs only when the sparse
take overflows its budget.

Not here yet (the routing slice and later): `schedule()` routing with the
oracle `Scheduler`, zone topology spread, the oracle suffix for
(anti-)affinity and preferences, several pools, the wire sidecar, the
mesh, the convex tier, the quality bound and AOT. Pods that need those
raise ValueError, as TPUSolver.solve does for what it cannot place.
"""
from __future__ import annotations

import threading
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from karpenter_tpu_torch.apis import NodePool, Pod, labels as wk
from karpenter_tpu_torch.scheduling import Operator, Requirement, Requirements, Resources
from karpenter_tpu_torch.scheduling import resources as res
from karpenter_tpu_torch.solver import encode, ffd
from karpenter_tpu_torch.solver.disrupt import engine as disrupt_engine
from karpenter_tpu_torch.solver.disrupt import kernel as disrupt_kernel
from karpenter_tpu_torch.solver.encode import CatalogTensors
from karpenter_tpu_torch.solver.oracle import ExistingNode, NewNodeGroup, SchedulingResult
from karpenter_tpu_torch.utils import gc_paused

_bucket = encode.bucket
_C_PAD_MIN = 16     # smallest class bucket: few shapes, few padded rows


def resolve_device(device=None) -> torch.device:
    """`None` means the card. Without CUDA that is an error, not a quiet
    move to the CPU: only an explicit device="cpu" runs there."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "TorchSolver runs on a CUDA device and none is available; "
                "pass device='cpu' to run the plain torch versions on the CPU")
        return torch.device("cuda")
    return torch.device(device)


class _CatalogEntry(NamedTuple):
    """One catalog's immutable staged snapshot (see TorchSolver._catalog)."""

    tensors: CatalogTensors
    staged: ffd.StagedCatalog
    offsets: Tuple[int, ...]
    words: Tuple[int, ...]
    types_by_price: np.ndarray         # object array, cheapest first
    order: np.ndarray                  # argsort indices into the catalog list
    catalog_list: Sequence             # strong ref: keeps the id() key sound
    row_cache: dict                    # encode_classes row memo for this encoding


class _PendingSolve:
    """One solve split at the device dispatch: `solve_begin` runs the host
    stages and enqueues the device work; `solve_finish` fetches, expands
    and decodes. A ticket with nothing in flight carries its result."""

    __slots__ = ("done", "pool", "entry", "class_set", "result", "placed_existing",
                 "nodepool_usage", "buf", "inp", "nnz_max")

    def __init__(self, done: Optional[SchedulingResult] = None):
        self.done = done


def hard_zone_tsc(pod: Pod):
    """The pod's single hard zone-spread constraint it matches itself, or
    None (karpenter_tpu/solver/spread.py)."""
    hard = [t for t in pod.topology_spread if t.hard()]
    if not hard:
        return None
    t = hard[0]
    if len(hard) > 1 or t.topology_key != wk.ZONE_LABEL:
        raise ValueError("route to oracle: multi-constraint or non-zone spread")
    if not all(pod.metadata.labels.get(k) == v for k, v in t.label_selector.items()):
        return None
    return t


def spread_eligible(pods: Sequence[Pod]) -> bool:
    """True when every pod's spread constraints are zone-only and single
    (karpenter_tpu/solver/spread.py)."""
    for p in pods:
        hard = [t for t in p.topology_spread if t.hard()]
        if hard and (len(hard) > 1 or hard[0].topology_key != wk.ZONE_LABEL):
            return False
    return True


class TorchSolver:
    def __init__(self, g_max: int = 1024, objective: str = "price", device=None):
        if objective not in ("price", "fit"):
            raise ValueError(f"objective must be 'price' or 'fit', got {objective!r}")
        self.device = resolve_device(device)
        # g_max sized for the price objective at 50k pods: cost-optimal
        # packing opens ~1.6x the groups max-fit does
        self.g_max = g_max
        self.objective = objective
        # catalog entries keyed by list identity, LRU-capped: one solver
        # serves several nodepools whose catalogs alternate within a tick
        self._catalog_cache: Dict[int, _CatalogEntry] = {}
        self._catalog_cache_cap = 8
        self._lock = threading.Lock()

    # -- catalog staging ----------------------------------------------------
    def _catalog(self, instance_types: Sequence) -> _CatalogEntry:
        """The staged-catalog snapshot for one catalog list, memoized by
        object identity. The entry holds a strong reference to the keyed
        list, which makes the id() key sound; staging uploads the catalog
        to the device once, and per-tick solves move only class tensors."""
        key = id(instance_types)
        with self._lock:
            entry = self._catalog_cache.pop(key, None)
            if entry is None or entry.catalog_list is not instance_types:
                tensors = encode.encode_catalog(instance_types)
                staged, offsets, words = ffd.stage_catalog(tensors, self.device)
                # decode acceleration: type objects pre-sorted by cheapest
                # price so a group's survivors are one boolean fancy-index
                prices = np.array([it.cheapest_price() for it in instance_types])
                order = np.argsort(prices, kind="stable")
                entry = _CatalogEntry(
                    tensors=tensors, staged=staged, offsets=offsets, words=words,
                    types_by_price=np.array(list(instance_types), dtype=object)[order],
                    order=order, catalog_list=instance_types, row_cache={},
                )
            self._catalog_cache[key] = entry   # LRU touch
            while len(self._catalog_cache) > self._catalog_cache_cap:
                self._catalog_cache.pop(next(iter(self._catalog_cache)))
            return entry

    # -- the batch solve ----------------------------------------------------
    def solve(
        self,
        pool: NodePool,
        instance_types: Sequence,
        pods: Sequence[Pod],
        nodepool_usage: Optional[Resources] = None,
        existing_nodes: Sequence[ExistingNode] = (),
    ) -> SchedulingResult:
        """The synchronous solve: dispatch + barrier in one call."""
        return self.solve_finish(self.solve_begin(
            pool, instance_types, pods,
            nodepool_usage=nodepool_usage, existing_nodes=existing_nodes))

    @staticmethod
    def _suffix_classes(classes) -> list:
        """Classes whose pods the device kernels cannot place: (anti-)
        affinity, several node-affinity terms, preferences."""
        return [
            pc for pc in classes
            if pc.has_affinity or pc.multi_node_affinity or pc.has_preferences
        ]

    def solve_begin(
        self,
        pool: NodePool,
        instance_types: Sequence,
        pods: Sequence[Pod],
        nodepool_usage: Optional[Resources] = None,
        existing_nodes: Sequence[ExistingNode] = (),
    ) -> _PendingSolve:
        classes = encode.group_pods(pods, extra_requirements=pool.requirements())
        reps = [pc.pods[0] for pc in classes]
        if not spread_eligible(reps):
            raise ValueError(
                "TorchSolver.solve: pods carry out-of-scope spread constraints "
                "(hostname or multiple hard constraints); routing to the oracle "
                "is not ported yet")
        if any(hard_zone_tsc(p) is not None or encode.soft_zone_tsc(p) is not None for p in reps):
            raise ValueError(
                "TorchSolver.solve: pods carry zone topology spread; the zone "
                "split pass is not ported yet")
        if self._suffix_classes(classes):
            raise ValueError(
                "TorchSolver.solve: pods carry (anti-)affinity or preference "
                "terms the device kernels do not model; routing them to the "
                "oracle suffix is not ported yet")
        result = SchedulingResult()

        # phase 1 (device): pack onto existing capacity first, exactly as
        # the oracle tries existing nodes before opening groups
        placed_existing = np.zeros((len(classes),), dtype=np.int64)
        if existing_nodes:
            placed_existing = self._pack_existing(classes, existing_nodes, result)
        remaining = int(sum(len(pc.pods) for pc in classes) - placed_existing.sum())
        if remaining == 0:
            return _PendingSolve(done=result)
        if not instance_types:
            for c, pc in enumerate(classes):
                for p in pc.pods[int(placed_existing[c]):]:
                    result.unschedulable[p.metadata.name] = "no instance types for nodepool"
            return _PendingSolve(done=result)

        # phase 2 (device): batched FFD over the leftovers
        entry = self._catalog(instance_types)
        class_set = self._encode(pool, entry, classes, placed_existing)
        # the open/join masks travel bit-packed (the form kernel A reads)
        inp = ffd.make_inputs_staged(entry.staged, class_set, packed_masks=True)
        nnz_max = ffd.nnz_budget(class_set.c_pad, self.g_max)
        pending = _PendingSolve()
        pending.pool = pool
        pending.entry = entry
        pending.class_set = class_set
        pending.result = result
        pending.placed_existing = placed_existing
        pending.nodepool_usage = nodepool_usage
        pending.inp = inp
        pending.nnz_max = nnz_max
        pending.buf = ffd.ffd_solve_fused(
            inp, g_max=self.g_max, nnz_max=nnz_max, word_offsets=entry.offsets,
            words=entry.words, objective=self.objective,
        )
        return pending

    def _encode(self, pool: NodePool, entry: _CatalogEntry, classes, placed_existing: np.ndarray):
        """The classes' dense tensors for kernel A: encoded against the
        staged catalog, price envelopes unified, and counts net of the
        pods the pre-pass placed on existing nodes."""
        class_set = encode.encode_classes(
            classes, entry.tensors, pool_taints=list(pool.template.taints),
            c_pad=_bucket(len(classes), _C_PAD_MIN), row_cache=entry.row_cache,
        )
        if self.objective == "price":
            self._unify_envelopes(classes, class_set)
        counts = class_set.count.copy()
        counts[: len(classes)] -= placed_existing.astype(counts.dtype)
        class_set.count = counts
        return class_set

    def solve_finish(self, pending: _PendingSolve) -> SchedulingResult:
        """The barrier: ONE fetch of the fused buffer, expand, decode; a
        sparse-budget overflow refetches the dense decision."""
        if pending.done is not None:
            return pending.done
        entry, class_set = pending.entry, pending.class_set
        dense = ffd.expand_fused(
            ffd.fetch_fused(pending.buf), class_set.c_pad, self.g_max,
            entry.tensors.k_pad, encode.Z_PAD, encode.CT, pending.nnz_max,
        )
        if dense is None:
            dense = ffd.solve_dense_tuple(
                pending.inp, g_max=self.g_max, word_offsets=entry.offsets,
                words=entry.words, objective=self.objective,
            )
        return self._decode(
            pending.pool, entry, class_set, dense, pending.nodepool_usage,
            result=pending.result, class_offset=pending.placed_existing,
        )

    @staticmethod
    def _unify_envelopes(classes, class_set) -> None:
        """The oracle's price envelope is keyed per (pool, merged
        requirement class): classes whose requirements COINCIDE share ONE
        remaining-count envelope. Single pool: class requirements already
        carry the pool's, so coincidence is equality of class keys. The
        first member of a key encodes env_count = -(1 + pods of LATER
        members) (kernel semantics: leftover + (-env - 1)); later members
        get a static pin equal to the first member's envelope total
        (TPUSolver._unify_envelopes, single-pool branch)."""
        n = len(classes)
        keys = [encode._class_key(pc.pods[0], pc.requirements) for pc in classes]
        first_member: Dict[tuple, int] = {}
        for c in range(n):
            if class_set.env_count[c] != -1:
                continue
            first = first_member.get(keys[c])
            if first is None:
                first_member[keys[c]] = c
                tail_after = sum(
                    len(classes[j].pods) for j in range(c + 1, n) if keys[j] == keys[c])
                if tail_after:
                    class_set.env_count[c] = -(1 + tail_after)
            else:
                class_set.env_count[c] = sum(
                    len(classes[j].pods) for j in range(first, n) if keys[j] == keys[c])

    def _repack_operands(self, classes, existing_nodes) -> Tuple[torch.Tensor, ...]:
        """Kernel B's operands for packing `classes` onto `existing_nodes`:
        one candidate set, nothing excluded, C and N padded to buckets."""
        C = _bucket(len(classes), _C_PAD_MIN)
        N = _bucket(len(existing_nodes), 16)
        req = np.zeros((C, encode.R), dtype=np.float32)
        member = np.zeros((1, C), dtype=np.int32)
        for i, pc in enumerate(classes):
            req[i] = pc.requests
            member[0, i] = len(pc.pods)
        feas = np.zeros((C, N), dtype=bool)
        feas[: len(classes), : len(existing_nodes)] = disrupt_engine._node_feasibility(
            classes, existing_nodes, class_zone_pins=True)
        headroom = np.zeros((N, encode.R), dtype=np.float32)
        for ni, node in enumerate(existing_nodes):
            headroom[ni] = encode.scale_vector(node.remaining().to_vector())
        return disrupt_kernel.repack_from_numpy(
            headroom, feas, req, member, np.zeros((1, N), dtype=bool), self.device)

    def _pack_existing(self, classes, existing_nodes, result: SchedulingResult) -> np.ndarray:
        """First-fit pods onto live/in-flight nodes with kernel B; fills
        result.existing_assignments and returns per-class placed counts."""
        _, takes = disrupt_kernel.disrupt_repack(*self._repack_operands(classes, existing_nodes))
        takes = takes[0].cpu().numpy()                     # [C, N]
        placed = np.zeros((len(classes),), dtype=np.int64)
        for c, pc in enumerate(classes):
            cursor = 0
            for ni, node in enumerate(existing_nodes):
                n = int(takes[c, ni])
                for p in pc.pods[cursor: cursor + n]:
                    result.existing_assignments[p.metadata.name] = node.name
                cursor += n
            placed[c] = cursor
        return placed

    def _decode(
        self,
        pool: NodePool,
        entry: _CatalogEntry,
        class_set,
        dense: Tuple,
        nodepool_usage: Optional[Resources],
        result: SchedulingResult,
        class_offset: np.ndarray,
    ) -> SchedulingResult:
        """Placements -> NewNodeGroups (TPUSolver._decode, single pool)."""
        catalog = entry.tensors
        take, unplaced, n_open, gmask, gzone, gcap = dense
        take = np.asarray(take)                        # [C, G]
        unplaced = np.asarray(unplaced)                # [C]
        n_open = int(n_open)
        gmask = np.asarray(gmask)                      # [G, K]
        # cumulative placements per class: offset math in O(1) per (c, g)
        take_cum = np.concatenate(
            [np.zeros((take.shape[0], 1), dtype=take.dtype), np.cumsum(take, axis=1)], axis=1)
        types_by_price, order = entry.types_by_price, entry.order
        captype_names = [wk.CAPACITY_TYPE_RESERVED, wk.CAPACITY_TYPE_SPOT, wk.CAPACITY_TYPE_ON_DEMAND]

        usage = nodepool_usage if nodepool_usage is not None else Resources()
        limited = pool.limits is not None
        take_t = np.ascontiguousarray(take[:, :n_open].T) if n_open else take.T
        gmask_real = gmask[:, : catalog.k_real]
        zone_names = catalog.zones
        n_zones = len(zone_names)
        # per-group requested totals in ONE matmul over the EXACT float64
        # base-unit class vectors, so NewNodeGroup.requested stays bit-equal
        # to Resources arithmetic
        if n_open:
            class_base = class_set.base_req[: take_t.shape[1]].astype(np.float64)
            group_req_vecs = take_t.astype(np.float64) @ class_base
        else:
            group_req_vecs = np.zeros((0, encode.R))
        pool_base_reqs = pool.requirements()
        # consecutive groups hosting the same class mix carry identical
        # survivor masks and merged requirements: both memoized on bytes
        survivors_memo: Dict[bytes, List] = {}
        reqs_memo: Dict[Tuple, Requirements] = {}
        taints = list(pool.template.taints)

        # ALL (group, class) placement pairs in one nonzero + two
        # searchsorted calls (gg is sorted)
        gg, cc = np.nonzero(take_t > 0)
        g_starts = np.searchsorted(gg, np.arange(n_open))
        g_ends = np.searchsorted(gg, np.arange(1, n_open + 1))
        pair_take = take_t[gg, cc]
        pair_off = class_offset[cc] + take_cum[cc, gg]

        with gc_paused():
            for g in range(n_open):
                lo, hi = g_starts[g], g_ends[g]
                classes_on_g = cc[lo:hi]
                if classes_on_g.size == 0:
                    continue
                group_pods: List[Pod] = []
                for j in range(lo, hi):
                    pc = class_set.classes[cc[j]]
                    # pods before the offset went to existing nodes or to
                    # earlier groups of this class
                    off = int(pair_off[j])
                    group_pods.extend(pc.pods[off: off + int(pair_take[j])])
                requested = Resources.from_vector(group_req_vecs[g].tolist())
                mask_key = gmask_real[g].tobytes()
                group_types = survivors_memo.get(mask_key)
                if group_types is None:
                    group_types = survivors_memo[mask_key] = (
                        types_by_price[gmask_real[g][order]].tolist())
                if not group_types:
                    for p in group_pods:
                        result.unschedulable[p.metadata.name] = "no surviving instance type"
                    continue
                req_key = (classes_on_g.tobytes(), gzone[g].tobytes(), gcap[g].tobytes())
                reqs = reqs_memo.get(req_key)
                if reqs is None:
                    reqs = pool_base_reqs.copy()
                    for c in classes_on_g:
                        reqs.add(*class_set.classes[c].requirements)
                    zones = [zone_names[z] for z in np.nonzero(gzone[g][:n_zones])[0]]
                    captypes = [captype_names[i] for i in np.nonzero(gcap[g])[0]]
                    # a full mask is no constraint
                    if zones and len(zones) < n_zones:
                        reqs.add(Requirement(wk.ZONE_LABEL, Operator.IN, zones))
                    if captypes and len(captypes) < len(captype_names):
                        reqs.add(Requirement(wk.CAPACITY_TYPE_LABEL, Operator.IN, captypes))
                    reqs_memo[req_key] = reqs
                # nodepool limits (host-side guard, mirroring the oracle)
                if limited:
                    smallest = min(group_types, key=lambda it: it.capacity.get(res.CPU))
                    if not (usage + smallest.capacity).within(pool.limits):
                        for p in group_pods:
                            result.unschedulable[p.metadata.name] = f"nodepool {pool.name} limits exceeded"
                        continue
                    usage = usage + smallest.capacity
                result.new_groups.append(NewNodeGroup(
                    nodepool=pool, requirements=reqs, instance_types=group_types,
                    taints=taints, pods=group_pods, requested=requested,
                ))
            # unplaced pass: only the classes with leftovers
            take_sums = take[: class_set.c_real].sum(axis=1)
            for c in np.nonzero(unplaced[: class_set.c_real] > 0)[0]:
                n_un = int(unplaced[c])
                pc = class_set.classes[c]
                placed = int(class_offset[c]) + int(take_sums[c])
                for p in pc.pods[placed: placed + n_un]:
                    result.unschedulable[p.metadata.name] = "no instance type fits pod requirements"
        return result
