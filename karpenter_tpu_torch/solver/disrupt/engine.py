"""DisruptEngine: batched candidate-set consolidation in one dispatch.

Copy of karpenter_tpu/solver/disrupt/engine.py without the mesh-sharded
repack. Host side of the consolidation solve: encode the candidate sets
once ([S, C] membership, [S, N] exclusions, [C, N] feasibility, [N, R]
headroom), run the repack (kernel B, one block per candidate set) and the
per-pool replacement search (solver/disrupt/kernel.py), and assemble
per-set verdicts. Two routes, chosen as the JAX engine chooses them:

- wire: the engine's solver has a sidecar client, its breaker is closed
  and the sidecar advertises ``solve_disrupt`` -- the repack ships once
  (the leftover stays staged under a disrupt epoch), each pool's
  replacement pass ships only the class-side masks, and the catalog
  tensors never ship (the op names the seqnum the provisioning path
  staged). A wire failure counts toward the breaker and the sweep re-runs
  locally (``karpenter_disruption_device_fallbacks_total{reason=
  "rpc-down"}``); an open breaker or a sidecar without the op go local
  at once (``breaker-open``, ``feature-missing``);
- local: kernel B and the replacement search on the engine's device.

Both count ``karpenter_disruption_device_dispatches_total{path}`` and the
sweep's wall in ``karpenter_disruption_device_sweep_seconds``. As in the
JAX engine, the local route's kernel B call is not counted in
``karpenter_solver_kernel_dispatches_total``: that family is the solver's
own, and ``{path="local"}`` counts the engine's one kernel B run per
evaluate.

Scope: candidate sets whose pods carry stateful constraints (hard
topology spread, affinity terms, multi-term node affinity) are routed to
the Python oracle by the disruption controller; for everything else the
evaluator is differentially equivalent to oracle.Scheduler. Verdicts are
*decisions* for deletion (equivalence is exact) and a *pre-filter plus
price* for replacement: the controller re-derives the replacement group
through the oracle for the one candidate set it acts on.
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from karpenter_tpu_torch import metrics
from karpenter_tpu_torch.apis import NodePool, Pod, labels as wk
from karpenter_tpu_torch.scheduling import Resources, tolerates_all
from karpenter_tpu_torch.solver import encode
from karpenter_tpu_torch.solver.disrupt import kernel
from karpenter_tpu_torch.solver.encode import CatalogTensors
from karpenter_tpu_torch.solver.oracle import ExistingNode

_bucket = encode.bucket

# pair-enumeration window: underutilized pairs are drawn from the first
# WINDOW candidates of the disruption-cost order (bounded so the set axis
# stays O(N + WINDOW^2), not O(N^2))
PAIR_WINDOW = 6


@dataclass
class SetVerdict:
    """Device verdict for one candidate set."""

    can_delete: bool
    leftover: int                      # pods that did not fit existing nodes
    replace_price: float               # cheapest single-new-node price (inf none)
    replace_od_price: float            # cheapest on-demand-only price (inf none)
    replace_type: Optional[str]        # instance type name (None when inf)
    nodepool: Optional[str]            # pool the replacement came from

    def action(self, budget: float, od_only: bool = False) -> str:
        """The verdict as a decision against the candidate set's
        aggregate price: ``delete`` (pods fit the survivors),
        ``replace-cheaper`` (one new node absorbs the leftovers strictly
        under budget), or ``blocked``."""
        if self.can_delete:
            return "delete"
        price = self.replace_od_price if od_only else self.replace_price
        if math.isfinite(price) and price < budget:
            return "replace-cheaper"
        return "blocked"

    def savings(self, budget: float, od_only: bool = False) -> float:
        """Hourly savings of acting on this verdict (0 when blocked)."""
        if self.can_delete:
            return budget
        price = self.replace_od_price if od_only else self.replace_price
        if math.isfinite(price) and price < budget:
            return budget - price
        return 0.0


def enumerate_pairs(n: int, window: int = PAIR_WINDOW) -> List[Tuple[int, int]]:
    """Deterministic underutilized-pair enumeration over the first
    ``min(n, window)`` candidates of the disruption-cost order:
    lexicographic (i, j), i < j, excluding (0, 1) -- that set is already
    the k=2 prefix. Bounded so the batch's set axis stays small."""
    m = min(n, window)
    return [
        (i, j) for i in range(m) for j in range(i + 1, m) if (i, j) != (0, 1)
    ]


def device_eligible(pods: Sequence[Pod]) -> bool:
    """True when every pod is free of the stateful constraints the batch
    evaluator does not model (routing mirror of solver/service.py)."""
    for p in pods:
        if p.affinity_terms or p.preferred_node_affinity_terms or p.preferred_affinity_terms:
            return False
        if any(t.hard() for t in p.topology_spread):
            return False
        if len(p.scheduling_requirements()) != 1:
            return False
    return True


def _node_feasibility(
    classes: Sequence[encode.PodClass], nodes: Sequence[ExistingNode],
    class_zone_pins: bool = False,
) -> np.ndarray:
    """[C, N] bool: a pod of class c may land on node n (labels + taints).
    Mirrors the oracle's existing-node compatibility gate. With
    `class_zone_pins`, a SPREAD SUB-CLASS's pinned zone (the split pass
    marks these env_count == 0) additionally gates the node's zone.
    Ordinary classes stay pool-agnostic: a pool-derived zone requirement
    must not block packing onto live capacity the oracle would use."""
    C, N = len(classes), len(nodes)
    out = np.zeros((C, N), dtype=bool)
    for ci, pc in enumerate(classes):
        pod = pc.pods[0]
        zreq = (
            pc.requirements.get(wk.ZONE_LABEL)
            if class_zone_pins and pc.env_count == 0
            else None
        )
        for ni, node in enumerate(nodes):
            if not tolerates_all(pod.tolerations, node.taints):
                continue
            if zreq is not None:
                node_zone = node.labels.get(wk.ZONE_LABEL)
                if node_zone is None or not zreq.matches(node_zone):
                    continue
            out[ci, ni] = any(
                alt.matches_labels(node.labels) for alt in pod.scheduling_requirements()
            )
    return out


def _with_pool_requirements(classes: Sequence[encode.PodClass], pool: NodePool) -> List[encode.PodClass]:
    """Re-derive each class's requirements merged with the pool's (the class
    set was grouped pool-agnostically; replacement compat is per-pool)."""
    return encode.with_extra_requirements(classes, pool.requirements())


class _Encoded:
    """One sweep's host-encoded tensors (the repack problem)."""

    __slots__ = ("classes", "req", "feas", "headroom", "member", "excl",
                 "C", "N", "S", "n_sets")


class _PoolCtx:
    """One pool's replacement context: the catalog snapshot (in wire mode
    with its staged seqnum; its capacity and price tensors on the
    engine's device once the local route needs them), the pool-merged
    class tensors, and the class-type compatibility masks."""

    __slots__ = ("pool", "catalog", "seqnum", "entry", "cap", "price", "cs", "compat", "ovh")


class DisruptEngine:
    """Evaluates many consolidation candidate sets in one device dispatch.

    Replacement context comes from the nodepools in weight order: the first
    pool whose catalog admits a feasible replacement wins (the oracle's
    pool-iteration order in _open_group).

    ``device`` None means the card and raises without CUDA; only an
    explicit ``device="cpu"`` runs the kernels' plain versions. ``solver``
    (a TorchSolver) lends its device and its catalog cache: the sweep
    reads the same staged catalog the provisioning solve runs against."""

    def __init__(self, device=None, solver=None):
        if solver is not None:
            self.device = solver.device
        else:
            from karpenter_tpu_torch.solver.service import resolve_device

            self.device = resolve_device(device)
        self.solver = solver
        # keyed by object identity; holds the items list so the id stays valid
        self._catalog_cache: Dict[int, Tuple[list, CatalogTensors, torch.Tensor, torch.Tensor]] = {}
        # dispatch observability for the LAST evaluate: route taken, set
        # count, sweep wall time
        self.last_dispatch = {"path": "none", "sets": 0, "ms": 0.0}

    # -- catalog snapshots ----------------------------------------------------
    def _catalog_for(self, items: list):
        """(catalog tensors, staged seqnum or None, the solver's catalog
        entry or None, cap and price on the device or None). With a
        solver, the PROVISIONING path's catalog cache supplies the
        snapshot and the seqnum the wire op references; a remote solver's
        entry stages on the device only when the local route runs."""
        if self.solver is not None:
            entry = self.solver._catalog(items)
            if entry.staged is None:
                return entry.tensors, entry.seqnum, entry, None, None
            return entry.tensors, entry.seqnum, entry, entry.staged.cap, entry.staged.price
        key = id(items)
        hit = self._catalog_cache.get(key)
        if hit is None:
            if len(self._catalog_cache) > 8:  # bound it; evict oldest entry
                self._catalog_cache.pop(next(iter(self._catalog_cache)))
            tensors = encode.encode_catalog(items)
            hit = self._catalog_cache[key] = (
                items, tensors, torch.from_numpy(tensors.cap).to(self.device),
                torch.from_numpy(tensors.price).to(self.device))
        return hit[1], None, None, hit[2], hit[3]

    # -- encoding -------------------------------------------------------------
    def _encode_sets(
        self,
        nodes: Sequence[ExistingNode],
        sets: Sequence[Tuple[Sequence[Pod], Sequence[str]]],
    ) -> Optional[_Encoded]:
        all_pods = [p for pods, _ in sets for p in pods]
        if not all_pods:
            return None
        classes = encode.group_pods(all_pods)
        key_of = {pc.key: i for i, pc in enumerate(classes)}

        enc = _Encoded()
        enc.classes = classes
        enc.n_sets = len(sets)
        C = enc.C = _bucket(len(classes))
        N = enc.N = _bucket(max(1, len(nodes)), lo=16)
        S = enc.S = _bucket(len(sets))
        R = encode.R

        req = np.zeros((C, R), dtype=np.float32)
        for i, pc in enumerate(classes):
            req[i] = pc.requests
        enc.req = req
        feas = np.zeros((C, N), dtype=bool)
        feas[: len(classes), : len(nodes)] = _node_feasibility(classes, nodes)
        enc.feas = feas
        headroom = np.zeros((N, R), dtype=np.float32)
        for ni, node in enumerate(nodes):
            headroom[ni] = encode.scale_vector(node.remaining().to_vector())
        enc.headroom = headroom

        member = np.zeros((S, C), dtype=np.int32)
        excl = np.zeros((S, N), dtype=bool)
        name_to_idx = {n.name: i for i, n in enumerate(nodes)}
        for si, (pods, excluded) in enumerate(sets):
            for p in pods:
                pc_reqs = p.scheduling_requirements()[0]
                k = encode._class_key(p, pc_reqs)
                member[si, key_of[k]] += 1
            for name in excluded:
                ni = name_to_idx.get(name)
                if ni is not None:
                    excl[si, ni] = True
        enc.member = member
        enc.excl = excl
        return enc

    def _pool_contexts(
        self,
        enc: _Encoded,
        pools: Sequence[NodePool],
        catalogs: Dict[str, list],
        daemon_overhead: Optional[Dict[str, Resources]],
    ) -> List[_PoolCtx]:
        out = []
        for pool in sorted(pools, key=lambda p: -p.weight):
            items = catalogs.get(pool.name) or []
            if not items:
                continue
            ctx = _PoolCtx()
            ctx.pool = pool
            ctx.catalog, ctx.seqnum, ctx.entry, ctx.cap, ctx.price = self._catalog_for(items)
            ctx.cs = encode.encode_classes(
                _with_pool_requirements(enc.classes, pool), ctx.catalog,
                # template.taints ONLY: startup taints lift before pods land,
                # and the oracle's _open_group gates on exactly this set --
                # including startup taints here would wrongly report inf
                # replacement price for pods that do not tolerate them
                pool_taints=list(pool.template.taints),
                c_pad=enc.C,
            )
            ctx.compat = encode.compat_matrix(ctx.catalog, ctx.cs)
            ovh = (daemon_overhead or {}).get(pool.name)
            ctx.ovh = np.zeros((encode.R,), dtype=np.float32)
            if ovh is not None:
                ctx.ovh = encode.scale_vector(ovh.to_vector()).astype(np.float32)
            out.append(ctx)
        return out

    # -- evaluation -----------------------------------------------------------
    def evaluate(
        self,
        nodes: Sequence[ExistingNode],
        sets: Sequence[Tuple[Sequence[Pod], Sequence[str]]],
        pools: Sequence[NodePool] = (),
        catalogs: Optional[Dict[str, list]] = None,
        daemon_overhead: Optional[Dict[str, Resources]] = None,
    ) -> List[SetVerdict]:
        """nodes: surviving-capacity snapshot (oracle node order).
        sets: per candidate set, (pods to repack, names of excluded nodes).
        pools/catalogs: replacement context (optional; omit for delete-only).
        daemon_overhead: per-pool fresh-node reserve (apis/daemonset) --
        a replacement node must fit the leftovers PLUS its daemonsets."""
        if not sets:
            return []
        t0 = time.perf_counter()
        enc = self._encode_sets(nodes, sets)
        if enc is None:
            self.last_dispatch = {"path": "none", "sets": len(sets), "ms": 0.0}
            return [
                SetVerdict(True, 0, float("inf"), float("inf"), None, None) for _ in sets
            ]
        ctxs = (
            self._pool_contexts(enc, pools, catalogs, daemon_overhead)
            if pools and catalogs else []
        )
        path = "local"
        client = self.solver.client if self.solver is not None else None
        if client is not None:
            if self.solver.wire_healthy():
                try:
                    if "solve_disrupt" in client.features():
                        verdicts = self._evaluate_wire(enc, ctxs, client)
                        if self.solver.breaker is not None:
                            self.solver.breaker.record_success()
                        path = "wire"
                    else:
                        # older sidecar: the op does not exist; the local
                        # kernels are the same decision function
                        metrics.DISRUPTION_DEVICE_FALLBACKS.inc(reason="feature-missing")
                        verdicts = self._evaluate_local(enc, ctxs)
                except (ConnectionError, OSError, RuntimeError) as e:
                    # the provisioning solve's ladder: the failure counts
                    # toward opening the breaker and the sweep re-runs on
                    # the local kernels -- the same decisions
                    if self.solver.breaker is not None:
                        self.solver.breaker.record_failure()
                    metrics.DISRUPTION_DEVICE_FALLBACKS.inc(reason="rpc-down")
                    from karpenter_tpu_torch import tracing

                    tracing.annotate(disrupt_fallback=f"{type(e).__name__}")
                    verdicts = self._evaluate_local(enc, ctxs)
            else:
                # breaker open (or half-open): local at once, counted
                metrics.DISRUPTION_DEVICE_FALLBACKS.inc(reason="breaker-open")
                verdicts = self._evaluate_local(enc, ctxs)
        else:
            verdicts = self._evaluate_local(enc, ctxs)
        metrics.DISRUPTION_DEVICE_DISPATCHES.inc(path=path)
        ms = (time.perf_counter() - t0) * 1e3
        metrics.DISRUPTION_DEVICE_SWEEP_SECONDS.observe(ms / 1e3)
        self.last_dispatch = {"path": path, "sets": len(sets), "ms": round(ms, 3)}
        return verdicts

    def _assemble(
        self, enc: _Encoded, ctxs: List[_PoolCtx], left_total: np.ndarray,
        replace,
    ) -> List[SetVerdict]:
        """Shared verdict assembly: per-pool replacement passes in weight
        order, first feasible pool wins per set; ``replace(ctx)`` returns
        (best, best_od, best_k) numpy arrays for the current leftover."""
        verdicts = [
            SetVerdict(
                can_delete=bool(left_total[si] == 0),
                leftover=int(left_total[si]),
                replace_price=float("inf"),
                replace_od_price=float("inf"),
                replace_type=None,
                nodepool=None,
            )
            for si in range(enc.n_sets)
        ]
        pending = [si for si in range(enc.n_sets) if left_total[si] > 0]
        for ctx in ctxs:
            if not pending:
                break
            best, best_od, best_k = replace(ctx)
            still = []
            for si in pending:
                if np.isfinite(best[si]):
                    verdicts[si] = SetVerdict(
                        can_delete=False,
                        leftover=int(left_total[si]),
                        replace_price=float(best[si]),
                        replace_od_price=float(best_od[si]),
                        replace_type=ctx.catalog.names[int(best_k[si])],
                        nodepool=ctx.pool.name,
                    )
                else:
                    still.append(si)
            pending = still
        return verdicts

    # -- local route ----------------------------------------------------------
    def _dispatch_local(self, enc: _Encoded) -> np.ndarray:
        """[n_sets] leftover totals from kernel B (its plain version on the
        CPU); the [S, C] leftover stays on the device for the replacement
        passes."""
        ops = kernel.repack_from_numpy(
            enc.headroom, enc.feas, enc.req, enc.member, enc.excl, self.device)
        leftover, _ = kernel.disrupt_repack(*ops)
        self._leftover = leftover
        return leftover.sum(dim=1).cpu().numpy()

    def _evaluate_local(self, enc: _Encoded, ctxs: List[_PoolCtx]) -> List[SetVerdict]:
        left_total = self._dispatch_local(enc)
        od_col = int(encode.CAPTYPE_INDEX[wk.CAPACITY_TYPE_ON_DEMAND])

        def put(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

        def replace(ctx: _PoolCtx):
            if ctx.cap is None:
                # a remote solver's snapshot, staged here on first local use
                staged = self.solver._local_staged(ctx.entry).staged
                ctx.cap, ctx.price = staged.cap, staged.price
            out = kernel.disrupt_replace(
                self._leftover, put(ctx.cs.req), put(ctx.compat), put(ctx.cs.azone),
                put(ctx.cs.acap), ctx.cap, put(ctx.ovh), ctx.price, od_col=od_col,
            )
            # one fetch of the three results
            best, best_od, best_k = torch.cat(
                [out[0], out[1], out[2].to(torch.float32)]).cpu().numpy().reshape(3, -1)
            return best, best_od, best_k.astype(np.int32)

        return self._assemble(enc, ctxs, left_total, replace)

    # -- wire route -----------------------------------------------------------
    def _evaluate_wire(self, enc: _Encoded, ctxs: List[_PoolCtx], client) -> List[SetVerdict]:
        """One sweep over the sidecar: the repack ships once (the leftover
        stays staged under a disrupt epoch), each pool's replacement pass
        ships only the class-side masks, and the catalog tensors never
        ship at all. Raises on any wire failure the client's retry ladder
        cannot absorb; the caller falls back to the local route."""
        def replace_tensors(ctx: _PoolCtx) -> Dict[str, np.ndarray]:
            return {
                "creq": ctx.cs.req, "compat": ctx.compat,
                "azone": ctx.cs.azone, "acap": ctx.cs.acap, "ovh": ctx.ovh,
            }

        first = ctxs[0] if ctxs else None
        depoch, out = client.solve_disrupt_repack(
            {
                "headroom": enc.headroom, "feas": enc.feas, "req": enc.req,
                "member": enc.member, "excl": enc.excl,
            },
            seqnum=first.seqnum if first is not None else None,
            catalog=first.catalog if first is not None else None,
            replace=replace_tensors(first) if first is not None else None,
        )
        leftover = np.asarray(out["leftover"])
        left_total = leftover.sum(axis=1)
        first_result = (
            (np.asarray(out["best"]), np.asarray(out["best_od"]), np.asarray(out["best_k"]))
            if "best" in out else None
        )

        def replace(ctx: _PoolCtx):
            if ctx is first and first_result is not None:
                return first_result
            r = client.solve_disrupt_replace(
                depoch, seqnum=ctx.seqnum, catalog=ctx.catalog,
                replace=replace_tensors(ctx), leftover=leftover,
            )
            return np.asarray(r["best"]), np.asarray(r["best_od"]), np.asarray(r["best_k"])

        return self._assemble(enc, ctxs, left_total, replace)
