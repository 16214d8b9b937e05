"""DisruptEngine: batched candidate-set consolidation in one dispatch.

Copy of karpenter_tpu/solver/disrupt/engine.py. Host side of the consolidation solve: encode the candidate sets
once ([S, C] membership, [S, N] exclusions, [C, N] feasibility, [N, R]
headroom), run the repack (kernel B's leftover-only entry, one block per
candidate set; the sweep reads no per-node placements) and the
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
- local: kernel B and the replacement search on the engine's device;
  with ``mesh=`` the repack's candidate-set axis splits over the mesh's
  shards (parallel/mesh.py ``sharded_repack_leftover``: kernel B once per shard,
  S padded to a multiple of the mesh size), its operands uploaded through
  the pinned path.

Both count ``karpenter_disruption_device_dispatches_total{path}`` and the
sweep's wall in ``karpenter_disruption_device_sweep_seconds``. As in the
JAX engine, the local route's kernel B call is not counted in
``karpenter_solver_kernel_dispatches_total``: that family is the solver's
own, and ``{path="local"}`` counts the engine's one kernel B run per
evaluate.

Traced, an evaluate opens under its caller's span, in order:
``encode_sets``, ``pool_contexts``, ``repack`` (kernel B and the fetch of
its totals, or the wire's repack op), ``replace`` (one per pool's pass)
and ``assemble`` (the verdicts). The JAX engine opens none of them
(tracing.PORT_SPANS).

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

from karpenter_tpu_torch import metrics, tracing
from karpenter_tpu_torch.apis import NodePool, Pod, labels as wk
from karpenter_tpu_torch.scheduling import Resources, tolerates_all
from karpenter_tpu_torch.solver import encode
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


def req_rows(classes, C: int) -> np.ndarray:
    """Kernel B's [C, R] float32 requests: one row per class, then zero
    rows to the bucket."""
    req = np.zeros((C, encode.R), dtype=np.float32)
    for i, pc in enumerate(classes):
        req[i] = pc.requests
    return req


def headroom_rows(nodes, N: int) -> np.ndarray:
    """Kernel B's [N, R] float32 headroom: each node's remaining capacity,
    scaled, then zero rows to the bucket."""
    headroom = np.zeros((N, encode.R), dtype=np.float32)
    for ni, node in enumerate(nodes):
        headroom[ni] = encode.scale_vector(node.remaining().to_vector())
    return headroom


def _node_feasibility(
    classes: Sequence[encode.PodClass], nodes: Sequence[ExistingNode],
    class_zone_pins: bool = False,
) -> np.ndarray:
    """[C, N] bool: a pod of class c may land on node n (labels + taints).
    Mirrors the oracle's existing-node compatibility gate. With
    `class_zone_pins`, a SPREAD SUB-CLASS's pinned zone (the split pass
    marks these env_count == 0) additionally gates the node's zone.
    Ordinary classes stay pool-agnostic: a pool-derived zone requirement
    must not block packing onto live capacity the oracle would use.

    Each predicate reads only part of a node: the alternatives their own
    label keys, the zone pin the zone label, the tolerations the taints.
    So the predicates run once per (distinct class row, distinct node
    signature) -- a node's values on the label keys any class reads, and
    its taints -- on one representative node, and the [rows, U] table is
    gathered out to [C, N]. Classes fold by their alternatives,
    tolerations and zone pin (Requirement equality is the fields
    `matches` reads). The span open at the call gets `feas_node_rows`
    (U) and `feas_pairs` (predicate evaluations)."""
    rows: Dict[tuple, int] = {}
    preds = []          # (alternatives, tolerations, zone pin) of each row
    class_row = []
    for pc in classes:
        pod = pc.pods[0]
        zreq = (
            pc.requirements.get(wk.ZONE_LABEL)
            if class_zone_pins and pc.env_count == 0
            else None
        )
        alts = pod.scheduling_requirements()
        key = (tuple(frozenset(alt) for alt in alts), tuple(pod.tolerations), zreq)
        ri = rows.setdefault(key, len(rows))
        if ri == len(preds):
            preds.append((alts, pod.tolerations, zreq))
        class_row.append(ri)
    keys = sorted({k for alts, _, _ in preds for alt in alts for k in alt.keys()}
                  | {wk.ZONE_LABEL for _, _, zreq in preds if zreq is not None})
    sigs: Dict[tuple, int] = {}
    reps: List[ExistingNode] = []
    node_row = []
    for node in nodes:
        sig = (tuple([node.labels.get(k) for k in keys]), tuple(node.taints))
        u = sigs.setdefault(sig, len(sigs))
        if u == len(reps):
            reps.append(node)
        node_row.append(u)
    table = np.zeros((len(preds), len(reps)), dtype=bool)
    for ri, (alts, tolerations, zreq) in enumerate(preds):
        for ui, node in enumerate(reps):
            if not tolerates_all(tolerations, node.taints):
                continue
            if zreq is not None:
                node_zone = node.labels.get(wk.ZONE_LABEL)
                if node_zone is None or not zreq.matches(node_zone):
                    continue
            table[ri, ui] = any(alt.matches_labels(node.labels) for alt in alts)
    tracing.annotate(feas_node_rows=len(reps), feas_pairs=table.size)
    return table[np.ix_(class_row, node_row)]


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
    reads the same staged catalog the provisioning solve runs against.
    ``mesh`` (a parallel.mesh.Mesh) splits the local repack's
    candidate-set axis across the shards (parallel/mesh.sharded_repack_leftover),
    as the JAX engine's does."""

    def __init__(self, device=None, solver=None, mesh=None):
        from karpenter_tpu_torch.solver.device_engine import DeviceEngine

        self.mesh = mesh
        if solver is not None:
            self.device = solver.device
        elif mesh is not None and device is None:
            self.device = mesh.primary
        else:
            from karpenter_tpu_torch.solver.service import resolve_device

            self.device = resolve_device(device)
        # the local route's kernel B (unsharded) and replacement search
        self._device_engine = DeviceEngine(self.device)
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
        S = _bucket(len(sets))
        n = self.mesh.size if self.mesh is not None else 0
        if n and S % n:
            # the split set axis divides evenly across the shards
            S = ((S + n - 1) // n) * n
        enc.S = S

        enc.req = req_rows(classes, C)
        feas = np.zeros((C, N), dtype=bool)
        feas[: len(classes), : len(nodes)] = _node_feasibility(classes, nodes)
        enc.feas = feas
        enc.headroom = headroom_rows(nodes, N)

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
        with tracing.span("encode_sets", sets=len(sets)):
            enc = self._encode_sets(nodes, sets)
        if enc is None:
            self.last_dispatch = {"path": "none", "sets": len(sets), "ms": 0.0}
            return [
                SetVerdict(True, 0, float("inf"), float("inf"), None, None) for _ in sets
            ]
        with tracing.span("pool_contexts"):
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
        (best, best_od, best_k) numpy arrays for the current leftover.
        Each pool's pass is a ``replace`` span, the verdicts one
        ``assemble`` span after them."""
        won: Dict[int, tuple] = {}      # set -> (pool context, its pass's arrays)
        pending = [si for si in range(enc.n_sets) if left_total[si] > 0]
        for ctx in ctxs:
            if not pending:
                break
            with tracing.span("replace", pool=ctx.pool.name):
                best, best_od, best_k = replace(ctx)
                still = []
                for si in pending:
                    if np.isfinite(best[si]):
                        won[si] = (ctx, best, best_od, best_k)
                    else:
                        still.append(si)
                pending = still
        with tracing.span("assemble"):
            verdicts = []
            for si in range(enc.n_sets):
                if si in won:
                    ctx, best, best_od, best_k = won[si]
                    verdicts.append(SetVerdict(
                        can_delete=False,
                        leftover=int(left_total[si]),
                        replace_price=float(best[si]),
                        replace_od_price=float(best_od[si]),
                        replace_type=ctx.catalog.names[int(best_k[si])],
                        nodepool=ctx.pool.name,
                    ))
                else:
                    verdicts.append(SetVerdict(
                        can_delete=bool(left_total[si] == 0),
                        leftover=int(left_total[si]),
                        replace_price=float("inf"),
                        replace_od_price=float("inf"),
                        replace_type=None,
                        nodepool=None,
                    ))
        return verdicts

    # -- local route ----------------------------------------------------------
    def _dispatch_local(self, enc: _Encoded) -> np.ndarray:
        """[n_sets] leftover totals from kernel B (its plain version on the
        CPU; once per shard with a mesh); the [S, C] leftover stays on the
        device for the replacement passes."""
        if self.mesh is not None:
            from karpenter_tpu_torch.parallel.mesh import sharded_repack_leftover

            # the pinned uploads' staging buffers live until the fetch below
            hold: list = []
            leftover = sharded_repack_leftover(
                self.mesh, enc.headroom, enc.feas, enc.req, enc.member, enc.excl, hold=hold)
            self._leftover = leftover
            return leftover.sum(dim=1).cpu().numpy()
        leftover = self._device_engine.repack_leftover(
            enc.headroom, enc.feas, enc.req, enc.member, enc.excl)
        self._leftover = leftover
        return leftover.sum(dim=1).cpu().numpy()

    def _evaluate_local(self, enc: _Encoded, ctxs: List[_PoolCtx]) -> List[SetVerdict]:
        with tracing.span("repack"):
            left_total = self._dispatch_local(enc)
        od_col = int(encode.CAPTYPE_INDEX[wk.CAPACITY_TYPE_ON_DEMAND])

        def put(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

        def replace(ctx: _PoolCtx):
            if ctx.cap is None:
                # a remote solver's snapshot, staged here on first local use
                staged = self.solver._local_staged(ctx.entry).staged
                ctx.cap, ctx.price = staged.cap, staged.price
            out = self._device_engine.replace(
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
        with tracing.span("repack"):
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
