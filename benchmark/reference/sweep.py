"""Plain reference of a consolidation sweep: for each candidate set of
nodes, whether its pods fit on the nodes that stay (delete), else the
cheapest single new node that holds what is left (replace).

The semantics, worked out here from the plain inputs:
- the pods of all sets form one list of classes (common.group); a set
  repacks its pods class by class in that order, first fit over the
  nodes in cluster order, skipping its own nodes: a node takes as many
  pods of a class as fit its remaining room, and its room shrinks;
- a set whose pods all fit is deleted;
- else, per NodePool in weight order, the replacement is the cheapest
  (type, zone, capacity type) offering that admits every class left
  over, in a zone and capacity type each of them admits, on a type
  whose allocatable net of the pool's daemonset reserve holds the sum
  of their requests; the first pool with one wins. Ties go to the first
  type in catalog order. The on-demand-only price is kept beside it.

`sweep` returns one verdict tuple per set:
(can_delete, leftover pods, replace price, on-demand price, type, pool).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from reference.common import (
    CAPTYPES, SCALE, Catalog, PodClass, Precision, admits, group, vector,
)

F32 = np.float32


def node_feasible(pc: PodClass, labels: Dict[str, str]) -> bool:
    """A pod of the class may land on a node with these labels (no node
    here carries a taint)."""
    return all(labels.get(k) == v for k, v in pc.selector.items())


def repack(headroom: np.ndarray, feas: np.ndarray, req: np.ndarray, member: np.ndarray,
           excl: np.ndarray, p: Precision, walked: Optional[np.ndarray] = None,
           takes: Optional[np.ndarray] = None) -> np.ndarray:
    """[S, C] pods of class c in set s that fit no surviving node.
    headroom [N, R] f32, feas [C, N] bool, req [C, R] f32, member [S, C],
    excl [S, N] bool. `walked`, when given ([S, C]), gets the nodes each
    (set, class) pair looks at before its pods are placed; `takes`
    ([S, C, N]) the pods of each class each node takes."""
    S, C = member.shape
    hr0 = headroom.astype(F32)
    hr = np.where(excl[:, :, None], F32(0), headroom[None, :, :]).astype(F32)
    left = np.zeros((S, C), dtype=np.int64)
    for c in range(C):
        if not member[:, c].any():
            continue
        pos = np.nonzero(req[c] > 0)[0]
        fit = None
        for r in pos:
            axis_n = np.floor(p.q(hr[:, :, r] / req[c, r]))
            fit = axis_n if fit is None else np.minimum(fit, axis_n)
        fit = np.maximum(fit, F32(0))
        fit = np.where(feas[c][None, :], fit, F32(0))
        fit = np.clip(fit.astype(np.float64), 0, 2**31 - 1).astype(np.int64)
        cum_before = np.cumsum(fit, axis=1) - fit
        take = np.minimum(np.maximum(member[:, c, None] - cum_before, 0), fit)
        if walked is not None:
            # nodes where a pod of the class fits in some set (room in the
            # headroom before any set), walked until the first-fit prefix
            # reaches the count
            room = feas[c] & (np.floor(hr0[:, pos] / req[c, pos]).min(axis=1) >= 1)
            walked[:, c] = (room[None, :] & (cum_before < member[:, c, None])).sum(axis=1)
        if takes is not None:
            takes[:, c, :] = take
        hr = p.q(hr - p.q(take.astype(F32)[:, :, None] * req[c][None, None, :]))
        left[:, c] = member[:, c] - take.sum(axis=1)
    return left


def replace(catalog: Catalog, classes: Sequence[PodClass], left: np.ndarray, pool_captype: str,
            overhead: np.ndarray, p: Precision):
    """Per set: (cheapest price, cheapest on-demand price, type index or
    -1) of one new node of the pool holding every leftover pod."""
    S, C = left.shape
    K, Z, CT = catalog.price.shape
    cap = p.q(np.maximum(catalog.alloc - overhead[None, :], F32(0)))
    req = np.stack([pc.req for pc in classes]).astype(np.float64)
    agg = p.q((left.astype(np.float64) @ req).astype(F32))                  # [S, R]
    adm = [admits(pc, catalog, pool_captype) for pc in classes]
    compat = np.stack([a[0] for a in adm])                                  # [C, K]
    azone = np.stack([a[1] for a in adm])                                   # [C, Z]
    acap = np.stack([a[2] for a in adm])                                    # [C, CT]
    need = left > 0
    ok_type = ~((need.astype(np.int64) @ (~compat).astype(np.int64)) > 0)    # [S, K]
    fits = np.all(cap[None, :, :] >= agg[:, None, :], axis=-1)
    ok_type &= fits & need.any(axis=1)[:, None]
    zone_ok = ~((need.astype(np.int64) @ (~azone).astype(np.int64)) > 0)     # [S, Z]
    cap_ok = ~((need.astype(np.int64) @ (~acap).astype(np.int64)) > 0)       # [S, CT]
    best = np.full((S,), np.inf)
    best_od = np.full((S,), np.inf)
    best_k = np.full((S,), -1, dtype=np.int64)
    od = CAPTYPES.index("on-demand")
    for s in np.nonzero(ok_type.any(axis=1))[0]:
        masked = np.where(ok_type[s][:, None, None] & zone_ok[s][None, :, None]
                          & cap_ok[s][None, None, :], catalog.price, np.inf)
        flat = masked.reshape(K, -1)
        i = int(np.argmin(flat))
        if np.isfinite(flat.flat[i]):
            best[s], best_k[s] = float(flat.flat[i]), i // (Z * CT)
        best_od[s] = float(masked[:, :, od].min())
    return best, best_od, best_k


def sweep(catalog: Catalog, templates, world: dict, sets: Sequence[Sequence[int]], pools,
          precision: Precision = Precision(), walked: Optional[list] = None) -> List[tuple]:
    """Verdicts of the candidate `sets` (tuples of candidate indices) over
    `world` (gen/sweep.py): its nodes, candidates and the (template, name)
    pods each candidate holds. `pools` are (name, capacity type, weight,
    daemonset reserve in base units). `walked`, when given, gets the
    repack's (nodes walked [S, C], members [S, C], nodes)."""
    p = precision
    nodes = world["nodes"]
    name_idx = {n["name"]: i for i, n in enumerate(nodes)}
    classes = group([(name, templates[t]["requests"], templates[t]["selector"],
                      templates[t]["tolerations"])
                     for idx in sets for i in idx for t, name in world["pods"][i]])
    class_of = {}
    for ci, pc in enumerate(classes):
        for t, tpl in enumerate(templates):
            if (tpl["requests"] == pc.requests and tpl["selector"] == pc.selector
                    and tuple(sorted(tuple(x) for x in tpl["tolerations"])) == pc.tolerations):
                class_of[t] = ci
    C, N, S = len(classes), len(nodes), len(sets)
    req = np.stack([p.q(pc.req) for pc in classes])
    feas = np.array([[node_feasible(pc, n["labels"]) for n in nodes] for pc in classes])
    headroom = p.q(np.stack([
        ((vector(n["alloc"]) - vector(n["used"])) * SCALE).astype(F32) for n in nodes]))
    member = np.zeros((S, C), dtype=np.int64)
    excl = np.zeros((S, N), dtype=bool)
    for s, idx in enumerate(sets):
        for i in idx:
            for t, _ in world["pods"][i]:
                member[s, class_of[t]] += 1
            excl[s, name_idx[world["candidates"][i]]] = True
    w = np.zeros((S, C), dtype=np.int64) if walked is not None else None
    left = repack(headroom, feas, req, member, excl, p, walked=w)
    if walked is not None:
        walked.append((w, member, len(nodes)))
    total = left.sum(axis=1)
    verdicts: List[Optional[tuple]] = [
        (True, 0, float("inf"), float("inf"), None, None) if total[s] == 0 else None
        for s in range(S)]
    pending = [s for s in range(S) if verdicts[s] is None]
    for name, captype, _, reserve in sorted(pools, key=lambda q: -q[2]):
        if not pending:
            break
        ovh = p.q((vector(reserve) * SCALE).astype(F32))
        best, best_od, best_k = replace(catalog, classes, left[pending], captype, ovh, p)
        still = []
        for j, s in enumerate(pending):
            if np.isfinite(best[j]):
                verdicts[s] = (False, int(total[s]), float(best[j]), float(best_od[j]),
                               catalog.names[int(best_k[j])], name)
            else:
                still.append(s)
        pending = still
    for s in pending:
        verdicts[s] = (False, int(total[s]), float("inf"), float("inf"), None, None)
    return verdicts


def compare(got: Sequence[tuple], want: Sequence[tuple]) -> Dict[str, float]:
    """The number a sweep check holds at 0: sets whose verdict differs in
    any field (action, leftover, prices, type, pool)."""
    return {"verdicts_differ": float(sum(1 for a, b in zip(got, want) if a != b)
                                     + abs(len(got) - len(want)))}
