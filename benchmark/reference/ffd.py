"""Plain reference of a provisioning tick on one NodePool: which new nodes
open, of which types, zones and capacity types, and which pods each holds.

The semantics, worked out here from the plain inputs:
- classes in first-fit-decreasing order (common.group); for each class,
  its pods first fill the open nodes in the order they opened, each node
  taking as many as fit the tightest of its surviving types;
- what is left opens new nodes. Under the price objective a class sizes
  them by its price envelope: among the types a fresh node may open with,
  the one that serves the class's remaining pods at the least price
  (price x nodes needed; a type serving under half the largest fit is
  not eligible); the new nodes keep every type at least as big and no
  dearer. Pods then go to the new nodes, as many as that size each;
- a node's surviving types are those that still hold everything placed on
  it, in the zones and capacity types every class on it admits;
- a node is reported with its surviving types, cheapest offering first,
  and the pods of each class in the order the class lists them.

`tick` returns the decision in the plain form `compare` reads; the same
form is what the benchmark makes of the program's result.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from reference.common import (
    CAPTYPES, Catalog, PodClass, Precision, admits, bits, joint_ok,
)

F32 = np.float32


def fit_counts(cap: np.ndarray, accum: np.ndarray, req: np.ndarray, p: Precision) -> np.ndarray:
    """[G, K] pods of `req` that fit in cap[k] - accum[g]; an axis the
    class requests nothing of does not bind."""
    n = None
    for r in np.nonzero(req > 0)[0]:
        room = p.q(cap[None, :, r] - accum[:, r, None])
        axis_n = np.floor(p.q(room / req[r]))
        n = axis_n if n is None else np.minimum(n, axis_n)
    if n is None:
        return np.full((accum.shape[0], cap.shape[0]), np.inf, dtype=F32)
    return np.maximum(n, F32(0))


def to_i(x) -> np.ndarray:
    """float -> int, truncated toward zero, saturated at the int32 range."""
    x = np.nan_to_num(np.asarray(x, dtype=np.float64), nan=0.0)
    return np.clip(x, -(2**31), 2**31 - 1).astype(np.int64)


def envelopes(classes: Sequence[PodClass]) -> np.ndarray:
    """Price-envelope pod counts: classes whose requirements coincide under
    the pool share one envelope (the first counts the later ones' pods in,
    the later ones are pinned to the whole); -1 is the class's own
    remaining pods. On one pool without requirements of its own, classes
    coincide only if they are the same class, so every envelope is -1."""
    env = np.full((len(classes),), -1, dtype=np.int64)
    first: Dict[tuple, int] = {}
    keys = [(tuple(pc.req.tolist()), tuple(sorted(pc.selector.items())), pc.tolerations)
            for pc in classes]
    for c, key in enumerate(keys):
        f = first.get(key)
        if f is None:
            first[key] = c
            tail = sum(len(classes[j].pods) for j in range(c + 1, len(classes)) if keys[j] == key)
            if tail:
                env[c] = -(1 + tail)
        else:
            env[c] = sum(len(classes[j].pods) for j in range(f, len(classes)) if keys[j] == key)
    return env


def tick(catalog: Catalog, classes: Sequence[PodClass], *, g_max: int, objective: str = "price",
         node_overhead: Optional[np.ndarray] = None, placed: Optional[np.ndarray] = None,
         precision: Precision = Precision(), joined: Optional[list] = None) -> dict:
    """The new nodes for `classes` on an empty pool (after `placed[c]` pods
    of class c went to existing nodes). `joined`, when given, gets for each
    class step the (open node, type) pairs that join, the nodes open
    before it and whether the class has a type: the scan's work, for the
    roofline counts."""
    p = precision
    C, K = len(classes), catalog.K
    ovh = np.zeros_like(catalog.alloc[0]) if node_overhead is None else node_overhead
    cap = p.q(np.maximum(catalog.alloc - ovh[None, :], F32(0)))
    placed = np.zeros((C,), dtype=np.int64) if placed is None else placed
    G = g_max
    accum = np.zeros((G, cap.shape[1]), dtype=F32)
    gmask = np.zeros((G, K), dtype=bool)
    gzc = np.zeros((G,), dtype=np.int64)
    take = np.zeros((C, G), dtype=np.int64)
    unplaced = np.zeros((C,), dtype=np.int64)
    env_all = envelopes(classes)
    n_open = 0
    for c, pc in enumerate(classes):
        compat, azone, acap = admits(pc, catalog)
        azc = bits(azone, acap)
        req = p.q(pc.req)
        count = len(pc.pods) - int(placed[c])
        env = int(env_all[c])
        # the open nodes first
        n = n_open
        gzc_new = gzc[:n] & azc
        m = gmask[:n] & compat[None, :] & joint_ok(gzc_new[:, None] & catalog.tzc[None, :])
        if joined is not None:
            joined.append((int(m.sum()), n, bool(compat.any())))
        n_fit = fit_counts(cap, accum[:n], req, p)
        n_grp = to_i(np.where(m, n_fit, F32(0)).max(axis=1, initial=F32(0)))
        cum_before = np.cumsum(n_grp) - n_grp
        t_old = np.minimum(np.maximum(count - cum_before, 0), n_grp)
        leftover = count - int(t_old.sum())
        # then fresh nodes
        n_fresh = np.where(compat, fit_counts(cap, np.zeros((1, cap.shape[1]), F32), req, p)[0], F32(0))
        fresh = compat
        price = p.q(np.where(compat, catalog.price[:, azone][:, :, acap].min(axis=(1, 2), initial=np.inf),
                             np.inf).astype(F32))
        max_fit_f = np.where(fresh, n_fresh, F32(0)).max(initial=F32(0))
        per_new_fit = int(to_i(max_fit_f))
        if objective == "price":
            env_n = env if env > 0 else max(leftover + (-env - 1), 1)
            envf = F32(env_n)
            ngroups = np.ceil(p.q(envf / np.maximum(n_fresh, F32(1))))
            need = min(max_fit_f, envf)
            eligible = fresh & (n_fresh >= 1) & (F32(2) * np.minimum(n_fresh, envf) >= need)
            total = np.where(eligible, p.q(price * ngroups), F32(np.inf))
            kstar = int(np.argmin(total))
            ok = bool(np.isfinite(total[kstar]))
            per_new_price = int(to_i(n_fresh[kstar])) if ok else 0
            open_mask = fresh & (n_fresh >= F32(per_new_price)) & (price <= price[kstar]) & ok
            per_new = per_new_fit if env == 0 else per_new_price
            if env == 0:
                open_mask = fresh
        else:
            per_new, open_mask = per_new_fit, fresh
        n_new = -(-leftover // per_new) if leftover > 0 and per_new > 0 else 0
        n_new = min(n_new, G - n_open)
        t_new = np.minimum(np.maximum(leftover - np.arange(n_new) * per_new, 0), per_new)
        unplaced[c] = count - int(t_old.sum()) - int(t_new.sum())
        # carry the open nodes
        touched = t_old > 0
        accum[:n] = p.q(accum[:n] + p.q(t_old.astype(F32)[:, None] * req[None, :]))
        gmask[:n][touched] = (m & (t_old.astype(F32)[:, None] <= n_fit))[touched]
        gzc[:n][touched] = gzc_new[touched]
        new = slice(n_open, n_open + n_new)
        accum[new] = p.q(t_new.astype(F32)[:, None] * req[None, :])
        gmask[new] = open_mask[None, :] & (t_new.astype(F32)[:, None] <= n_fresh[None, :])
        gzc[new] = azc
        take[c, :n] = t_old
        take[c, new] = t_new
        n_open += n_new
    return decode(catalog, classes, take, unplaced, n_open, gmask, gzc, placed)


def decode(catalog: Catalog, classes, take, unplaced, n_open, gmask, gzc, placed) -> dict:
    """The decision in plain form: `nodes` as (type names cheapest first,
    pod names, zones, capacity types), `unschedulable` pod names."""
    nodes = []
    unsched: List[str] = []
    offset = placed.astype(np.int64).copy()
    for g in range(n_open):
        pods: List[str] = []
        for c in np.nonzero(take[:, g] > 0)[0]:
            n = int(take[c, g])
            pods.extend(classes[c].pods[offset[c]: offset[c] + n])
            offset[c] += n
        if not pods:
            continue
        types = [catalog.names[k] for k in catalog.order if gmask[g, k]]
        if not types:
            unsched.extend(pods)
            continue
        zones = frozenset(z for i, z in enumerate(catalog.zones) if gzc[g] >> i & 1)
        captypes = frozenset(ct for i, ct in enumerate(CAPTYPES) if gzc[g] >> (8 + i) & 1)
        nodes.append((tuple(types), tuple(pods), zones, captypes))
    for c in np.nonzero(unplaced > 0)[0]:
        unsched.extend(classes[c].pods[offset[c]: offset[c] + int(unplaced[c])])
    return {"nodes": nodes, "unschedulable": sorted(unsched), "n_open": n_open}


def node_price(catalog: Catalog, node) -> float:
    """$/h of the node a decision launches: the cheapest offering of its
    first type in a zone and capacity type it admits."""
    types, _, zones, captypes = node
    k = catalog.names.index(types[0])
    offers = [o[3] for o in catalog.entries[k]["offerings"] if o[1] in zones and o[0] in captypes]
    return min(offers) if offers else float("inf")


def pack_existing(classes: Sequence[PodClass], nodes: Sequence[dict],
                  precision: Precision = Precision(), walked: Optional[list] = None):
    """First fit of each class's pods onto the standing nodes, in class
    order and node order, before any new node opens: (pod -> node name,
    pods placed of each class). `walked`, when given, gets the repack's
    (nodes walked [1, C], members [1, C], nodes)."""
    from reference.common import SCALE, vector
    from reference.sweep import node_feasible, repack

    p = precision
    C, N = len(classes), len(nodes)
    headroom = p.q(np.stack([((vector(n["alloc"]) - vector(n["used"])) * SCALE).astype(F32)
                             for n in nodes]))
    feas = np.array([[node_feasible(pc, n["labels"]) for n in nodes] for pc in classes])
    req = np.stack([p.q(pc.req) for pc in classes])
    member = np.array([[len(pc.pods) for pc in classes]], dtype=np.int64)
    takes = np.zeros((1, C, N), dtype=np.int64)
    w = np.zeros((1, C), dtype=np.int64) if walked is not None else None
    repack(headroom, feas, req, member, np.zeros((1, N), dtype=bool), p, walked=w, takes=takes)
    if walked is not None:
        walked.append((w, member, N))
    where: Dict[str, str] = {}
    placed = np.zeros((C,), dtype=np.int64)
    for c, pc in enumerate(classes):
        cursor = 0
        for n in np.nonzero(takes[0, c])[0]:
            k = int(takes[0, c, n])
            for name in pc.pods[cursor: cursor + k]:
                where[name] = nodes[n]["name"]
            cursor += k
        placed[c] = cursor
    return where, placed


def compare(catalog: Catalog, got: dict, want: dict, n_pods: int) -> Dict[str, float]:
    """The numbers a provisioning check holds at 0: pods placed on another
    standing node; new nodes that differ in position, type list, pods,
    zones or capacity types; pods not decided exactly once; the relative
    gap of the fleet's price."""
    g, w = got["nodes"], want["nodes"]
    nodes_diff = sum(1 for a, b in zip(g, w) if a != b) + abs(len(g) - len(w))
    got_ex, want_ex = got.get("existing", {}), want.get("existing", {})
    existing_diff = len(set(got_ex.items()) ^ set(want_ex.items()))
    seen: Dict[str, int] = {}
    for node in g:
        for name in node[1]:
            seen[name] = seen.get(name, 0) + 1
    for name in list(got["unschedulable"]) + list(got_ex):
        seen[name] = seen.get(name, 0) + 1
    once = sum(1 for v in seen.values() if v == 1)
    pods_off = (n_pods - once) + sum(1 for v in seen.values() if v != 1)
    pods_off += abs(len(set(got["unschedulable"]) ^ set(want["unschedulable"])))
    price_g = sum(node_price(catalog, n) for n in g)
    price_w = sum(node_price(catalog, n) for n in w)
    gap = abs(price_g - price_w) / price_w if price_w else float(price_g != price_w)
    return {"existing_differ": float(existing_diff), "nodes_differ": float(nodes_diff),
            "pods_not_once": float(pods_off), "price_gap": float(gap)}
