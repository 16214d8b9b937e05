"""Plain reference of a provisioning tick over weighted NodePools: which new
nodes open, in which pool, of which types, zones and capacity types, and
which pods each holds.

The semantics (Karpenter's provisioning simulation: karpenter.sh,
"NodePools", "Weighted NodePools"), worked out here from the plain inputs:
- a pool offers one column per type it admits: the type's offerings of
  the pool's capacity type (all of them for a pool without one), and the
  type's allocatable less the pool's daemonset reserve. Pools come in
  weight order, heaviest first;
- classes in first-fit-decreasing order (common.group); for each class,
  its pods first fill the open nodes in the order they opened, whatever
  their pool, each node taking as many as fit the tightest of its
  surviving columns. A class may use a column when it tolerates the
  pool's taints and the type offers a zone and a capacity type the class
  admits; keys a pool leaves undefined do not bind;
- what is left opens new nodes, only in the class's opening pool: the
  first pool in weight order that admits the class (its capacity type
  compatible with the class's selector, its taints tolerated) and where
  a fresh node of some column holds one pod. Under the price objective a
  class sizes them by its price envelope: among the columns a fresh node
  may open with, the one that serves the class's remaining pods at the
  least price (price x nodes needed; a column serving under half the
  largest fit is not eligible); the new nodes keep every column at least
  as big and no dearer. Classes whose requirements coincide once the
  opening pool's merge in share one envelope. Pods then go to the new
  nodes, as many as that size each;
- a node's surviving columns are those that still hold everything placed
  on it, in the zones and capacity types every class on it admits; they
  are all of the pool it opened in;
- a node is reported with its pool, its surviving types, cheapest
  offering first, and the pods of each class in the order the class
  lists them.

`tick` returns the decision in the plain form `compare` reads; the same
form is what the benchmark makes of the program's result.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from gen.catalog import CAPACITY_TYPE_LABEL
from reference.common import (
    CAPTYPES, SCALE, Catalog, PodClass, Precision, admits, bits, joint_ok, vector,
)

F32 = np.float32
BLOCKING = ("NoSchedule", "NoExecute")


class Pool:
    """A NodePool as the reference reads it: name, weight, the capacity
    type it requires ("" for none), its daemonset reserve (base units by
    axis name) and its taints as (key, value, effect)."""

    __slots__ = ("name", "weight", "captype", "reserve", "taints")

    def __init__(self, name: str, weight: int = 0, captype: str = "",
                 reserve: Optional[Dict[str, float]] = None, taints=()):
        self.name, self.weight, self.captype = name, weight, captype
        self.reserve = vector(reserve or {})
        self.taints = tuple(tuple(t) for t in taints)

    def admits(self, pc: PodClass) -> bool:
        """The pool may open a node for the class: its capacity type does
        not contradict the class's selector, and the class tolerates its
        taints."""
        ct = pc.selector.get(CAPACITY_TYPE_LABEL)
        return (not self.captype or ct in (None, self.captype)) and tolerates(
            pc.tolerations, self.taints)


def pools(config: dict) -> List[Pool]:
    """The configuration's NodePools in weight order (ties keep the file's)."""
    out = [Pool(p["name"], p["weight"], p["captype"], p["overhead"], p.get("taints", ()))
           for p in config["pools"]]
    return sorted(out, key=lambda q: -q.weight)


def tolerates(tolerations, taints) -> bool:
    """Kubernetes' rule: each taint that blocks scheduling is tolerated by
    some (key, operator, value, effect) toleration."""
    def one(tol, taint) -> bool:
        key, op, value, effect = tol
        if effect and effect != taint[2]:
            return False
        if op == "Exists":
            return key in ("", taint[0])
        return key == taint[0] and value == taint[1]

    return all(t[2] not in BLOCKING or any(one(tol, t) for tol in tolerations) for t in taints)


class Columns:
    """The columns a tick scans: one per (pool, type the pool offers), the
    pools in weight order, types in catalog order. Read by common.admits
    as a catalog: allocatable [K, R] (scaled, float32, less the pool's
    reserve, rounded once), arch, zone|captype bits, the price tensor
    [K, Z, CT] (+inf where the pool does not offer), the decode order
    (columns by their cheapest offering, stable), each column's pool and
    type, and the capacity types each pool admits [P, CT]."""

    def __init__(self, catalog: Catalog, pools: Sequence[Pool]):
        self.zones = catalog.zones
        self.captypes = ct_ok = np.array([[not q.captype or c == q.captype for c in CAPTYPES]
                                          for q in pools])
        offered = np.isfinite(catalog.price)[None, :, :, :] & ct_ok[:, None, None, :]
        self.pool, self.type = np.nonzero(offered.any(axis=(2, 3)))
        self.K = len(self.type)
        self.price = np.where(ct_ok[self.pool][:, None, :], catalog.price[self.type],
                              F32(np.inf)).astype(F32)
        has = np.isfinite(self.price)
        self.tzc = bits(has.any(axis=2), has.any(axis=1))
        reserve = np.stack([q.reserve for q in pools])
        self.alloc = ((catalog.alloc64[self.type] - reserve[self.pool]) * SCALE).astype(F32)
        self.arch = catalog.arch[self.type]
        self.names = [catalog.names[k] for k in self.type]
        admitted = [tuple(CAPTYPES[i] for i in np.nonzero(row)[0]) for row in ct_ok]
        cheapest = np.array([min(o[3] for o in catalog.entries[k]["offerings"]
                                 if o[0] in admitted[q])
                             for q, k in zip(self.pool, self.type)])
        self.order = np.argsort(cheapest, kind="stable")


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


def envelope_key(pc: PodClass, pool: Pool) -> tuple:
    """The class's requirements with the pool's merged in: requests,
    node selector (the pool's capacity type added; a contradiction kept
    as both values), tolerations."""
    selector = dict(pc.selector)
    if pool.captype:
        ct = selector.get(CAPACITY_TYPE_LABEL, pool.captype)
        selector[CAPACITY_TYPE_LABEL] = pool.captype if ct == pool.captype else (ct, pool.captype)
    return (tuple(pc.req.tolist()), tuple(sorted(selector.items())), pc.tolerations)


def envelopes(classes: Sequence[PodClass], opening: Sequence[int],
              pools: Sequence[Pool]) -> np.ndarray:
    """Price-envelope pod counts. Keyed by (opening pool, class key under
    it): the first class of a key counts in the pods of every later class
    whose key under that pool coincides (-(1 + those pods)), and a later
    class of the same key and pool is pinned to the whole from the first
    on; -1 is the class's own remaining pods. On one pool without
    requirements of its own, classes coincide only if they are the same
    class, so every envelope is -1."""
    env = np.full((len(classes),), -1, dtype=np.int64)
    keys_under: Dict[int, list] = {}
    first: Dict[tuple, int] = {}
    for c in range(len(classes)):
        q = opening[c]
        if q < 0:
            continue
        if q not in keys_under:
            keys_under[q] = [envelope_key(pc, pools[q]) for pc in classes]
        keys = keys_under[q]
        f = first.get((q, keys[c]))
        if f is None:
            first[(q, keys[c])] = c
            tail = sum(len(classes[j].pods) for j in range(c + 1, len(classes)) if keys[j] == keys[c])
            if tail:
                env[c] = -(1 + tail)
        else:
            env[c] = sum(len(classes[j].pods) for j in range(f, len(classes)) if keys[j] == keys[c])
    return env


def tick(catalog: Catalog, classes: Sequence[PodClass], *, g_max: int, objective: str = "price",
         pools: Optional[Sequence[Pool]] = None, placed: Optional[np.ndarray] = None,
         precision: Precision = Precision(), joined: Optional[list] = None) -> dict:
    """The new nodes for `classes` over `pools` in weight order (one pool
    without requirements or reserve when None), after `placed[c]` pods of
    class c went to existing nodes. `joined`, when given, gets for each
    class step the (open node, column) pairs that join, the nodes open
    before it and whether the class has a column: the scan's work, for the
    roofline counts."""
    p = precision
    pools = list(pools) if pools else [Pool("")]
    cols = Columns(catalog, pools)
    C, K = len(classes), cols.K
    cap = p.q(np.maximum(cols.alloc, F32(0)))
    placed = np.zeros((C,), dtype=np.int64) if placed is None else placed
    # what a class may use and where it opens depend on the class alone
    compat_all, azc_all, price_all, n_fresh_all, opening = [], [], [], [], []
    for pc in classes:
        compat, azone, acap = admits(pc, cols)
        tolerated = np.array([tolerates(pc.tolerations, q.taints) for q in pools])
        compat = compat & tolerated[cols.pool]
        n_fresh = np.where(compat, fit_counts(cap, np.zeros((1, cap.shape[1]), F32),
                                              p.q(pc.req), p)[0], F32(0))
        room = compat & (n_fresh >= 1)
        opening.append(next((qi for qi, q in enumerate(pools)
                             if q.admits(pc) and room[cols.pool == qi].any()), -1))
        azc_all.append((azone, acap))
        compat_all.append(compat)
        n_fresh_all.append(n_fresh)
        price_all.append(p.q(np.where(
            compat, cols.price[:, azone][:, :, acap].min(axis=(1, 2), initial=np.inf),
            np.inf).astype(F32)))
    G = g_max
    accum = np.zeros((G, cap.shape[1]), dtype=F32)
    gmask = np.zeros((G, K), dtype=bool)
    gzc = np.zeros((G,), dtype=np.int64)
    gpool = np.zeros((G,), dtype=np.int64)
    take = np.zeros((C, G), dtype=np.int64)
    unplaced = np.zeros((C,), dtype=np.int64)
    env_all = envelopes(classes, opening, pools)
    n_open = 0
    for c, pc in enumerate(classes):
        compat, n_fresh, price = compat_all[c], n_fresh_all[c], price_all[c]
        azone, acap = azc_all[c]
        azc = bits(azone, acap)
        req = p.q(pc.req)
        count = len(pc.pods) - int(placed[c])
        env = int(env_all[c])
        # the open nodes first, in any pool
        n = n_open
        gzc_new = gzc[:n] & azc
        m = gmask[:n] & compat[None, :] & joint_ok(gzc_new[:, None] & cols.tzc[None, :])
        if joined is not None:
            joined.append((int(m.sum()), n, bool(compat.any())))
        n_fit = fit_counts(cap, accum[:n], req, p)
        n_grp = to_i(np.where(m, n_fit, F32(0)).max(axis=1, initial=F32(0)))
        cum_before = np.cumsum(n_grp) - n_grp
        t_old = np.minimum(np.maximum(count - cum_before, 0), n_grp)
        leftover = count - int(t_old.sum())
        # then fresh nodes, in the opening pool only
        q = opening[c]
        fresh = compat & (cols.pool == q)
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
        if n_new:
            gzc[new] = bits(azone, acap & cols.captypes[q])
            gpool[new] = q
        take[c, :n] = t_old
        take[c, new] = t_new
        n_open += n_new
    out = decode(cols, classes, take, unplaced, n_open, gmask, gzc, placed,
                 [pools[q].name for q in gpool])
    out["columns"] = K
    return out


def decode(cols: Columns, classes, take, unplaced, n_open, gmask, gzc, placed, pool_of) -> dict:
    """The decision in plain form: `nodes` as (type names cheapest first,
    pod names, zones, capacity types), the `pools` they open in (node slot
    g in pool_of[g]), `unschedulable` pod names."""
    nodes, node_pools = [], []
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
        types = [cols.names[k] for k in cols.order if gmask[g, k]]
        if not types:
            unsched.extend(pods)
            continue
        zones = frozenset(z for i, z in enumerate(cols.zones) if gzc[g] >> i & 1)
        captypes = frozenset(ct for i, ct in enumerate(CAPTYPES) if gzc[g] >> (8 + i) & 1)
        nodes.append((tuple(types), tuple(pods), zones, captypes))
        node_pools.append(pool_of[g])
    for c in np.nonzero(unplaced > 0)[0]:
        unsched.extend(classes[c].pods[offset[c]: offset[c] + int(unplaced[c])])
    return {"nodes": nodes, "pools": node_pools, "unschedulable": sorted(unsched),
            "n_open": n_open}


def node_price(catalog: Catalog, node, captype: str = "") -> float:
    """$/h of the node a decision launches: the cheapest offering of its
    first type in a zone and capacity type it admits, of its pool's
    capacity type `captype` ("" for any)."""
    types, _, zones, captypes = node
    k = catalog.names.index(types[0])
    offers = [o[3] for o in catalog.entries[k]["offerings"]
              if o[1] in zones and o[0] in captypes and captype in ("", o[0])]
    return min(offers) if offers else float("inf")


def pack_existing(classes: Sequence[PodClass], nodes: Sequence[dict],
                  precision: Precision = Precision(), walked: Optional[list] = None):
    """First fit of each class's pods onto the standing nodes, in class
    order and node order, before any new node opens: (pod -> node name,
    pods placed of each class). `walked`, when given, gets the repack's
    (nodes walked [1, C], members [1, C], nodes)."""
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


def compare(catalog: Catalog, got: dict, want: dict, n_pods: int,
            pools: Sequence[Pool] = ()) -> Dict[str, float]:
    """The numbers a provisioning check holds at 0: pods placed on another
    standing node; new nodes that differ in position, pool, type list,
    pods, zones or capacity types; pods not decided exactly once; the
    relative gap of the fleet's price, each node priced in its pool."""
    g, w = got["nodes"], want["nodes"]
    g_pools = got.get("pools") or [None] * len(g)
    w_pools = want.get("pools") or [None] * len(w)
    nodes_diff = sum(1 for a, b, pa, pb in zip(g, w, g_pools, w_pools) if a != b or pa != pb)
    nodes_diff += abs(len(g) - len(w))
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
    captype = {q.name: q.captype for q in pools}
    price_g = sum(node_price(catalog, n, captype.get(q, "")) for n, q in zip(g, g_pools))
    price_w = sum(node_price(catalog, n, captype.get(q, "")) for n, q in zip(w, w_pools))
    gap = abs(price_g - price_w) / price_w if price_w else float(price_g != price_w)
    return {"existing_differ": float(existing_diff), "nodes_differ": float(nodes_diff),
            "pods_not_once": float(pods_off), "price_gap": float(gap)}
