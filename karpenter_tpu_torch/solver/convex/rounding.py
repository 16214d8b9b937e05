"""Deterministic rounding of the LP relaxation to an integral placement.

Copy of karpenter_tpu/solver/convex/rounding.py (numpy, host-side). The
JAX package's chaos failpoint (``convex.rounding``) is left out: the port
has no failpoints yet. Bit-deterministic: no clock, no ambient RNG -- the
only tie-break draws a type permutation from the port's
``seeding.convex_rng()``, the same stream as the JAX package's.

Two stages:

1. **Concentrate** each fractional row x[c, :] onto ONE integral
   column: all count[c] pods of the class land on the type minimizing
   the amortized per-pod cost price_ck / fit0 (hourly price of a
   class-pure node over how many pods of the class fit on it empty).
   Ties in the amortized cost break toward the column carrying the
   larger LP mass x[c, k], then the seeded type permutation, so x enters
   the decision only through ties. Conservation sum_k n[c, k] ==
   count[c] is exact by construction.

2. **Pack** each type's pods into groups greedily: classes in
   descending dominant-request order, first-fit into open groups of
   that type (zone/captype mask intersection must stay nonempty AND
   keep a finite-price offering; capacity against cap_eff is exact --
   encode scales resources to small integers), a fresh group otherwise.

Returns the same dense decode tuple the FFD expansion produces --
``(take, unplaced, n_open, gmask, gzone, gcap)`` -- or None when the
result is invalid (group budget exceeded, a group lost its offerings,
conservation broke): the caller then keeps the FFD placement.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from karpenter_tpu_torch import seeding
from karpenter_tpu_torch.solver.convex import relax


def _finite_offering(price_k: np.ndarray, zone: np.ndarray, cap: np.ndarray) -> bool:
    """Does the (zone, captype) mask pair keep >= 1 finite-price
    offering of this type? price_k: [Z, CT]."""
    return bool(np.isfinite(price_k[np.ix_(zone, cap)]).any())


def assign_types(
    x: np.ndarray, feas: np.ndarray, count: np.ndarray, *,
    price_ck: np.ndarray, fit0: np.ndarray,
) -> np.ndarray:
    """[C, K] i64 concentration of each fractional row onto its best
    integral column (module docstring stage 1): row sums equal count on
    rows with a feasible column, 0 elsewhere. Deterministic: ties in
    the amortized cost break by larger LP mass x, then the seeded type
    permutation."""
    C, K = x.shape
    rng = seeding.convex_rng()
    perm = list(range(K))
    rng.shuffle(perm)
    perm = np.asarray(perm)
    xf = np.where(feas, np.maximum(np.asarray(x, dtype=np.float64), 0.0), 0.0)
    count = np.asarray(count, dtype=np.int64)
    # amortized per-pod cost of a class-pure node; infeasible or
    # zero-fit columns can never be chosen
    ok = feas & (fit0 >= 1) & np.isfinite(price_ck)
    with np.errstate(divide="ignore", invalid="ignore"):
        score = np.where(ok, price_ck / np.maximum(fit0, 1), np.inf)
    n = np.zeros((C, K), dtype=np.int64)
    for c in range(C):
        if count[c] <= 0 or not ok[c].any():
            continue
        k_star = min(
            (k for k in range(K) if ok[c, k]),
            key=lambda k: (score[c, k], -xf[c, k], perm[k]),
        )
        n[c, k_star] = count[c]
    return n


def round_solution(
    x: np.ndarray, catalog, classes, *, g_max: int,
) -> Optional[Tuple[np.ndarray, np.ndarray, int, np.ndarray, np.ndarray, np.ndarray]]:
    """Round against host-side encode tensors (CatalogTensors +
    PodClassSet) -- the in-process tier's entry point; ``round_arrays``
    takes the same arrays loose (the JAX sidecar's wire op calls it)."""
    feas, _, cap_eff = relax.host_feasibility(catalog, classes)
    return round_arrays(
        x, feas=feas, cap_eff=cap_eff, price=catalog.price,
        req=classes.req, count=classes.count, azone=classes.azone,
        acap=classes.acap, tzone=catalog.tzone, tcap=catalog.tcap,
        g_max=g_max,
    )


def round_arrays(
    x: np.ndarray, *, feas: np.ndarray, cap_eff: np.ndarray,
    price: np.ndarray, req: np.ndarray, count: np.ndarray,
    azone: np.ndarray, acap: np.ndarray, tzone: np.ndarray,
    tcap: np.ndarray, g_max: int,
) -> Optional[Tuple[np.ndarray, np.ndarray, int, np.ndarray, np.ndarray, np.ndarray]]:
    """Round the fetched fractional assignment to the dense decode tuple
    (take [C, G] i32, unplaced [C] i32, n_open, gmask [G, K] bool,
    gzone [G, Z] bool, gcap [G, CT] bool), or None when rounding cannot
    produce a valid placement inside the g_max group budget (the FFD
    fallback rung)."""
    feas = np.asarray(feas, dtype=bool)
    C, K = feas.shape
    cap_eff = np.asarray(cap_eff, dtype=np.float64)
    Z = np.asarray(tzone).shape[1]
    CTn = np.asarray(tcap).shape[1]
    req = np.asarray(req, dtype=np.float64)                            # [C, R]
    count = np.asarray(count, dtype=np.int64)
    azone = np.asarray(azone, dtype=bool)
    acap = np.asarray(acap, dtype=bool)
    tzone = np.asarray(tzone, dtype=bool)
    tcap = np.asarray(tcap, dtype=bool)
    price = np.asarray(price, dtype=np.float64)                        # [K, Z, CT]

    # cheapest allowed offering per (class, type): the class's zone and
    # capacity-type masks select the offering slice, exactly the price
    # the relaxation priced the column at
    pz = np.where(azone[:, None, :, None], price[None], np.inf)        # [C, K, Z, CT]
    price_ck = np.where(
        acap[:, None, None, :], pz, np.inf).min(axis=(2, 3))           # [C, K]
    # pods of class c on an EMPTY node of type k (floor over axes the
    # class actually requests)
    with np.errstate(divide="ignore", invalid="ignore"):
        ratio = np.where(
            req[:, None, :] > 0.0,
            np.floor(cap_eff[None, :, :] / np.maximum(req[:, None, :], 1e-30)),
            np.inf,
        )                                                              # [C, K, R]
    fit0 = np.where(np.isfinite(ratio).any(axis=-1),
                    ratio.min(axis=-1), float(1 << 30)).astype(np.int64)

    n = assign_types(np.asarray(x, dtype=np.float64), feas, count,
                     price_ck=price_ck, fit0=fit0)

    take = np.zeros((C, g_max), dtype=np.int32)
    gmask = np.zeros((g_max, K), dtype=bool)
    gzone = np.zeros((g_max, Z), dtype=bool)
    gcap = np.zeros((g_max, CTn), dtype=bool)
    accum = np.zeros((g_max, cap_eff.shape[1]), dtype=np.float64)
    gtype = np.full(g_max, -1, dtype=np.int64)
    n_open = 0

    # descending dominant request, class index as the deterministic tie
    class_order = sorted(range(C), key=lambda c: (-float(req[c].max()), c))

    def fit_in(k: int, acc: np.ndarray, r: np.ndarray) -> int:
        m = np.inf
        for ax in range(r.shape[0]):
            if r[ax] > 0.0:
                m = min(m, np.floor((cap_eff[k, ax] - acc[ax]) / r[ax]))
        return int(max(m, 0.0)) if np.isfinite(m) else 1 << 30

    for k in range(K):
        col = n[:, k]
        if not col.any():
            continue
        first_g = n_open
        for c in class_order:
            m = int(col[c])
            if m <= 0:
                continue
            # first-fit into this type's open groups, batched by fit count
            for g in range(first_g, n_open):
                if m <= 0:
                    break
                nz = gzone[g] & azone[c]
                nc = gcap[g] & acap[c]
                if not nz.any() or not nc.any():
                    continue
                if not _finite_offering(price[k], nz, nc):
                    continue
                fit = fit_in(k, accum[g], req[c])
                if fit < 1:
                    continue
                t = min(m, fit)
                take[c, g] += t
                accum[g] += t * req[c]
                gzone[g] = nz
                gcap[g] = nc
                m -= t
            # fresh groups for the remainder
            while m > 0:
                if n_open >= g_max:
                    return None
                g = n_open
                n_open += 1
                gtype[g] = k
                gmask[g, k] = True
                gzone[g] = tzone[k] & azone[c]
                gcap[g] = tcap[k] & acap[c]
                fit = fit_in(k, accum[g], req[c])
                if fit < 1 or not _finite_offering(price[k], gzone[g], gcap[g]):
                    # feasibility said >= 1 fits an empty node; disagreeing
                    # here means the inputs drifted -- fall back, never guess
                    return None
                t = min(m, fit)
                take[c, g] = t
                accum[g] += t * req[c]
                m -= t

    placed = take.sum(axis=1)
    unplaced = (count - placed).astype(np.int32)
    if (unplaced < 0).any():
        return None
    for g in range(n_open):
        if not gzone[g].any() or not gcap[g].any():
            return None
        if not _finite_offering(price[gtype[g]], gzone[g], gcap[g]):
            return None
    return take, unplaced, int(n_open), gmask, gzone, gcap
