"""Differential selection between the FFD and convex candidates.

Copy of karpenter_tpu/solver/convex/tier.py, verbatim.

The convex tier's safety contract is NEVER-WORSE: both candidate
placements are priced identically host-side (cheapest surviving
offering per group -- the same min the decode's select_offerings
computes) and the rounded convex placement is taken only when it
strictly beats FFD on fleet price WITHOUT leaving more pods behind
(per class, not just in total: trading class A's placement for class
B's would silently reshuffle who pends). Ties go to FFD -- the
incumbent stays unless the challenger pays for the switch, which is
what makes a pure-FFD tick and a convex tick with a losing candidate
bit-identical.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def dense_price(dense, price: np.ndarray) -> float:
    """Hourly fleet price of a dense decode tuple: per open group, the
    cheapest offering surviving its (type, zone, captype) masks.
    price: [K, Z, CT] (+inf when unavailable)."""
    take, unplaced, n_open, gmask, gzone, gcap = dense
    price = np.asarray(price, dtype=np.float64)
    total = 0.0
    for g in range(int(n_open)):
        cell = price[np.ix_(gmask[g], gzone[g], gcap[g])]
        total += float(cell.min()) if cell.size else float("inf")
    return total


def choose(
    dense_ffd, dense_cx: Optional[tuple], price: np.ndarray,
) -> Tuple[str, tuple, float, float]:
    """(winner, chosen dense tuple, ffd price, convex price). The convex
    candidate wins only on a strict price improvement with per-class
    unplaced counts no worse than FFD's; every other outcome -- rounding
    returned None, a tie, a worse price, more pods left behind -- is the
    FFD rung."""
    p_ffd = dense_price(dense_ffd, price)
    if dense_cx is None:
        return "ffd", dense_ffd, p_ffd, float("inf")
    p_cx = dense_price(dense_cx, price)
    un_ffd = np.asarray(dense_ffd[1], dtype=np.int64)
    un_cx = np.asarray(dense_cx[1], dtype=np.int64)
    if np.any(un_cx > un_ffd):
        return "ffd", dense_ffd, p_ffd, p_cx
    if not (np.isfinite(p_cx) and p_cx < p_ffd):
        return "ffd", dense_ffd, p_ffd, p_cx
    return "convex", dense_cx, p_ffd, p_cx
