"""Fractional lower bound on hourly fleet price: the optimality-gap base.

Copy of karpenter_tpu/solver/bound.py in torch. The bound, per resource
axis r:

    rate[c, r] = min over feasible k of price_ck[c, k] / cap_eff[k, r]
    total[r]   = sum_c placed[c] * req[c, r] * rate[c, r]
    bound      = max_r total[r]

where ``cap_eff = max(cap - node_overhead, 0)`` and the feasible set of
class c is every type the solver could have placed c on: device compat
AND the join gate AND a finite admitted offering price AND >= 1 pod fits
an empty node. Each placed pod is billed the cheapest feasible price per
unit of its binding resource, so every real assignment pays at least the
bound (the soundness argument is in the JAX module's docstring).

``placed`` is the per-class count of pods the solve placed on new groups
(take-row sums). The [R] totals stay on the device until ``fetch_bound``,
the one host read; ``TorchSolver.solve_finish`` enqueues the bound before
decode and fetches it after. Observe-only: nothing downstream of a
decision reads it.

Each axis total is accumulated in float64 and rounded to float32 once:
the exact sum, the same on the CPU and on the card, within the last bit
of any float32 order (the JAX package's among them).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from karpenter_tpu_torch.solver import packing
from karpenter_tpu_torch.solver.ffd import (
    SolveInputs, _class_type_price, _device_compat, _fresh_fit_counts,
)


def feasible(inp: SolveInputs, word_offsets: Tuple[int, ...],
             words: Tuple[int, ...]) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(feas [C, K] bool, price_ck [C, K] f32, cap_eff [K, R] f32): the
    columns a class may pay for. The bound and the convex relaxation
    (convex/relax.py) share it, so they can never disagree about them."""
    K = inp.cap.shape[0]
    join_allowed = packing.as_bool_mask(inp.join_allowed, K)
    compat = _device_compat(inp, word_offsets, words) & join_allowed   # [C, K]
    cap_eff = torch.clamp_min(inp.cap - inp.node_overhead[None, :], 0.0)  # [K, R]
    price_ck, _ = _class_type_price(inp)                               # [C, K]
    feas = compat & torch.isfinite(price_ck) & (
        _fresh_fit_counts(cap_eff, inp.req) >= 1.0)
    return feas, price_ck, cap_eff


def class_rates(inp: SolveInputs, word_offsets: Tuple[int, ...],
                words: Tuple[int, ...]) -> torch.Tensor:
    """[R, C] f32: each class's cheapest feasible price per unit of axis
    r over `inp`'s type columns (+inf when none). A minimum over column
    blocks is the minimum over all columns, so a mesh shard computes it
    for its own columns and the combine takes the minimum
    (parallel/mesh.py)."""
    feas, price_ck, cap_eff = feasible(inp, word_offsets, words)
    best = []
    # R-unrolled, as the JAX entry: R separate [C, K] passes
    for r in range(inp.cap.shape[1]):
        capr = cap_eff[None, :, r]                                     # [1, K]
        rate = torch.where(feas & (capr > 0.0), price_ck / capr, torch.inf)
        best.append(torch.amin(rate, dim=-1))                          # [C]
    return torch.stack(best)


def totals_from_rates(best: torch.Tensor, req: torch.Tensor, placed: torch.Tensor) -> torch.Tensor:
    """The [R] totals from the [R, C] class rates: each axis summed in
    float64 and rounded to float32 once."""
    placed_f = placed.to(torch.float32)                                # [C]
    totals = []
    for r in range(best.shape[0]):
        # a class with no finite rate on axis r contributes nothing --
        # where() guards inf * 0 = nan
        contrib = torch.where(torch.isfinite(best[r]), best[r], 0.0) * req[:, r] * placed_f
        totals.append(contrib.sum(dtype=torch.float64))
    return torch.stack(totals).to(torch.float32)                       # [R]


def fractional_price_bound(
    inp: SolveInputs, placed: torch.Tensor, *,
    word_offsets: Tuple[int, ...], words: Tuple[int, ...],
) -> torch.Tensor:
    """The [R] per-resource fractional price totals ($/h) on the
    device; the bound is their max, taken on the host so the binding
    resource comes from the same fetch."""
    return totals_from_rates(class_rates(inp, word_offsets, words), inp.req, placed)


def fetch_bound(totals: torch.Tensor) -> Tuple[float, int]:
    """The bound's one host read: (bound $/h, binding resource axis),
    the first axis on ties, as np.argmax."""
    host = totals.cpu().numpy()
    r_star = int(np.argmax(host))
    return float(host[r_star]), r_star
