"""LP relaxation of the pod-class -> instance-type solve, on the device.

Copy of karpenter_tpu/solver/convex/relax.py in torch. With
``price_ck[c, k]`` the cheapest admitted offering of type k for class c,
``cap_eff = max(cap - node_overhead, 0)`` and per-axis weights

    w[c, k, r] = price_ck[c, k] * req[c, r] / cap_eff[k, r]

the objective is

    f(x) = sum_k max_r ( sum_c x[c, k] * w[c, k, r] )

over the per-class masked simplices  X = { x >= 0, x[~feas] = 0,
sum_k x[c, k] = count[c] }, ``feas`` being bound.py's feasible set
(`bound.feasible`, shared). min_X f is at most the realized price of any
integral placement, and at least the fractional bound, so its lower
bound can only tighten the optimality gap.

Solved by a fixed number of projected-subgradient steps: the [K, R]
per-type loads are one [K, C] x [C, R] matrix product (the [C, K, R]
weight tensor is never built), the subgradient g[c, k] = w[c, k, r*_k]
takes each type's argmax axis, and the projection onto each row's masked
scaled simplex is the sort-based algorithm over all rows at once. f is
positively homogeneous, so every iterate certifies the lower bound

    LB = sum_c count[c] * min over feasible k of g[c, k]

and the loop keeps the best. The JAX entry's `fori_loop` is a Python
loop of `iters` steps here, every step enqueued on the device with no
host read; ``fetch_relax`` is the one read.

Every sum (the load product, the objective, the certificate, the step
norms, the projection's prefix sums) is accumulated in float64 and
rounded to float32 once: the exact sum, the same on the CPU and on the
card, within the last bit of any float32 order.

`reference_relax` is the JAX module's numpy float64 reference, copied
whole: the repack oracle (solver/convex/repack.py, the disruption
controller's stage 6 under a convex solver) relaxes on the host with it.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from karpenter_tpu_torch.solver import packing
from karpenter_tpu_torch.solver.bound import feasible

# finite stand-in for -inf in the sort-based projection: a true -inf
# poisons the prefix sum, a finite sentinel keeps every threshold test
# exact for the feasible prefix and lands masked lanes at max(sentinel -
# theta, 0) = 0
_NEG = float(np.float32(-1e30))

# the fixed iteration budget (the JAX package's): the corpus converges
# (objective within 0.1% of final) in < 32 iterations at every tier
DEFAULT_ITERS = 48

_F64 = torch.float64


class RelaxOutputs(NamedTuple):
    x: torch.Tensor        # [C, K] f32 fractional assignment
    lower: torch.Tensor    # scalar f32 best certified lower bound ($/h)
    trace: torch.Tensor    # [iters] f32 objective per iteration
    feas: torch.Tensor     # [C, K] bool feasible set


def _sum(t: torch.Tensor, dim=None) -> torch.Tensor:
    """A float32 sum accumulated in float64 and rounded once."""
    s = t.sum(dtype=_F64) if dim is None else t.sum(dim=dim, dtype=_F64)
    return s.to(torch.float32)


def _project_rows(v: torch.Tensor, feas: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """Euclidean projection of each row of v onto its masked scaled
    simplex {x >= 0 on feas, sum x = a[c]} -- the sort-based algorithm
    over all rows at once. Rows with a == 0 or no feasible column
    project to zero."""
    v = torch.where(feas, v, _NEG)
    u = -torch.sort(-v, dim=-1).values                                 # desc
    K = v.shape[1]
    j = torch.arange(1, K + 1, dtype=torch.float32, device=v.device)[None, :]
    cssv = torch.cumsum(u, dim=-1, dtype=_F64).to(torch.float32) - a[:, None]
    cond = u - cssv / j > 0.0                                          # prefix-true
    rho = cond.sum(dim=-1, dtype=torch.int32)                          # [C] >= 1
    rho_i = torch.clamp_min(rho - 1, 0).to(torch.int64)
    theta = torch.gather(cssv, -1, rho_i[:, None])[:, 0] / torch.clamp_min(
        rho.to(torch.float32), 1.0)
    x = torch.clamp_min(v - theta[:, None], 0.0)
    live = feas & (a[:, None] > 0.0) & feas.any(dim=-1)[:, None]
    return torch.where(live, x, 0.0)


def convex_relax(
    inp, *, iters: int, word_offsets: Tuple[int, ...], words: Tuple[int, ...],
) -> RelaxOutputs:
    """`iters` projected-subgradient steps on the device (the port's
    SolveInputs); returns device tensors."""
    feas, price_ck, cap_eff = feasible(inp, word_offsets, words)
    row_ok = feas.any(dim=-1)                                          # [C]
    a = torch.where(row_ok, inp.count.to(torch.float32), 0.0)
    # masked price: feasible columns only; inf * 0 in the load product
    # would otherwise nan the whole type column
    price_m = torch.where(feas, price_ck, 0.0)                         # [C, K]
    nfeas = torch.clamp_min(feas.sum(dim=-1).to(torch.float32), 1.0)
    x = torch.where(feas, (a / nfeas)[:, None], 0.0)                   # uniform start
    # per-axis inverse effective capacity, guarded: feasibility ensures
    # load > 0 only where cap_eff > 0
    inv_cap = torch.where(cap_eff > 0.0, 1.0 / torch.clamp_min(cap_eff, 1e-30), 0.0)
    req64 = inp.req.to(_F64)
    k_idx = torch.arange(inv_cap.shape[0], dtype=torch.int64, device=inv_cap.device)
    best_lb = torch.zeros((), dtype=torch.float32, device=x.device)
    trace = []
    for t in range(iters):
        # load[k, r] = sum_c x * price_ck * req / cap_eff: one [K, C] x
        # [C, R] product (never a [C, K, R] temporary)
        p = x * price_m                                                # [C, K]
        load = torch.matmul(p.to(_F64).T, req64).to(torch.float32) * inv_cap  # [K, R]
        m, r_star = torch.max(load, dim=-1)                            # first max
        trace.append(_sum(m))
        g = price_m * inp.req[:, r_star] * inv_cap[k_idx, r_star][None, :]
        # anytime certificate: f homogeneous => <g, x> = f(x) and
        # f(y) >= <g, y> on all of X, so min_X f >= sum_c a_c min_k g
        g_min = torch.amin(torch.where(feas, g, torch.inf), dim=-1)
        best_lb = torch.maximum(best_lb, _sum(a * torch.where(row_ok, g_min, 0.0)))
        # diminishing normalized step over each row's simplex radius
        gnorm = torch.sqrt(_sum(torch.where(feas, g, 0.0) ** 2, dim=-1)) + 1e-12
        eta = (a + 1.0) / (gnorm * float(np.sqrt(np.float32(t + 1.0))))
        x = _project_rows(x - eta[:, None] * g, feas, a)
    return RelaxOutputs(x=x, lower=best_lb, trace=torch.stack(trace), feas=feas)


def fetch_relax(out: RelaxOutputs):
    """The convex tier's one host read: (x [C, K] f64, lower-bound $/h,
    objective trace [iters] f64)."""
    x = out.x.cpu().numpy().astype(np.float64)
    lower = float(out.lower)
    trace = out.trace.cpu().numpy().astype(np.float64)
    return x, lower, trace


def iterations_to_convergence(trace: np.ndarray, rtol: float = 1e-3) -> int:
    """First iteration whose objective is within rtol of the final one."""
    trace = np.asarray(trace, dtype=np.float64)
    if trace.size == 0:
        return 0
    final = trace[-1]
    tol = abs(final) * rtol + 1e-12
    for t in range(trace.size):
        if np.all(np.abs(trace[t:] - final) <= tol):
            return t + 1
    return int(trace.size)


def host_feasibility(catalog, classes):
    """(feas [C, K] bool, price_ck [C, K] f64, cap_eff [K, R] f64): the
    host/numpy mirror of `bound.feasible` over the unstaged tensors
    (encode.CatalogTensors + PodClassSet), which the rounding uses."""
    from karpenter_tpu_torch.solver import encode

    compat = encode.compat_matrix(catalog, classes)                    # [C, K]
    join = getattr(classes, "join_allowed", None)
    if join is not None:
        if packing.is_packed(join):
            join = packing.unpack_mask(join, catalog.k_pad)
        compat = compat & join
    cap_eff = np.maximum(
        catalog.cap - classes.node_overhead[None, :], 0.0
    ).astype(np.float64)                                               # [K, R]
    C, K = compat.shape
    price_ck = np.full((C, K), np.inf, dtype=np.float64)
    Z = catalog.tzone.shape[1]
    CTn = catalog.tcap.shape[1]
    for z in range(Z):
        for ct in range(CTn):
            m = classes.azone[:, z] & classes.acap[:, ct]              # [C]
            cand = np.where(m[:, None], catalog.price[None, :, z, ct], np.inf)
            price_ck = np.minimum(price_ck, cand)
    req = classes.req.astype(np.float64)                               # [C, R]
    fits = np.ones((C, K), dtype=bool)
    for r in range(cap_eff.shape[1]):
        need = req[:, r][:, None]
        with np.errstate(divide="ignore", invalid="ignore"):
            n = np.floor(cap_eff[None, :, r] / np.where(need > 0, need, 1.0))
        fits &= np.where(need > 0, n >= 1.0, True)
    return compat & np.isfinite(price_ck) & fits, price_ck, cap_eff


def reference_relax(catalog, classes, iters: int = DEFAULT_ITERS):
    """Host/numpy float64 reference of the projected-subgradient solve
    over the UNstaged tensors (encode.CatalogTensors + PodClassSet) --
    the oracle the device entry is differentially pinned against
    (tests/test_convex.py). Same formulation, same iteration schedule,
    float64 accumulation. Returns (x [C, K], lower_bound, trace)."""
    feas, price_ck, cap_eff = host_feasibility(catalog, classes)
    C, K = feas.shape
    req = classes.req.astype(np.float64)                               # [C, R]
    row_ok = feas.any(axis=-1)
    a = np.where(row_ok, np.asarray(classes.count, dtype=np.float64), 0.0)
    price_m = np.where(feas, price_ck, 0.0)
    with np.errstate(divide="ignore"):
        inv_cap = np.where(cap_eff > 0.0, 1.0 / np.maximum(cap_eff, 1e-300), 0.0)
    nfeas = np.maximum(feas.sum(axis=-1).astype(np.float64), 1.0)
    x = np.where(feas, (a / nfeas)[:, None], 0.0)

    def obj_grad(x):
        load = ((x * price_m).T @ req) * inv_cap                       # [K, R]
        m = load.max(axis=-1)
        r_star = load.argmax(axis=-1)
        g = price_m * req[:, r_star] * inv_cap[np.arange(K), r_star][None, :]
        return float(m.sum()), g

    def project(v):
        v = np.where(feas, v, -1e300)
        u = -np.sort(-v, axis=-1)
        j = np.arange(1, K + 1, dtype=np.float64)[None, :]
        cssv = np.cumsum(u, axis=-1) - a[:, None]
        cond = u - cssv / j > 0.0
        rho = np.maximum(cond.sum(axis=-1), 1)
        theta = cssv[np.arange(C), rho - 1] / rho
        out = np.maximum(v - theta[:, None], 0.0)
        live = feas & (a[:, None] > 0.0) & row_ok[:, None]
        return np.where(live, out, 0.0)

    best_lb = 0.0
    trace = np.zeros((iters,), dtype=np.float64)
    for t in range(iters):
        f, g = obj_grad(x)
        g_lb = np.where(feas, g, np.inf)
        lb = float((a * np.where(row_ok, g_lb.min(axis=-1), 0.0)).sum())
        best_lb = max(best_lb, lb)
        trace[t] = f
        gnorm = np.sqrt((np.where(feas, g, 0.0) ** 2).sum(axis=-1)) + 1e-12
        eta = (a + 1.0) / (gnorm * np.sqrt(t + 1.0))
        x = project(x - eta[:, None] * g)
    return x, best_lb, trace
