"""The consolidation kernels' entries: the repack and the replacement search.

Counterpart of karpenter_tpu/solver/disrupt/kernel.py:

- ``disrupt_repack``: the repack simulation over candidate sets, carried
  by kernel B (solver/kernels/disrupt_repack.py). The provisioning solve
  calls it with one candidate set to pack pending pods onto existing
  nodes, and reads the per-node placements.
- ``disrupt_repack_leftover``: its leftovers alone, the same kernel with
  no [S, C, N] placements allocated or written: the consolidation
  engine (engine.py), the mesh, the sidecar's ``solve_disrupt`` op, one
  set per candidate.
- ``disrupt_replace``: the one-new-node replacement search, a masked min
  over the (type, zone, captype) price tensor. It is a jit entry of the
  JAX package, not a Pallas kernel, so it is plain torch code here; the
  daemonset overhead is subtracted inside it, as there.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from karpenter_tpu_torch.solver.kernels import disrupt_repack as repack_kernel

# calls of disrupt_replace by this process (a plain count: chip_smoke.py
# zeroes it before a sweep and reads it after)
replace_calls = 0


def disrupt_repack(
    headroom0: torch.Tensor,   # [N, R] f32 remaining capacity of surviving nodes
    feas: torch.Tensor,        # [C, N] bool class-on-node feasibility
    req: torch.Tensor,         # [C, R] f32 per-pod request (includes pods=1)
    member: torch.Tensor,      # [S, C] i32 pods of class c in candidate set s
    excl: torch.Tensor,        # [S, N] bool node n is being deleted by set s
) -> Tuple[torch.Tensor, torch.Tensor]:
    """([S, C] i32 leftovers, [S, C, N] i32 per-node placements): pods of
    class c in set s packed first-fit onto the surviving nodes (node
    order = oracle order); leftover did not fit anywhere."""
    return repack_kernel.disrupt_repack(headroom0, feas, req, member, excl)


def disrupt_repack_leftover(
    headroom0: torch.Tensor,   # [N, R] f32
    feas: torch.Tensor,        # [C, N] bool
    req: torch.Tensor,         # [C, R] f32
    member: torch.Tensor,      # [S, C] i32
    excl: torch.Tensor,        # [S, N] bool
) -> torch.Tensor:
    """[S, C] i32 leftovers of `disrupt_repack` (the sweep reads only
    these): no [S, C, N] placements are allocated."""
    return repack_kernel.disrupt_repack_leftover(headroom0, feas, req, member, excl)


def repack_from_numpy(headroom0, feas, req, member, excl, device,
                      hold: Optional[list] = None) -> Tuple[torch.Tensor, ...]:
    """The repack's five operands, as the JAX entry takes them (numpy
    arrays), moved to `device` in the dtypes kernel B takes. To the card
    they stage through page-locked buffers (`ffd._to_device`; `hold`
    keeps them until the caller's barrier), so no copy waits on the
    host."""
    from karpenter_tpu_torch.solver import ffd

    def put(a, dtype):
        return ffd._to_device(np.asarray(a, dtype=dtype), device, hold)

    return (
        put(headroom0, np.float32), put(feas, bool), put(req, np.float32),
        put(member, np.int32), put(excl, bool),
    )


def aggregate(leftover: torch.Tensor, req: torch.Tensor) -> torch.Tensor:
    """[S, R] f32: the summed request of each set's leftover pods.

    Accumulated in float64 and rounded once to float32. Each product of a
    pod count (an int32 far below 2^29) and a float32 request is exact in
    float64, so the result is the correctly rounded float32 of the exact
    sum unless float64's own rounding error (below C * 2^-53 relative)
    straddles a float32 rounding boundary; no order of a float32 sum comes
    closer. Where every partial sum is exact in float32 -- integer requests
    (cpu in millicores, memory in whole MiB) with sums under 2^24, every
    world of this repo -- it equals the JAX package's float32 einsum in any
    order, and the CPU and the card agree bit for bit."""
    return torch.matmul(leftover.to(torch.float64), req.to(torch.float64)).to(torch.float32)


def disrupt_replace(
    leftover: torch.Tensor,    # [S, C] i32
    req: torch.Tensor,         # [C, R] f32
    compat: torch.Tensor,      # [C, K] bool class-type compat (pool ctx included)
    azone: torch.Tensor,       # [C, Z] bool
    acap: torch.Tensor,        # [C, CT] bool
    cap: torch.Tensor,         # [K, R] f32 raw type capacity
    ovh: torch.Tensor,         # [R] f32 per-pool fresh-node daemonset reserve
    price: torch.Tensor,       # [K, Z, CT] f32 (+inf when unavailable)
    *,
    od_col: int,               # on-demand captype column (closed vocabulary)
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Cheapest single new node that absorbs every leftover pod of each set.
    Returns (best_price [S], best_od_price [S], best_type [S] i32, -1 none).
    A type qualifies iff it is compatible with every leftover class and its
    overhead-adjusted capacity covers the aggregate leftover request; the
    offering must sit in a zone/captype admitted by every leftover class.

    The JAX package's bool einsums ("any needed class violates") are
    counts of violators here, exact in float32 (at most C of them), tested
    against 0. Ties in the price go to the first (type, zone, captype) in
    row-major order, as jnp.argmin does; torch.argmin returns the first
    index too, on tied and on all-inf rows."""
    global replace_calls
    replace_calls += 1
    f32 = torch.float32
    cap_eff = torch.clamp_min(cap - ovh[None, :], 0.0)                    # [K, R]
    need = leftover > 0                                                   # [S, C]
    needf = need.to(f32)
    agg = aggregate(leftover, req)                                        # [S, R]
    ok_type = torch.matmul(needf, (~compat).to(f32)) == 0                 # [S, K] no violator
    fits = torch.all(cap_eff[None, :, :] >= agg[:, None, :], dim=-1)      # [S, K]
    ok_type = ok_type & fits & need.any(dim=-1)[:, None]
    zone_ok = torch.matmul(needf, (~azone).to(f32)) == 0                  # [S, Z]
    cap_ok = torch.matmul(needf, (~acap).to(f32)) == 0                    # [S, CT]
    masked = torch.where(
        ok_type[:, :, None, None] & zone_ok[:, None, :, None] & cap_ok[:, None, None, :],
        price[None, :, :, :],
        torch.inf,
    )                                                                     # [S, K, Z, CT]
    S, K, Z, CTn = masked.shape
    flat = masked.reshape(S, -1)
    best_price = flat.amin(dim=-1)
    best_type = torch.where(
        torch.isfinite(best_price),
        torch.div(torch.argmin(flat, dim=-1), Z * CTn, rounding_mode="floor").to(torch.int32),
        -1,
    ).to(torch.int32)
    best_od_price = masked[:, :, :, od_col].reshape(S, -1).amin(dim=-1)
    return best_price, best_od_price, best_type
