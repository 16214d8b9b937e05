"""The repack entry of the consolidation kernels.

Counterpart of karpenter_tpu/solver/disrupt/kernel.py `disrupt_repack`:
the repack simulation over candidate sets, carried by kernel B
(solver/kernels/disrupt_repack.py). The provisioning solve calls it with
one candidate set to pack pending pods onto existing nodes. The
one-new-node replacement search (`disrupt_replace`) belongs to the
consolidation slice.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from karpenter_tpu_torch.solver.kernels import disrupt_repack as repack_kernel


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


def repack_from_numpy(headroom0, feas, req, member, excl, device) -> Tuple[torch.Tensor, ...]:
    """The repack's five operands, as the JAX entry takes them (numpy
    arrays), moved to `device` in the dtypes kernel B takes."""
    def put(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(np.asarray(a, dtype=dtype))).to(device)

    return (
        put(headroom0, np.float32), put(feas, bool), put(req, np.float32),
        put(member, np.int32), put(excl, bool),
    )
