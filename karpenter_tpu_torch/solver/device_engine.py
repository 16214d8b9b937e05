"""DeviceEngine: every kernel entry's dispatch on one device.

The single-device back end of TorchSolver (solver/service.py), the
sidecar (solver/rpc.py), the sweep's local route (solver/disrupt/
engine.py) and the mesh engine's unsharded rung (fleet/shard.py). Its
dispatch surface is ``MeshSolveEngine``'s, name for name and parameter
for parameter; ``convex_relax`` is the one entry no mesh shards. Each
method enqueues on ``device`` (``refetch_dense`` reads inside the
sanctioned ``ffd.solve_dense_tuple``) and looks its entry up on the
module at call time, so a patched entry is the one that runs.
``epoch`` is always None: one device has no topology to go stale.

``aot`` is TorchSolver's AotManager (solver/aot.py), None until
``enable_aot``: the fused solve, the bound, kernel B's full entry and the
convex relaxation replay an armed CUDA graph when one matches, else take
the ordinary dispatch; ``replayed`` says whether the last of those
calls replayed a graph, read under the caller's dispatch lock.
"""
from __future__ import annotations

import numpy as np
import torch

from karpenter_tpu_torch.solver import bound, ffd
from karpenter_tpu_torch.solver.convex import relax
from karpenter_tpu_torch.solver.disrupt import kernel as disrupt_kernel


class DeviceEngine:
    epoch = None

    def __init__(self, device):
        self.device = torch.device(device)
        self.aot = None
        self.replayed = False

    def stage_catalog_versioned(self, catalog):
        """ffd.stage_catalog on this device, with its None stamp."""
        return (*ffd.stage_catalog(catalog, self.device), None)

    def solve_fused(self, inp: ffd.SolveInputs, *, g_max: int, nnz_max: int, word_offsets,
                    words, objective: str = "price", epoch=None) -> torch.Tensor:
        statics = dict(g_max=g_max, nnz_max=nnz_max, word_offsets=word_offsets, words=words,
                       objective=objective)
        hit, out = (False, None) if self.aot is None else self.aot.try_call(
            "ffd_solve_fused", (inp,), statics)
        self.replayed = hit
        return out if hit else ffd.ffd_solve_fused(inp, **statics)

    def solve_compact(self, inp: ffd.SolveInputs, *, g_max: int, nnz_max: int, word_offsets,
                      words, objective: str = "price", epoch=None) -> ffd.CompactDecision:
        return ffd.ffd_solve_compact(inp, g_max=g_max, nnz_max=nnz_max,
                                     word_offsets=word_offsets, words=words, objective=objective)

    def solve_dense(self, inp: ffd.SolveInputs, *, g_max: int, word_offsets, words,
                    objective: str = "price", epoch=None) -> ffd.SolveOutputs:
        return ffd.ffd_solve(inp, g_max=g_max, word_offsets=word_offsets, words=words,
                             objective=objective)

    def refetch_dense(self, inp: ffd.SolveInputs, *, g_max: int, word_offsets, words,
                      objective: str = "price", epoch=None) -> tuple:
        """The dense decision fetched as the decode tuple: the refetch
        when a fused buffer's sparse take overflowed its budget."""
        return ffd.solve_dense_tuple(inp, g_max=g_max, word_offsets=word_offsets, words=words,
                                     objective=objective)

    def price_bound(self, inp: ffd.SolveInputs, placed, *, word_offsets, words,
                    epoch=None) -> torch.Tensor:
        placed_t = (placed if isinstance(placed, torch.Tensor)
                    else ffd._to_device(np.asarray(placed, np.float32), inp.req.device))
        statics = dict(word_offsets=word_offsets, words=words)
        hit, out = (False, None) if self.aot is None else self.aot.try_call(
            "fractional_price_bound", (inp, placed_t), statics)
        self.replayed = hit
        return out if hit else bound.fractional_price_bound(inp, placed_t, **statics)

    def convex_relax(self, inp: ffd.SolveInputs, *, iters: int, word_offsets,
                     words) -> relax.RelaxOutputs:
        statics = dict(iters=iters, word_offsets=word_offsets, words=words)
        hit, out = (False, None) if self.aot is None else self.aot.try_call(
            "convex_relax", (inp,), statics)
        self.replayed = hit
        return out if hit else relax.convex_relax(inp, **statics)

    def _repack_ops(self, arrays: tuple) -> tuple:
        """Kernel B's operands on this device: host arrays upload through
        the pinned path (repack_from_numpy), device tensors pass as they
        are."""
        if isinstance(arrays[0], torch.Tensor):
            return arrays
        return disrupt_kernel.repack_from_numpy(*arrays, self.device)

    def repack(self, headroom, feas, req, member, excl, *, epoch=None):
        """Kernel B's full entry: ([S, C] leftovers, [S, C, N] takes)."""
        ops = self._repack_ops((headroom, feas, req, member, excl))
        hit, out = (False, None) if self.aot is None else self.aot.try_call(
            "disrupt_repack", ops, {})
        self.replayed = hit
        return out if hit else disrupt_kernel.disrupt_repack(*ops)

    def repack_leftover(self, headroom, feas, req, member, excl, *, epoch=None) -> torch.Tensor:
        """Kernel B's leftover-only entry: the [S, C] leftovers, no takes."""
        ops = self._repack_ops((headroom, feas, req, member, excl))
        return disrupt_kernel.disrupt_repack_leftover(*ops)

    def replace(self, leftover, creq, compat, azone, acap, cap, ovh, price, *, od_col: int,
                epoch=None):
        return disrupt_kernel.disrupt_replace(leftover, creq, compat, azone, acap, cap, ovh,
                                              price, od_col=od_col)
