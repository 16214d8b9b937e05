"""Kernel B: the candidate-set repack (csrc/disrupt_repack.cu) and its
plain version.

Replaces karpenter_tpu/solver/kernels/disrupt_pallas.py
`disrupt_repack_pallas`. `disrupt_repack` takes tensors on one device: on
the CPU it runs `repack_reference`, on a CUDA device it launches the
kernel or raises. Feasibility and exclusion masks enter as bool or
uint8 (the float32 conversion of the Pallas kernel was a TPU constraint).
"""
from __future__ import annotations

import ctypes
import threading
from typing import Optional, Tuple

import torch

from karpenter_tpu_torch.solver.kernels import build
from karpenter_tpu_torch.solver.kernels.ffd_scan import f2i

# launches of the CUDA kernel by this process (see ffd_scan.launches)
launches = 0
_launches_lock = threading.Lock()

_MASK_DTYPES = (torch.bool, torch.uint8)
SMEM_LIMIT = 232_448  # bytes of shared memory one H100 block may use
_MAX_CHUNK = 256      # classes staged at once
_SLOT_WORDS = 3 * 32  # the prefix sum's two parity slots and the exact sum's


def smem_bytes(n: int, r: int, chunk: int, resident: bool) -> int:
    """Dynamic shared memory of one launch (the C entry's formula):
    resident keeps headroom [N, R], fits [N] and the chunk's feasibility
    bits in shared memory; every layout stages the chunk's requests and
    members."""
    nw = (n + 31) // 32
    per_class = (nw if resident else 0) + r + 1
    return 4 * ((n * (r + 1) if resident else 0) + chunk * per_class + (chunk + 31) // 32
                + _SLOT_WORDS)


def layout(n: int, r: int, c: int) -> Tuple[bool, int]:
    """(resident, classes per chunk): the resident layout with the largest
    chunk that fits, else headroom in a device-memory scratch."""
    chunk = max(1, min(c, _MAX_CHUNK))
    while chunk > 1 and smem_bytes(n, r, chunk, True) > SMEM_LIMIT:
        chunk //= 2
    if smem_bytes(n, r, chunk, True) <= SMEM_LIMIT:
        return True, chunk
    return False, max(1, min(c, _MAX_CHUNK))


def disrupt_repack(headroom0, feas, req, member, excl) -> Tuple[torch.Tensor, torch.Tensor]:
    """([S, C] i32 leftovers, [S, C, N] i32 takes).

    headroom0 [N, R] f32 remaining capacity; feas [C, N] class-on-node
    feasibility; req [C, R] f32 per-pod request; member [S, C] i32 pods of
    class c in set s; excl [S, N] node n is deleted by set s."""
    args = (headroom0, feas, req, member, excl)
    devices = {t.device for t in args}
    if len(devices) != 1:
        raise ValueError(f"disrupt_repack: inputs on several devices {sorted(map(str, devices))}")
    device = devices.pop()
    if device.type == "cpu":
        return repack_reference(*args)
    if device.type != "cuda":
        raise ValueError(f"disrupt_repack: no kernel for device {device}")
    return _launch(*args)


def _launch(headroom0, feas, req, member, excl, *, resident: Optional[bool] = None):
    """Launch kernel B. `resident` None picks the layout from the shapes;
    the tests pass False to run the scratch layout at a shape that fits both."""
    global launches
    S, N = excl.shape
    C, R = req.shape
    if min(S, C, N) < 1:
        raise ValueError(f"disrupt_repack: empty problem (S={S}, C={C}, N={N})")
    lib = _library()
    if R > lib.disrupt_repack_max_r():
        raise ValueError(f"disrupt_repack: R={R} exceeds the kernel's {lib.disrupt_repack_max_r()}")
    for name, t, dtypes, shape in (
        ("headroom0", headroom0, (torch.float32,), (N, R)),
        ("feas", feas, _MASK_DTYPES, (C, N)),
        ("req", req, (torch.float32,), (C, R)),
        ("member", member, (torch.int32,), (S, C)),
        ("excl", excl, _MASK_DTYPES, (S, N)),
    ):
        if t.dtype not in dtypes:
            raise TypeError(f"disrupt_repack: {name} is {t.dtype}, kernel takes {dtypes}")
        if tuple(t.shape) != shape:
            raise ValueError(f"disrupt_repack: {name} has shape {tuple(t.shape)}, expected {shape}")
        if not t.is_contiguous():
            raise ValueError(f"disrupt_repack: {name} is not contiguous")
    dev = req.device
    resident_fits, chunk = layout(N, R, C)
    resident = resident_fits and resident is not False
    leftover = torch.empty((S, C), dtype=torch.int32, device=dev)
    takes = torch.empty((S, C, N), dtype=torch.int32, device=dev)
    # headroom and fits of each set, only where shared memory cannot hold them
    scratch = None if resident else torch.empty((S, N, R + 1), dtype=torch.float32, device=dev)
    threads = min(1024, max(32, (N + 31) // 32 * 32))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.disrupt_repack_launch(
            headroom0.data_ptr(), req.data_ptr(), feas.data_ptr(), member.data_ptr(),
            excl.data_ptr(), leftover.data_ptr(), takes.data_ptr(),
            None if scratch is None else scratch.data_ptr(),
            S, C, N, R, threads, chunk, int(resident), stream,
        )
    build.check(err, "disrupt_repack")
    with _launches_lock:
        launches += 1
    return leftover, takes


def _library() -> ctypes.CDLL:
    lib = build.library("disrupt_repack")
    if lib.disrupt_repack_launch.argtypes is None:   # declare once: ctypes defaults to 32-bit ints
        p = ctypes.c_void_p
        lib.disrupt_repack_launch.argtypes = [p] * 8 + [ctypes.c_int] * 7 + [p]
        lib.disrupt_repack_launch.restype = ctypes.c_int
        lib.disrupt_repack_max_r.argtypes = []
        lib.disrupt_repack_max_r.restype = ctypes.c_int
    return lib


def repack_reference(headroom0, feas, req, member, excl) -> Tuple[torch.Tensor, torch.Tensor]:
    """disrupt_repack of the JAX package (disrupt/kernel.py) in torch
    ops, vectorised over the candidate sets, on any device."""
    C = req.shape[0]
    feas = feas.to(torch.bool)
    hr = torch.where(excl.to(torch.bool)[:, :, None], 0.0, headroom0[None, :, :])   # [S, N, R]
    leftovers, takes = [], []
    for c in range(C):
        req_c = req[c]
        pos = req_c > 0.0
        safe = torch.where(pos, req_c, 1.0)
        per_axis = torch.where(pos, torch.floor(hr / safe), torch.inf)               # [S, N, R]
        fit = torch.clamp_min(per_axis.amin(dim=-1), 0.0)
        fit = f2i(torch.where(feas[c][None, :], fit, 0.0))                           # [S, N]
        cum_before = torch.cumsum(fit, -1, dtype=torch.int32) - fit
        take = torch.minimum(torch.clamp_min(member[:, c, None] - cum_before, 0), fit)
        hr = hr - take.to(torch.float32)[:, :, None] * req_c
        takes.append(take)
        leftovers.append(member[:, c] - take.sum(dim=-1, dtype=torch.int32))
    return torch.stack(leftovers, dim=1), torch.stack(takes, dim=1)
