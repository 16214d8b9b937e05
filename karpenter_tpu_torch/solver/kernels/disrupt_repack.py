"""Kernel B: the candidate-set repack (csrc/disrupt_repack.cu) and its
plain version.

Replaces karpenter_tpu/solver/kernels/disrupt_pallas.py
`disrupt_repack_pallas`. Two entries launch it, on tensors on one device:
`disrupt_repack` returns the leftovers and the [S, C, N] takes (the
provisioning pre-pass reads the takes); `disrupt_repack_leftover` the
leftovers alone, with no takes allocated or written (the consolidation
sweep's). On the CPU each runs its plain version (`repack_reference`,
`repack_leftover_reference`), on a CUDA device it launches the kernel or
raises. Feasibility and exclusion masks enter as bool or uint8 (the
float32 conversion of the Pallas kernel was a TPU constraint).
"""
from __future__ import annotations

import ctypes
import threading
from typing import Optional, Tuple

import torch

from karpenter_tpu_torch.solver.kernels import build
from karpenter_tpu_torch.solver.kernels.ffd_scan import f2i

# launches of the CUDA kernel by this process, by either entry (see
# ffd_scan.launches)
launches = 0
_launches_lock = threading.Lock()

_MASK_DTYPES = (torch.bool, torch.uint8)
SMEM_LIMIT = 232_448  # bytes of shared memory one H100 block may use
_MAX_CHUNK = 256      # classes staged at once
_SLOT_WORDS = 3 * 32  # the prefix sum's two parity slots and the exact sum's
MAX_SETS_PER_BLOCK = 16  # the sweep kernel's sets (warps) a block at most (its launch bounds)


def smem_bytes(n: int, r: int, chunk: int, resident: bool) -> int:
    """Dynamic shared memory of one block-kernel launch (the C entry's
    formula): resident keeps headroom [N, R], fits [N] and the chunk's
    feasibility bits in shared memory; every layout stages the chunk's
    requests and members."""
    nw = (n + 31) // 32
    per_class = (nw if resident else 0) + r + 1
    return 4 * ((n * (r + 1) if resident else 0) + chunk * per_class + (chunk + 31) // 32
                + _SLOT_WORDS)


def layout(n: int, r: int, c: int) -> Tuple[bool, int]:
    """(resident, classes per chunk) of the block kernel: the resident
    layout with the largest chunk that fits, else headroom in a
    device-memory scratch."""
    chunk = max(1, min(c, _MAX_CHUNK))
    while chunk > 1 and smem_bytes(n, r, chunk, True) > SMEM_LIMIT:
        chunk //= 2
    if smem_bytes(n, r, chunk, True) <= SMEM_LIMIT:
        return True, chunk
    return False, max(1, min(c, _MAX_CHUNK))


def sweep_set_bytes(n: int, r: int) -> int:
    """Shared memory of one set in the sweep kernel: headroom [N, R] and a
    bit a 32-node piece (the C entry's formula)."""
    return 4 * (n * r + ((n + 31) // 32 + 31) // 32)


def sweep_sets_per_block(n: int, r: int) -> int:
    """Sets (one warp each) a sweep-kernel block holds: as many as shared
    memory takes, up to MAX_SETS_PER_BLOCK; 0 when one set's headroom does
    not fit (the block kernel's scratch layout takes the launch)."""
    return min(MAX_SETS_PER_BLOCK, SMEM_LIMIT // sweep_set_bytes(n, r))


def _check_device(args, name: str) -> torch.device:
    devices = {t.device for t in args}
    if len(devices) != 1:
        raise ValueError(f"{name}: inputs on several devices {sorted(map(str, devices))}")
    device = devices.pop()
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: no kernel for device {device}")
    return device


def disrupt_repack(headroom0, feas, req, member, excl) -> Tuple[torch.Tensor, torch.Tensor]:
    """([S, C] i32 leftovers, [S, C, N] i32 takes).

    headroom0 [N, R] f32 remaining capacity; feas [C, N] class-on-node
    feasibility; req [C, R] f32 per-pod request; member [S, C] i32 pods of
    class c in set s; excl [S, N] node n is deleted by set s."""
    args = (headroom0, feas, req, member, excl)
    if _check_device(args, "disrupt_repack").type == "cpu":
        return repack_reference(*args)
    return _launch(*args)


def disrupt_repack_leftover(headroom0, feas, req, member, excl) -> torch.Tensor:
    """[S, C] i32 leftovers of `disrupt_repack`, the [S, C, N] takes
    neither allocated nor written (the consolidation sweep's entry)."""
    args = (headroom0, feas, req, member, excl)
    if _check_device(args, "disrupt_repack_leftover").type == "cpu":
        return repack_leftover_reference(*args)
    return _launch(*args, with_takes=False)[0]


def _launch(headroom0, feas, req, member, excl, *, resident: Optional[bool] = None,
            with_takes: bool = True, sweep: Optional[bool] = None):
    """Launch kernel B: (leftover, takes), takes None without `with_takes`.
    The span kernel runs first. Several sets take the sweep kernel (a warp
    a set, as many sets a block as shared memory holds), which hands a set
    whose walks run long to the block kernel where that runs every set at
    once; one set, or a shape whose set headroom shared memory cannot hold,
    takes the block kernel alone. `sweep` True runs the sweep kernel alone,
    False the block kernel alone, and `resident` False the block kernel's
    scratch layout (the tests run each at shapes that fit either)."""
    global launches
    S, N = excl.shape
    C, R = req.shape
    if min(S, C, N) < 1:
        raise ValueError(f"disrupt_repack: empty problem (S={S}, C={C}, N={N})")
    lib = _library()
    max_r = lib.disrupt_repack_max_r()
    if R > max_r:
        raise ValueError(f"disrupt_repack: R={R} exceeds the kernel's {max_r}")
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
    per_block = sweep_sets_per_block(N, R)
    resident_fits, chunk = layout(N, R, C)
    hand_off = sweep is None
    if sweep is None:
        sweep = S > 1 and per_block >= 1 and resident is not False
    if sweep and (per_block < 1 or resident is False):
        raise ValueError(f"disrupt_repack: the sweep kernel cannot hold a set of N={N}, R={R}")
    if sweep:
        # the block kernel runs after the sweep kernel, on the sets it hands off
        code = 1 if hand_off and resident_fits else -1
    else:
        code = int(resident_fits and resident is not False)
    threads = min(1024, max(32, (N + 31) // 32 * 32))
    # one allocation: each class's span of member counts that place nothing
    # ([C] int32 pairs), its room bits ([C, ceil(N / 32)] words) and, where
    # both kernels run, a hand-off flag a set; then the [S, C] leftovers. The
    # headroom and fits of each set lie apart, where shared memory cannot
    # hold them (a leftover must not keep that alive).
    words = C * (2 + (N + 31) // 32) + (S if sweep and code == 1 else 0)
    buf = torch.empty(words + S * C, dtype=torch.int32, device=dev)
    leftover = buf[words:].view(S, C)
    spill = torch.empty(S * N * (R + 1), dtype=torch.float32, device=dev) if code == 0 else None
    takes = torch.empty((S, C, N), dtype=torch.int32, device=dev) if with_takes else None
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.disrupt_repack_launch(
            headroom0.data_ptr(), req.data_ptr(), feas.data_ptr(), member.data_ptr(),
            excl.data_ptr(), leftover.data_ptr(), None if takes is None else takes.data_ptr(),
            buf.data_ptr(), None if spill is None else spill.data_ptr(),
            S, C, N, R, per_block if sweep else 0, threads, chunk, code, stream,
        )
    build.check(err, "disrupt_repack")
    with _launches_lock:
        launches += 1
    return leftover, takes


def _library() -> ctypes.CDLL:
    lib = build.library("disrupt_repack")
    if lib.disrupt_repack_launch.argtypes is None:   # declare once: ctypes defaults to 32-bit ints
        p = ctypes.c_void_p
        lib.disrupt_repack_launch.argtypes = [p] * 9 + [ctypes.c_int] * 8 + [p]
        lib.disrupt_repack_launch.restype = ctypes.c_int
        lib.disrupt_repack_max_r.argtypes = []
        lib.disrupt_repack_max_r.restype = ctypes.c_int
    return lib


def repack_reference(headroom0, feas, req, member, excl) -> Tuple[torch.Tensor, torch.Tensor]:
    """disrupt_repack of the JAX package (disrupt/kernel.py) in torch
    ops, vectorised over the candidate sets, on any device."""
    return _repack_plain(headroom0, feas, req, member, excl, keep_takes=True)


def repack_leftover_reference(headroom0, feas, req, member, excl) -> torch.Tensor:
    """The leftovers of `repack_reference`, its takes never stacked."""
    return _repack_plain(headroom0, feas, req, member, excl, keep_takes=False)[0]


def class_spans(headroom0, feas, req) -> torch.Tensor:
    """[C, 2] int64 (lo, hi): the member counts of class c for which the
    kernel takes no step in any set (leftover = member, zero takes),
    as its span kernel computes them (the proof is csrc/disrupt_repack.cu's
    note): every count for a class no pod of which fits anywhere; [INT32_MIN
    + B, 0] when the per-node bounds of its fits sum to B <= INT32_MAX (a
    walk over the nodes may then stop once the prefix reaches the count);
    none ((1, -1)) when a feasible node is open or B > INT32_MAX."""
    return _class_bounds(headroom0, feas, req)[0]


def class_room(headroom0, feas, req) -> torch.Tensor:
    """[C, N] bool: the nodes where a pod of class c may fit in some set,
    as the span kernel's room bits say (a walk skips the others)."""
    return _class_bounds(headroom0, feas, req)[1]


def walked_nodes(headroom0, feas, req, member, excl) -> torch.Tensor:
    """[S, C] int64: the nodes whose fit each (set, class) pair must look
    at, as the sweep kernel's walk visits them (a node, not a 32-node
    piece): none for a pair whose count lies in its class's span
    (`class_spans`); for a count >= 0 of a class the span bounds, the nodes
    with room (`class_room`) up to where the first-fit prefix of the plain
    version reaches the count (every later take is 0); else every node
    with room."""
    spans, room = _class_bounds(headroom0, feas, req)
    m = member.to(torch.int64)
    step = (m < spans[:, 0]) | (m > spans[:, 1])
    stops = step & (spans[:, 1] == 0)[None, :] & (m >= 0)
    walked = torch.where(step, room.sum(1)[None, :], 0)

    def visit(c, before):
        need = (room[c][None, :] & (before < member[:, c, None])).sum(1)
        walked[:, c] = torch.where(stops[:, c], need, walked[:, c])

    _repack_plain(headroom0, feas, req, member, excl, keep_takes=False, visit=visit)
    return walked


def _class_bounds(headroom0, feas, req):
    feas = feas.to(torch.bool)
    usable = (req > 0.0) & (req >= 0.0).all(0)[None, :]                          # [C, R]
    valid = usable[:, None, :] & ~torch.isnan(headroom0)[None, :, :]              # [C, N, R]
    h = torch.where(torch.isnan(headroom0), 0.0, torch.clamp_min(headroom0, 0.0))
    g = f2i(torch.floor(h[None, :, :] / torch.where(usable, req, 1.0)[:, None, :]))  # [C, N, R]
    int_min, int_max = -2**31, 2**31 - 1
    g = torch.where(valid, g, int_max).amin(-1)                                   # [C, N]
    open_ = feas & ~valid.any(-1)
    room = feas & (open_ | (g > 0))
    bound = torch.where(feas & ~open_, g.to(torch.int64), 0).sum(1)              # [C]
    bounded = ~open_.any(1) & (bound <= int_max)
    nowhere = ~open_.any(1) & (bound == 0)
    lo = torch.where(nowhere, int_min, torch.where(bounded, int_min + bound, 1))
    hi = torch.where(nowhere, int_max, torch.where(bounded, 0, -1))
    return torch.stack([lo, hi], dim=1), room


def _repack_plain(headroom0, feas, req, member, excl, *, keep_takes: bool, visit=None):
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
        if visit is not None:
            visit(c, cum_before)
        take = torch.minimum(torch.clamp_min(member[:, c, None] - cum_before, 0), fit)
        hr = hr - take.to(torch.float32)[:, :, None] * req_c
        if keep_takes:
            takes.append(take)
        leftovers.append(member[:, c] - take.sum(dim=-1, dtype=torch.int32))
    return torch.stack(leftovers, dim=1), (torch.stack(takes, dim=1) if keep_takes else None)
