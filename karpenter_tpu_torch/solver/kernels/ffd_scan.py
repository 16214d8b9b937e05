"""Kernel A: the fused FFD scan (csrc/ffd_scan.cu) and its plain version.

Replaces karpenter_tpu/solver/kernels/ffd_pallas.py `_fused_scan`. The
batch prologue (compat, fresh fits, price tables) and the epilogue
(sparse take, fused buffer) stay torch code in solver/ffd.py; this module
is the sequential scan only, with the outputs already in the compact
decision's packed forms.

`fused_scan` takes tensors on one device. On the CPU it runs
`fused_scan_reference`; on a CUDA device it launches the kernel or
raises. `fused_scan_reference` is the same scan in torch ops, float32 in
the reference's op order, with packed words in int32 lanes; the CPU tests
hold it against the JAX package, and chip_smoke.py holds the kernel
against it on the card.
"""
from __future__ import annotations

import ctypes
import threading
from typing import Optional, Tuple

import torch

from karpenter_tpu_torch.solver import packing
from karpenter_tpu_torch.solver.kernels import build

# launches of the CUDA kernel by this process (a plain count: chip_smoke.py
# zeroes it before the main path and reads it after)
launches = 0
# several threads launch (the fleet's dispatcher beside the tenants' own
# pre-passes): the read-add-write of the count must not lose one
_launches_lock = threading.Lock()

SMEM_LIMIT = 232_448  # bytes of shared memory one H100 block may use
THREADS = 1024        # threads of the one block that runs the scan
NARROW_TYPES = 16     # a group of more surviving types makes a wide step (kNarrowTypes)
_CT_SHIFT = 8
_ZONE_BITS = (1 << _CT_SHIFT) - 1
_SLOT_WORDS = 4 * 32  # four reductions' per-warp slots

ScanOutputs = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


# the kernel's layouts, in the order `layout` tries them, with the C entry's codes
LAYOUTS = {"resident": 1, "lean": 0, "scratch": 2}


def smem_bytes(g_max: int, k: int, r: int, layout: str = "resident") -> int:
    """Dynamic shared memory of one launch (the C entry's formula).

    resident: two class-row buffers (the next real class lands while the
    current one runs) and cap_eff/tzc in shared memory. lean: one row
    buffer and cap_eff/tzc read from device memory. scratch: as lean, with
    the survivor words and their bitmaps in device memory as well."""
    kw = k // 32
    nzw = (kw + 31) // 32
    row = (2 * k + 3 * kw + r + 3 + 3) & ~3
    per_group = r + 2                       # accum, gzc, fit
    if layout != "scratch":
        per_group += kw + nzw               # survivor words, their bitmap
    # slots, the new groups' two mask rows, their bitmaps and their types
    fixed = _SLOT_WORDS + 2 * kw + 2 * nzw + 2
    if layout == "resident":
        return 4 * (2 * row + g_max * per_group + k * r + k + THREADS // 32 + fixed)
    return 4 * (row + g_max * per_group + 1 + fixed)


def layout(g_max: int, k: int, r: int) -> str:
    """The first of resident, lean and scratch that fits in one block's
    shared memory. Raises where even scratch does not: its G * (R + 2)
    words of carry plus one class row (2K + 3K/32 + R words) pass the
    block's SMEM_LIMIT bytes."""
    for name in LAYOUTS:
        if smem_bytes(g_max, k, r, name) <= SMEM_LIMIT:
            return name
    raise ValueError(
        f"fused_scan: G={g_max}, K={k}, R={r} needs {smem_bytes(g_max, k, r, 'scratch')} "
        f"bytes of shared memory even with the survivor words in device memory (the "
        f"scratch layout keeps G * (R + 2) words of carry and one class row of 2K + 3K/32 "
        f"+ R words there), over the {SMEM_LIMIT} one block may use")


def fused_scan(
    req, compat_w, fresh_w, hasres_w, n_fresh, price, count, env, azc, cap_eff, tzc,
    *, g_max: int, objective: str,
) -> ScanOutputs:
    """(take [C, G] i32, unplaced [C] i32, n_open [] i32, gmask_bits
    [G, KW] i32 lanes, gzc [G] i32 lanes).

    req [C, R] f32; compat_w, fresh_w, hasres_w [C, KW] i32 lanes;
    n_fresh, price [C, K] f32; count, env [C] i32; azc [C] i32 lanes;
    cap_eff [K, R] f32; tzc [K] i32 lanes."""
    args = (req, compat_w, fresh_w, hasres_w, n_fresh, price, count, env, azc, cap_eff, tzc)
    devices = {t.device for t in args}
    if len(devices) != 1:
        raise ValueError(f"fused_scan: inputs on several devices {sorted(map(str, devices))}")
    device = devices.pop()
    if device.type == "cpu":
        return fused_scan_reference(*args, g_max=g_max, objective=objective)
    if device.type != "cuda":
        raise ValueError(f"fused_scan: no kernel for device {device}")
    return _launch(*args, g_max=g_max, objective=objective)


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape: tuple) -> None:
    if t.dtype != dtype:
        raise TypeError(f"fused_scan: {name} is {t.dtype}, kernel takes {dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"fused_scan: {name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"fused_scan: {name} is not contiguous")


def _launch(req, compat_w, fresh_w, hasres_w, n_fresh, price, count, env, azc, cap_eff, tzc,
            *, g_max: int, objective: str, layout_name: Optional[str] = None) -> ScanOutputs:
    """Launch kernel A. `layout_name` None picks the layout from the
    shapes; the tests name one to run it at a shape where an earlier one
    fits too (it raises where the named one does not fit)."""
    global launches
    C, R = req.shape
    K = cap_eff.shape[0]
    if K % 32:
        raise ValueError(f"fused_scan: the kernel needs K % 32 == 0, got {K}")
    if C < 1 or g_max < 1:
        raise ValueError(f"fused_scan: empty scan (C={C}, g_max={g_max})")
    if objective not in ("price", "fit"):
        raise ValueError(f"fused_scan: unknown objective {objective!r}")
    KW = K // 32
    if layout_name is None:
        layout_name = layout(g_max, K, R)
    elif smem_bytes(g_max, K, R, layout_name) > SMEM_LIMIT:
        raise ValueError(f"fused_scan: the {layout_name} layout does not fit G={g_max}, K={K}, R={R}")
    for name, t, dtype, shape in (
        ("req", req, torch.float32, (C, R)),
        ("compat_w", compat_w, torch.int32, (C, KW)),
        ("fresh_w", fresh_w, torch.int32, (C, KW)),
        ("hasres_w", hasres_w, torch.int32, (C, KW)),
        ("n_fresh", n_fresh, torch.float32, (C, K)),
        ("price", price, torch.float32, (C, K)),
        ("count", count, torch.int32, (C,)),
        ("env", env, torch.int32, (C,)),
        ("azc", azc, torch.int32, (C,)),
        ("cap_eff", cap_eff, torch.float32, (K, R)),
        ("tzc", tzc, torch.int32, (K,)),
    ):
        _check(name, t, dtype, shape)
    # the kernel copies these 16 bytes at a time: a view that starts off a
    # 16-byte boundary is copied first
    n_fresh, price, cap_eff, tzc = (
        t if t.data_ptr() % 16 == 0 else t.clone() for t in (n_fresh, price, cap_eff, tzc))
    dev = req.device
    take = torch.empty((C, g_max), dtype=torch.int32, device=dev)
    unplaced = torch.empty((C,), dtype=torch.int32, device=dev)
    gmask_bits = torch.empty((g_max, KW), dtype=torch.int32, device=dev)
    gzc = torch.empty((g_max,), dtype=torch.int32, device=dev)
    n_open = torch.empty((1,), dtype=torch.int32, device=dev)
    # the survivor words' bitmaps, only where shared memory cannot hold the
    # words (the words themselves are carried in gmask_bits)
    gnz = (torch.empty((g_max, (KW + 31) // 32), dtype=torch.int32, device=dev)
           if layout_name == "scratch" else None)
    # a wide step's fits of the wide groups' surviving types, kept from the
    # group max to the keep test, then its bitmap of wide groups (L2-resident)
    wide = torch.empty((g_max * K + (g_max + 31) // 32,), dtype=torch.int32, device=dev)
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.ffd_scan_launch(
            req.data_ptr(), compat_w.data_ptr(), fresh_w.data_ptr(), hasres_w.data_ptr(),
            n_fresh.data_ptr(), price.data_ptr(), count.data_ptr(), env.data_ptr(),
            azc.data_ptr(), cap_eff.data_ptr(), tzc.data_ptr(),
            take.data_ptr(), unplaced.data_ptr(), gmask_bits.data_ptr(), gzc.data_ptr(),
            n_open.data_ptr(), None if gnz is None else gnz.data_ptr(), wide.data_ptr(),
            C, g_max, K, R, int(objective == "price"), THREADS, LAYOUTS[layout_name], stream,
        )
    build.check(err, "ffd_scan")
    with _launches_lock:
        launches += 1
    return take, unplaced, n_open[0], gmask_bits, gzc


def _library() -> ctypes.CDLL:
    lib = build.library("ffd_scan")
    if lib.ffd_scan_launch.argtypes is None:   # declare once: ctypes defaults to 32-bit ints
        p = ctypes.c_void_p
        lib.ffd_scan_launch.argtypes = [p] * 18 + [ctypes.c_int] * 7 + [p]
        lib.ffd_scan_launch.restype = ctypes.c_int
    return lib


# -- the plain version --------------------------------------------------------


def f2i(x: torch.Tensor) -> torch.Tensor:
    """float -> int32 as XLA and the GPU convert: truncate toward zero,
    saturate at the int32 range, NaN -> 0 (a bare .to(int32) leaves
    out-of-range values undefined)."""
    x = torch.nan_to_num(x.to(torch.float64), nan=0.0)
    return x.clamp(-(2**31), 2**31 - 1).to(torch.int32)


def joint_ok(x: torch.Tensor) -> torch.Tensor:
    """Both the zone and the captype sub-bitsets intersect."""
    return ((x & _ZONE_BITS) != 0) & ((x >> _CT_SHIFT) != 0)


def fit_counts(cap: torch.Tensor, accum: torch.Tensor, req: torch.Tensor) -> torch.Tensor:
    """[G, K] pods of `req` that fit in cap[k] - accum[g]; axes with
    req == 0 are unconstrained (ffd._fit_counts, R-unrolled)."""
    n = None
    for r in range(cap.shape[1]):
        pos = req[r] > 0.0
        d = torch.where(pos, req[r], 1.0)
        axis_n = torch.where(
            pos, torch.floor((cap[None, :, r] - accum[:, r, None]) / d), torch.inf)
        n = axis_n if n is None else torch.minimum(n, axis_n)
    return torch.clamp_min(n, 0.0)


def fused_scan_reference(
    req, compat_w, fresh_w, hasres_w, n_fresh, price, count, env, azc, cap_eff, tzc,
    *, g_max: int, objective: str, joined: Optional[list] = None,
) -> ScanOutputs:
    """The scan of ffd._ffd_body (JAX package) in torch ops, on any
    device, with no host synchronisation inside. `joined`, when given,
    gets one 0-d tensor a class: the (open group, type) pairs its step
    joins, whose fits the step must compute."""
    C, R = req.shape
    K = cap_eff.shape[0]
    G = g_max
    dev = req.device
    compat = packing.unpack_rows(compat_w, K)
    fresh = packing.unpack_rows(fresh_w, K)
    has_res = packing.unpack_rows(hasres_w, K)
    slot = torch.arange(G, dtype=torch.int32, device=dev)
    accum = torch.zeros((G, R), dtype=torch.float32, device=dev)
    gmask = torch.zeros((G, K), dtype=torch.bool, device=dev)
    gzc = torch.zeros((G,), dtype=torch.int32, device=dev)
    n_open = torch.zeros((), dtype=torch.int32, device=dev)
    takes, unplaced = [], []
    for c in range(C):
        req_c, count_c, env_c, azc_c = req[c], count[c], env[c], azc[c]
        fresh_row, n_fresh_row, price_row = fresh[c], n_fresh[c], price[c]

        gzc_new = gzc & azc_c
        m = gmask & compat[c][None, :] & joint_ok(gzc_new[:, None] & tzc[None, :])
        if joined is not None:
            joined.append(m.sum())
        n_fit = fit_counts(cap_eff, accum, req_c)
        n_grp = torch.where(m, n_fit, 0.0).amax(dim=-1)
        n_grp = f2i(torch.where(slot < n_open, n_grp, 0.0))

        cum_before = torch.cumsum(n_grp, 0, dtype=torch.int32) - n_grp
        take = torch.minimum(torch.clamp_min(count_c - cum_before, 0), n_grp)
        leftover = count_c - take.sum(dtype=torch.int32)

        max_fit_f = torch.where(fresh_row, n_fresh_row, 0.0).amax()
        per_new_fit = f2i(max_fit_f)
        if objective == "price":
            env_n = torch.where(env_c > 0, env_c, torch.clamp_min(leftover + (-env_c - 1), 1))
            envf = env_n.to(torch.float32)
            ngroups = torch.ceil(envf / torch.clamp_min(n_fresh_row, 1.0))
            need = torch.minimum(max_fit_f, envf)
            eligible = (
                fresh_row
                & (n_fresh_row >= 1.0)
                & ((2.0 * torch.minimum(n_fresh_row, envf) >= need) | has_res[c])
            )
            total_cost = torch.where(eligible, price_row * ngroups, torch.inf)
            kstar = torch.argmin(total_cost)
            ok = torch.isfinite(total_cost[kstar])
            per_new_price = f2i(torch.where(ok, n_fresh_row[kstar], 0.0))
            p_star = price_row[kstar]
            price_mask = (
                fresh_row
                & (n_fresh_row >= per_new_price.to(torch.float32))
                & (price_row <= p_star)
                & ok
            )
            use_fit = env_c == 0
            per_new = torch.where(use_fit, per_new_fit, per_new_price)
            open_mask = torch.where(use_fit, fresh_row, price_mask)
        else:
            per_new = per_new_fit
            open_mask = fresh_row

        can_open = (leftover > 0) & (per_new > 0)
        per_new64 = per_new.to(torch.int64)
        ceil_div = (leftover.to(torch.int64) + per_new64 - 1) // torch.clamp_min(per_new64, 1)
        n_new = torch.where(can_open, ceil_div, 0)
        n_new = torch.minimum(n_new, (G - n_open).to(torch.int64)).to(torch.int32)
        is_new = (slot >= n_open) & (slot < n_open + n_new)
        ordinal = (slot - n_open).to(torch.int64)
        rest = leftover.to(torch.int64) - ordinal * per_new64
        take_new = torch.where(
            is_new, torch.minimum(torch.clamp_min(rest, 0), per_new64), 0).to(torch.int32)

        take_all = take + take_new
        unplaced.append(count_c - take_all.sum(dtype=torch.int32))

        takef = take_all.to(torch.float32)
        accum = accum + takef[:, None] * req_c[None, :]
        touched = take > 0
        gmask = torch.where(touched[:, None], m & (takef[:, None] <= n_fit), gmask)
        gmask = torch.where(
            is_new[:, None], open_mask[None, :] & (takef[:, None] <= n_fresh_row[None, :]), gmask)
        gzc = torch.where(touched, gzc_new, gzc)
        gzc = torch.where(is_new, azc_c, gzc)
        n_open = n_open + n_new
        takes.append(take_all)
    return (
        torch.stack(takes), torch.stack(unplaced), n_open,
        packing.pack_rows(gmask), gzc,
    )
