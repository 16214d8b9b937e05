"""Batched first-fit-decreasing provisioning solve, in torch around kernel A.

Counterpart of karpenter_tpu/solver/ffd.py and of the Pallas entry
`ffd_solve_fused_pallas` (karpenter_tpu/solver/kernels/ffd_pallas.py):

- the prologue is batch [C, K] work with no sequential dependence --
  class/type compatibility from the packed label bitsets, fresh-node fit
  counts, per-(class, type) price tables, the packed zone|captype lanes --
  and stays plain torch, as it was XLA work outside the Pallas kernel;
- the sequential scan over classes is kernel A
  (solver/kernels/ffd_scan.py; its plain version on the CPU);
- the epilogue compacts the decision into ONE 32-bit buffer with exactly
  the layout of the JAX package's `ffd_solve_fused`, so the host fetches
  one array per tick.

The solver sidecar's ops (solver/rpc.py) read the same scan through the
JAX package's other two entries: `ffd_solve` (the dense `SolveOutputs`
of the `solve` op) and `ffd_solve_compact` (the `CompactDecision` of
`solve_compact` and `solve_delta`), expanded on the client by
`expand_compact`. Both launch kernel A once; neither has a plain path
on the card.

All resource values are small exact integers in float32 (encode.py
scaling), so the fit arithmetic is exact and the buffer is byte-equal to
the JAX package's on the same encoded inputs. Packed words travel in
int32 lanes and are read as uint32 where the buffer reaches the host.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from karpenter_tpu_torch.apis import labels as wk
from karpenter_tpu_torch.solver import encode, packing
from karpenter_tpu_torch.solver.encode import CAPTYPE_INDEX, CatalogTensors, PodClassSet
from karpenter_tpu_torch.solver.kernels import ffd_scan
from karpenter_tpu_torch.solver.kernels.ffd_scan import joint_ok as _joint_ok

_CT_SHIFT = 8  # captype bits live above the zone bits in the packed lanes


class SolveInputs(NamedTuple):
    # catalog (staged once per catalog list)
    cap: torch.Tensor           # [K, R] f32
    tcode: torch.Tensor         # [K, D] i32
    tnum: torch.Tensor          # [K, ND] f32
    tnum_present: torch.Tensor  # [K, ND] bool
    tzone: torch.Tensor         # [K, Z] bool
    tcap: torch.Tensor          # [K, CT] bool
    price: torch.Tensor         # [K, Z, CT] f32 (+inf when unavailable)
    # classes (per tick)
    req: torch.Tensor           # [C, R] f32
    count: torch.Tensor         # [C] i32
    env_count: torch.Tensor     # [C] i32 price-envelope pod count (see JAX ffd.py)
    allowed: torch.Tensor       # [C, TW] i32 lanes of the u32 label bitsets
    num_lo: torch.Tensor        # [C, ND] f32
    num_hi: torch.Tensor        # [C, ND] f32
    azone: torch.Tensor         # [C, Z] bool
    acap: torch.Tensor          # [C, CT] bool
    schedulable: torch.Tensor   # [C] bool
    node_overhead: torch.Tensor  # [R] f32 per-fresh-node reserve
    open_allowed: torch.Tensor  # [C, K] bool or [C, KW] i32 lanes (packed)
    join_allowed: torch.Tensor  # [C, K] bool or [C, KW] i32 lanes (packed)


class SolveOutputs(NamedTuple):
    """The dense decision (the JAX package's ffd.SolveOutputs)."""

    take: torch.Tensor          # [C, G] i32: pods of class c placed on group g
    unplaced: torch.Tensor      # [C] i32
    n_open: torch.Tensor        # [] i32
    accum: torch.Tensor         # [G, R] f32 summed requests per group
    gmask: torch.Tensor         # [G, K] bool surviving types
    gzone: torch.Tensor         # [G, Z] bool
    gcap: torch.Tensor          # [G, CT] bool
    compat: torch.Tensor        # [C, K] bool (join mask applied)


class CompactDecision(NamedTuple):
    """The decision compacted for one small fetch (the JAX package's
    ffd.CompactDecision): sparse take (flat row-major [C, G] indices,
    -1 pads; `nnz` the true count, past idx's length the caller refetches
    densely), survivor masks packed 32 types per uint32 lane, zones and
    captypes in the packed gzc lane."""

    idx: torch.Tensor           # [NNZ] i32
    val: torch.Tensor           # [NNZ] i32
    nnz: torch.Tensor           # [] i32
    unplaced: torch.Tensor      # [C] i32
    n_open: torch.Tensor        # [] i32
    gmask_bits: torch.Tensor    # [G, K/32] i32 lanes of the u32 words
    gzc: torch.Tensor           # [G] i32 lanes of the u32 zone|captype bits


class StagedCatalog(NamedTuple):
    """Catalog tensors resident on the device, uploaded once per catalog."""

    cap: torch.Tensor
    tcode: torch.Tensor
    tnum: torch.Tensor
    tnum_present: torch.Tensor
    tzone: torch.Tensor
    tcap: torch.Tensor
    price: torch.Tensor


def _host_tensor(a: np.ndarray) -> torch.Tensor:
    """numpy -> a CPU tensor over the same bytes; uint32 words become
    int32 lanes."""
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:
        # a received wire frame's read-only view: torch.from_numpy needs
        # a writable buffer
        a = a.copy()
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a)


def _pinned_path(device) -> bool:
    """Uploads to `device` stage through page-locked memory (the card)."""
    return torch.device(device).type == "cuda"


def _pin(t: torch.Tensor) -> torch.Tensor:
    """A page-locked copy of the CPU tensor `t`."""
    return torch.empty(t.shape, dtype=t.dtype, pin_memory=True).copy_(t)


def _to_device(a: np.ndarray, device, hold: Optional[list] = None) -> torch.Tensor:
    """numpy -> torch on `device`; uint32 words become int32 lanes.

    To the card the bytes go through a page-locked staging buffer and a
    non_blocking copy: torch copies pageable memory synchronously (the
    host waits for the card), a pinned copy is only enqueued on the
    stream. The staging buffer must outlive its copy: `hold` keeps it
    until the caller's next barrier (a solve holds its uploads on its
    _PendingSolve until the fetch, which waits for the stream, has
    returned); without one the caching host allocator keeps the block
    until the event torch records on the stream for every non_blocking
    copy out of pinned memory has passed."""
    t = _host_tensor(a)
    if not _pinned_path(device):
        return t.to(device)
    pinned = _pin(t)
    out = pinned.to(device, non_blocking=True)
    if hold is not None:
        hold.append(pinned)
    return out


def _offsets(words) -> Tuple[int, ...]:
    return tuple(int(x) for x in np.cumsum((0,) + tuple(words)[:-1]))


def stage_catalog(catalog: CatalogTensors, device) -> Tuple[StagedCatalog, Tuple[int, ...], Tuple[int, ...]]:
    words = tuple(int(w) for w in catalog.words)
    staged = StagedCatalog(*(
        _to_device(getattr(catalog, name), device) for name in StagedCatalog._fields))
    return staged, _offsets(words), words


def _mask_form(mask: Optional[np.ndarray], c_pad: int, k_pad: int, packed: bool) -> np.ndarray:
    """The requested host form of an open/join mask: ``packed`` selects
    the uint32 words, else full bool. None (no restriction) materializes
    all-true in the requested form."""
    if mask is None:
        if packed:
            return np.full((c_pad, packing.packed_words(k_pad)), 0xFFFFFFFF, dtype=np.uint32)
        return np.ones((c_pad, k_pad), dtype=bool)
    if packed and not packing.is_packed(mask):
        return packing.pack_mask(mask)
    if not packed and packing.is_packed(mask):
        return packing.unpack_mask(mask, k_pad)
    return mask


def _class_inputs(staged: StagedCatalog, classes: Dict[str, object], packed_masks: bool, device,
                  hold: Optional[list] = None) -> SolveInputs:
    allowed = classes["allowed"]
    if isinstance(allowed, (list, tuple)):
        allowed = np.concatenate(allowed, axis=1)
    req = np.asarray(classes["req"])
    c_pad = req.shape[0]
    k_pad = int(staged.cap.shape[0])
    overhead = classes.get("node_overhead")
    if overhead is None:
        overhead = np.zeros((req.shape[1],), dtype=np.float32)
    put = lambda a: _to_device(np.asarray(a), device, hold)  # noqa: E731
    return SolveInputs(
        *staged,
        req=put(req), count=put(classes["count"]), env_count=put(classes["env_count"]),
        allowed=put(np.asarray(allowed, dtype=np.uint32)),
        num_lo=put(classes["num_lo"]), num_hi=put(classes["num_hi"]),
        azone=put(classes["azone"]), acap=put(classes["acap"]),
        schedulable=put(classes["schedulable"]), node_overhead=put(overhead),
        open_allowed=put(_mask_form(classes.get("open_allowed"), c_pad, k_pad, packed_masks)),
        join_allowed=put(_mask_form(classes.get("join_allowed"), c_pad, k_pad, packed_masks)),
    )


_CLASS_FIELDS = (
    "req", "count", "env_count", "allowed", "num_lo", "num_hi", "azone", "acap",
    "schedulable", "node_overhead", "open_allowed", "join_allowed",
)


def make_inputs_staged(staged: StagedCatalog, classes: PodClassSet, packed_masks: bool = False,
                       hold: Optional[list] = None) -> SolveInputs:
    """SolveInputs over a pre-staged device catalog: the per-tick class
    tensors move to the catalog's device (through pinned staging buffers
    on the card, kept in `hold` when given: see _to_device)."""
    fields = {name: getattr(classes, name, None) for name in _CLASS_FIELDS}
    return _class_inputs(staged, fields, packed_masks, staged.cap.device, hold)


def inputs_from_numpy(catalog: Dict[str, np.ndarray], classes: Dict[str, object], device,
                      packed_masks: bool = False) -> Tuple[SolveInputs, Tuple[int, ...], Tuple[int, ...]]:
    """The port's staged SolveInputs from the field arrays of a
    CatalogTensors (`catalog`: cap, tcode, tnum, tnum_present, tzone,
    tcap, price, words) and a PodClassSet (`classes`: req, count,
    env_count, allowed, num_lo, num_hi, azone, acap, schedulable and
    optionally node_overhead, open_allowed, join_allowed) given as numpy
    arrays -- the JAX package's encoded state, carried over as it is, so
    both fused solves run on byte-identical inputs."""
    words = tuple(int(w) for w in np.asarray(catalog["words"]).ravel())
    staged = StagedCatalog(*(
        _to_device(np.asarray(catalog[name]), device) for name in StagedCatalog._fields))
    return _class_inputs(staged, classes, packed_masks, device), _offsets(words), words


# -- the prologue -----------------------------------------------------------


def _device_compat(inp: SolveInputs, word_offsets: Tuple[int, ...], words: Tuple[int, ...]) -> torch.Tensor:
    """[C, K] bool compatibility (encode.compat_matrix on the device)."""
    C = inp.req.shape[0]
    K = inp.cap.shape[0]
    ok = torch.ones((C, K), dtype=torch.bool, device=inp.req.device)
    for d, (off, _w) in enumerate(zip(word_offsets, words)):
        codes = inp.tcode[:, d]                                   # [K]
        word_idx = (off + (codes >> 5)).to(torch.int64)
        bit_idx = codes & 31
        gathered = inp.allowed[:, word_idx]                       # [C, K] i32 lanes
        ok = ok & (((gathered >> bit_idx[None, :]) & 1) != 0)
    v = inp.tnum[None, :, :]                                      # [1, K, ND]
    in_window = (v > inp.num_lo[:, None, :]) & (v < inp.num_hi[:, None, :])
    # an absent numeric label on the type side is permissive
    ok = ok & torch.all(in_window | ~inp.tnum_present[None, :, :], dim=-1)
    zj = (inp.azone[:, None, :] & inp.tzone[None, :, :]).any(dim=-1)
    cj = (inp.acap[:, None, :] & inp.tcap[None, :, :]).any(dim=-1)
    return ok & zj & cj & inp.schedulable[:, None]


def _fresh_fit_counts(cap: torch.Tensor, req: torch.Tensor) -> torch.Tensor:
    """[C, K] pods of class c that fit an EMPTY node of type k."""
    n = None
    for r in range(cap.shape[1]):
        req_r = req[:, r]
        pos = req_r[:, None] > 0.0
        d = torch.where(req_r > 0.0, req_r, 1.0)
        axis_n = torch.where(pos, torch.floor(cap[None, :, r] / d[:, None]), torch.inf)
        n = axis_n if n is None else torch.minimum(n, axis_n)
    return torch.clamp_min(n, 0.0)


def _class_type_price(inp: SolveInputs) -> Tuple[torch.Tensor, torch.Tensor]:
    """([C, K] cheapest offering price of type k over the (zone, captype)
    cells class c admits, +inf when none; [C, K] bool: an admitted
    RESERVED offering exists)."""
    reserved_ct = CAPTYPE_INDEX[wk.CAPACITY_TYPE_RESERVED]
    best = has_res = None
    for z in range(inp.tzone.shape[1]):
        for ct in range(inp.tcap.shape[1]):
            m = (inp.azone[:, z] & inp.acap[:, ct])[:, None]       # [C, 1]
            cell = inp.price[None, :, z, ct]                      # [1, K]
            cand = torch.where(m, cell, torch.inf)
            best = cand if best is None else torch.minimum(best, cand)
            if ct == reserved_ct:
                r = m & torch.isfinite(cell)
                has_res = r if has_res is None else (has_res | r)
    return best, has_res


def _pack_zc(zmask: torch.Tensor, cmask: torch.Tensor) -> torch.Tensor:
    """[..., Z] bool x [..., CT] bool -> [...] i32 lanes (zones in bits
    0..Z-1, captypes in bits _CT_SHIFT..)."""
    Z, CTn = zmask.shape[-1], cmask.shape[-1]
    if Z > _CT_SHIFT:
        raise ValueError(f"zone lanes ({Z}) overflow into the captype bits at {_CT_SHIFT}")
    if _CT_SHIFT + CTn > 32:
        raise ValueError(f"zone+captype lanes exceed 32 bits ({_CT_SHIFT}+{CTn})")
    dev = zmask.device
    zbits = (zmask.to(torch.int32) << torch.arange(Z, dtype=torch.int32, device=dev)).sum(-1)
    cshift = torch.arange(_CT_SHIFT, _CT_SHIFT + CTn, dtype=torch.int32, device=dev)
    cbits = (cmask.to(torch.int32) << cshift).sum(-1)
    return (zbits | cbits).to(torch.int32)


class ScanColumns(NamedTuple):
    """The prologue's per-column results, unpacked: everything kernel A
    reads that depends on the catalog axis K. Each [C, K] entry is a
    function of one class row and one type column only, so a mesh shard
    computes them for its own rows and columns (parallel/mesh.py) and the
    gather packs them once, on the primary shard."""

    compat: torch.Tensor        # [C, K] bool, the join gate applied
    fresh: torch.Tensor         # [C, K] bool a fresh node of type k may open for c
    has_res: torch.Tensor       # [C, K] bool an admitted reserved offering exists
    n_fresh: torch.Tensor       # [C, K] f32 pods of c on an empty node of type k
    price: torch.Tensor         # [C, K] f32 cheapest admitted offering price
    cap_eff: torch.Tensor       # [K, R] f32 capacity net of the node overhead
    tzc: torch.Tensor           # [K] i32 lanes of the type's zone|captype bits


def scan_columns(inp: SolveInputs, word_offsets: Tuple[int, ...], words: Tuple[int, ...],
                 objective: str) -> ScanColumns:
    """The prologue over `inp`'s rows and columns, unpacked (any K)."""
    K = inp.cap.shape[0]
    join_allowed = packing.as_bool_mask(inp.join_allowed, K)
    open_allowed = packing.as_bool_mask(inp.open_allowed, K)
    compat = _device_compat(inp, word_offsets, words) & join_allowed
    # fresh nodes reserve the pool's daemonset overhead; padding rows clip
    # to zero so they stay unusable
    cap_eff = torch.clamp_min(inp.cap - inp.node_overhead[None, :], 0.0)
    tzc = _pack_zc(inp.tzone, inp.tcap)                           # [K]
    azc = _pack_zc(inp.azone, inp.acap)                           # [C]
    n_fresh_all = _fresh_fit_counts(cap_eff, inp.req)             # [C, K]
    fresh_mask_all = compat & _joint_ok(azc[:, None] & tzc[None, :]) & open_allowed
    if objective == "price":
        price_ck, has_res_ck = _class_type_price(inp)
    else:
        price_ck = torch.zeros_like(n_fresh_all)
        has_res_ck = torch.zeros(n_fresh_all.shape, dtype=torch.bool, device=n_fresh_all.device)
    return ScanColumns(compat, fresh_mask_all, has_res_ck, n_fresh_all, price_ck, cap_eff, tzc)


def scan_operands(inp: SolveInputs, word_offsets: Tuple[int, ...], words: Tuple[int, ...],
                  objective: str, columns: Optional[ScanColumns] = None) -> Tuple[torch.Tensor, ...]:
    """The prologue: kernel A's eleven operands, in its argument order.
    `columns` are the prologue's results already computed (a mesh
    gathers them from its shards); None computes them here."""
    K = inp.cap.shape[0]
    if K % 32:
        raise ValueError(f"the fused scan needs k_pad % 32 == 0, got {K}")
    if columns is None:
        columns = scan_columns(inp, word_offsets, words, objective)
    return (
        inp.req.contiguous(), packing.pack_rows(columns.compat), packing.pack_rows(columns.fresh),
        packing.pack_rows(columns.has_res), columns.n_fresh.contiguous(),
        columns.price.contiguous(), inp.count.to(torch.int32).contiguous(),
        inp.env_count.to(torch.int32).contiguous(), _pack_zc(inp.azone, inp.acap),
        columns.cap_eff.contiguous(), columns.tzc,
    )


def solve_scan(inp: SolveInputs, *, g_max: int, word_offsets, words, objective: str = "price",
               columns: Optional[ScanColumns] = None):
    """Prologue + kernel A: (take, unplaced, n_open, gmask_bits, gzc)."""
    ops = scan_operands(inp, word_offsets, words, objective, columns)
    return ffd_scan.fused_scan(*ops, g_max=g_max, objective=objective)


# -- the epilogue -----------------------------------------------------------


def nnz_budget(c_pad: int, g_max: int) -> int:
    """Static sparse-take budget (the JAX package's formula): FFD
    placements are near-diagonal, so c_pad + 4*g_max never trips in
    practice; an overflow refetches densely."""
    return c_pad + 4 * g_max


def _sparse_take(take: torch.Tensor, nnz_max: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(idx, val, nnz): the first nnz_max nonzeros of take.ravel() in
    ascending row-major order, -1 index padding, 0 value padding, and the
    TRUE nonzero count -- a cumsum plus a scatter into fixed slots, with
    no host synchronisation (jnp.nonzero(size=...) in the JAX package)."""
    flat = take.reshape(-1)
    nz = flat != 0
    nnz_true = nz.sum(dtype=torch.int32)
    pos = torch.cumsum(nz, 0) - 1                                  # slot of each nonzero
    keep = nz & (pos < nnz_max)
    slot = torch.where(keep, pos, nnz_max)                         # the rest land in a dump slot
    src = torch.arange(flat.shape[0], dtype=torch.int32, device=flat.device)
    idx = torch.full((nnz_max + 1,), -1, dtype=torch.int32, device=flat.device)
    val = torch.zeros((nnz_max + 1,), dtype=torch.int32, device=flat.device)
    idx.scatter_(0, slot, torch.where(keep, src, -1))
    val.scatter_(0, slot, torch.where(keep, flat, 0))
    return idx[:nnz_max], val[:nnz_max], nnz_true


def ffd_solve_fused(inp: SolveInputs, *, g_max: int, nnz_max: int, word_offsets, words,
                    objective: str = "price", columns: Optional[ScanColumns] = None) -> torch.Tensor:
    """The whole decision as ONE vector of 32-bit lanes (int32 holding the
    uint32 bits), laid out as the JAX package's ffd_solve_fused:
        [0]                  nnz (true sparse count)
        [1]                  n_open
        [2 : 2+C]            unplaced
        [2+C : 2+C+N]        idx   (-1 pads)
        [2+C+N : 2+C+2N]     val
        [... : +G*K/32]      gmask_bits
        [... : +G]           gzc
    """
    take, unplaced, n_open, gmask_bits, gzc = solve_scan(
        inp, g_max=g_max, word_offsets=word_offsets, words=words, objective=objective,
        columns=columns)
    idx, val, nnz_true = _sparse_take(take, nnz_max)
    return torch.cat([
        nnz_true.reshape(1), n_open.reshape(1).to(torch.int32), unplaced,
        idx, val, gmask_bits.reshape(-1), gzc,
    ])


def _unpack_zc(gzc: torch.Tensor, Z: int, CTn: int) -> Tuple[torch.Tensor, torch.Tensor]:
    dev = gzc.device
    gzone = ((gzc[:, None] >> torch.arange(Z, dtype=torch.int32, device=dev)) & 1) != 0
    cshift = torch.arange(_CT_SHIFT, _CT_SHIFT + CTn, dtype=torch.int32, device=dev)
    gcap = ((gzc[:, None] >> cshift) & 1) != 0
    return gzone, gcap


def ffd_solve(inp: SolveInputs, *, g_max: int, word_offsets, words, objective: str = "price",
              columns: Optional[ScanColumns] = None) -> SolveOutputs:
    """The dense decision on the device (the sidecar's `solve` op).
    `accum` is the per-group sum of take x req, accumulated in float64
    and rounded once: every partial sum of the JAX scan's float32 carry is
    an exact small integer (encode.py scaling), so the two are equal."""
    take, unplaced, n_open, gmask_bits, gzc = solve_scan(
        inp, g_max=g_max, word_offsets=word_offsets, words=words, objective=objective,
        columns=columns)
    K = inp.cap.shape[0]
    if columns is not None:
        compat = columns.compat
    else:
        compat = _device_compat(inp, word_offsets, words) & packing.as_bool_mask(inp.join_allowed, K)
    accum = torch.matmul(take.T.to(torch.float64), inp.req.to(torch.float64)).to(torch.float32)
    gzone, gcap = _unpack_zc(gzc, inp.tzone.shape[1], inp.tcap.shape[1])
    return SolveOutputs(
        take=take, unplaced=unplaced, n_open=n_open.reshape(()).to(torch.int32), accum=accum,
        gmask=packing.unpack_rows(gmask_bits, K), gzone=gzone, gcap=gcap, compat=compat,
    )


def ffd_solve_compact(inp: SolveInputs, *, g_max: int, nnz_max: int, word_offsets, words,
                      objective: str = "price",
                      columns: Optional[ScanColumns] = None) -> CompactDecision:
    """The compact decision on the device (the sidecar's `solve_compact`
    and `solve_delta` ops): kernel A's outputs with the take sparsified."""
    take, unplaced, n_open, gmask_bits, gzc = solve_scan(
        inp, g_max=g_max, word_offsets=word_offsets, words=words, objective=objective,
        columns=columns)
    idx, val, nnz_true = _sparse_take(take, nnz_max)
    return CompactDecision(
        idx=idx, val=val, nnz=nnz_true.reshape(()).to(torch.int32), unplaced=unplaced,
        n_open=n_open.reshape(()).to(torch.int32), gmask_bits=gmask_bits, gzc=gzc,
    )


def fetch_compact(dec: CompactDecision) -> Dict[str, np.ndarray]:
    """The compact decision on the host by field name, packed lanes as
    uint32 (the JAX package's dtypes): one fused copy off the device."""
    lanes = torch.cat([t.reshape(-1).to(torch.int32) for t in dec]).cpu().numpy()
    out, off = {}, 0
    for name, t in zip(CompactDecision._fields, dec):
        n = t.numel()
        a = lanes[off: off + n].reshape(tuple(t.shape))
        out[name] = a.view(np.uint32) if name in ("gmask_bits", "gzc") else a
        off += n
    return out


def expand_compact(dec, C: int, G: int, K: int, Z: int, CTn: int):
    """Host-side (numpy) expansion of a fetched CompactDecision into the
    dense (take, unplaced, n_open, gmask, gzone, gcap) decode inputs
    (copy of the JAX package's). Returns None when nnz overflowed the
    static budget (dense refetch)."""
    idx = np.asarray(dec.idx)
    if int(dec.nnz) > idx.shape[0]:
        return None
    take = np.zeros((C * G,), dtype=np.int32)
    valid = idx >= 0
    take[idx[valid]] = np.asarray(dec.val)[valid]
    take = take.reshape(C, G)
    bits = np.asarray(dec.gmask_bits)                             # [G, K/32]
    gmask = (
        (bits[:, :, None] >> np.arange(32, dtype=np.uint32)) & 1
    ).astype(bool).reshape(G, K)
    gzone, gcap = _unpack_zc_np(np.asarray(dec.gzc), Z, CTn)
    return take, np.asarray(dec.unplaced), int(dec.n_open), gmask, gzone, gcap


def fetch_fused(buf: torch.Tensor) -> np.ndarray:
    """The one device->host copy of a tick: the fused lanes as uint32."""
    return buf.cpu().numpy().view(np.uint32)


def _unpack_zc_np(gzc: np.ndarray, Z: int, CTn: int) -> Tuple[np.ndarray, np.ndarray]:
    gzone = ((gzc[:, None] >> np.arange(Z, dtype=np.uint32)) & 1) != 0
    gcap = ((gzc[:, None] >> np.arange(_CT_SHIFT, _CT_SHIFT + CTn, dtype=np.uint32)) & 1) != 0
    return gzone, gcap


def expand_fused(buf: np.ndarray, C: int, G: int, K: int, Z: int, CTn: int, nnz_max: int):
    """Host-side split of the fused u32 vector into the dense decode
    inputs (take, unplaced, n_open, gmask, gzone, gcap); None on sparse
    overflow (copy of the JAX package's expand_fused)."""
    buf = np.asarray(buf)
    kw = K // 32
    expect = 2 + C + 2 * nnz_max + G * kw + G
    if buf.size != expect:
        raise ValueError(
            f"expand_fused: buffer has {buf.size} lanes, geometry "
            f"(C={C}, G={G}, K={K}, nnz_max={nnz_max}) expects {expect}")
    nnz = int(buf[0])
    if nnz > nnz_max:
        return None
    off = 2
    unplaced = buf[off: off + C].view(np.int32); off += C
    idx = buf[off: off + nnz_max].view(np.int32); off += nnz_max
    val = buf[off: off + nnz_max].view(np.int32); off += nnz_max
    gmask_bits = buf[off: off + G * kw].reshape(G, kw); off += G * kw
    gzc = buf[off: off + G]
    take = np.zeros((C * G,), dtype=np.int32)
    valid = idx >= 0
    take[idx[valid]] = val[valid]
    gzone, gcap = _unpack_zc_np(gzc, Z, CTn)
    return (take.reshape(C, G), unplaced, int(buf[1]),
            packing.unpack_mask(gmask_bits, K), gzone, gcap)


def dense_tuple(scan, K: int, Z: int, CTn: int):
    """Kernel A's outputs (solve_scan) fetched to the host as the dense
    decode tuple (take, unplaced, n_open, gmask, gzone, gcap)."""
    take, unplaced, n_open, gmask_bits, gzc = scan
    gzone, gcap = _unpack_zc_np(gzc.cpu().numpy().view(np.uint32), Z, CTn)
    return (
        take.cpu().numpy(), unplaced.cpu().numpy(), int(n_open),
        packing.unpack_mask(gmask_bits.cpu().numpy().view(np.uint32), K), gzone, gcap,
    )


def solve_dense_tuple(inp: SolveInputs, *, g_max: int, word_offsets, words, objective: str = "price"):
    """The dense decision fetched to the host as the decode tuple -- the
    refetch when the fused buffer's sparse budget overflowed. Runs the
    scan again (a second kernel launch) and fetches its outputs whole."""
    scan = solve_scan(inp, g_max=g_max, word_offsets=word_offsets, words=words, objective=objective)
    return dense_tuple(scan, inp.cap.shape[0], inp.tzone.shape[1], inp.tcap.shape[1])

