"""Edge-case inputs that hold the kernels against their plain versions.

The rows a kernel skips -- kernel A's no-op classes (compat and fresh
words all zero), kernel B's classes with an empty feasibility row --
placed between real classes, classes that request nothing, whose int32
prefix sums wrap, and worlds whose groups keep hundreds of surviving
types (kernel A's wide steps). The class-set builders take a PodClassSet
of either package (they touch only its row arrays), so one definition
serves the CPU tests against the JAX package, the card-only tests and
`chip_smoke.py`. Nothing on the solve path imports this module.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

# every per-class row of a PodClassSet (`allowed` is a list of per-dim arrays)
ROW_FIELDS = (
    "req", "count", "env_count", "num_lo", "num_hi", "azone", "acap", "schedulable",
    "open_allowed", "join_allowed", "base_req",
)


def take_rows(cs, idx):
    """The class set made of rows `idx` of `cs` (repeats allowed), with
    copies of the rows."""
    idx = np.asarray(idx)
    rows = {f: None if getattr(cs, f) is None else np.array(np.asarray(getattr(cs, f))[idx])
            for f in ROW_FIELDS}
    rows["allowed"] = [np.asarray(a)[idx] for a in cs.allowed]
    return dataclasses.replace(cs, c_real=len(idx), c_pad=len(idx), **rows)


def padded_between(cs, pad_count=3):
    """Two padding rows after every real class (kernel A's no-op steps in
    the middle of the scan), C rounded up to a multiple of 32; every other
    padding row carries `pad_count` pods, which must come back as unplaced."""
    pad = cs.c_pad - 1
    if pad < cs.c_real or cs.schedulable[pad]:
        raise ValueError("padded_between: the class set has no padding row")
    idx = [i for c in range(cs.c_real) for i in (c, pad, pad)]
    idx += [pad] * (-len(idx) % 32)
    out = take_rows(cs, idx)
    out.count[2::6] = pad_count
    return out


def zero_request(cs, c, count=None):
    """Class c requests nothing: every open group it joins fits INT32_MAX
    of its pods, so the prefix sum over the groups wraps."""
    out = take_rows(cs, np.arange(cs.c_pad))
    out.req[c] = 0.0
    if count is not None:
        out.count[c] = count
    return out


def wide_groups(cs, count=3, every=2):
    """Every `every`-th real class takes the max-fit envelope (env_count 0,
    as a zone-spread sub-class does) and carries `count` pods, so the group
    it opens keeps every compatible type that holds them -- hundreds on
    the 627-type catalog; the classes between keep their rows (narrow
    groups under the price objective), so later steps join wide and narrow
    groups at once. Under the fit objective every class opens that way."""
    out = take_rows(cs, np.arange(cs.c_pad))
    rows = np.arange(0, cs.c_real, every)
    out.env_count[rows] = 0
    out.count[rows] = count
    return out


def every_type(scan_ops, count=2):
    """Kernel A's operands with every real class compatible with and fresh
    on every one of the K columns, each column the largest type's
    capacity (so every fit ties across the types) and joinable in every
    zone and capacity type, n_fresh recomputed from them, `count` pods a
    class: under the fit objective each class's group keeps all K types."""
    from karpenter_tpu_torch.solver.kernels import ffd_scan

    req, compat_w, fresh_w, hasres_w, n_fresh, price, cnt, env, azc, cap_eff, tzc = (
        t.clone() for t in scan_ops)
    real = torch.tensor(real_classes(scan_ops), dtype=torch.long, device=req.device)
    compat_w[real] = -1
    fresh_w[real] = -1
    azc[real] = -1
    tzc.fill_(-1)
    cap_eff.copy_(cap_eff[int(cap_eff[:, 0].argmax())].expand_as(cap_eff))
    zero = torch.zeros((1, req.shape[1]), dtype=req.dtype, device=req.device)
    for c in real.tolist():
        n_fresh[c] = ffd_scan.fit_counts(cap_eff, zero, req[c])[0]
    price[real] = torch.where(torch.isfinite(price[real]), price[real], 1.0)
    cnt[real] = count
    return req, compat_w, fresh_w, hasres_w, n_fresh, price, cnt, env, azc, cap_eff, tzc


def open_widths(scan_ops, c, g_max, objective):
    """Surviving types of each open group at the start of class c's step
    (the plain scan of the rows before it)."""
    from karpenter_tpu_torch.solver import packing
    from karpenter_tpu_torch.solver.kernels import ffd_scan

    head = tuple(t[:c] for t in scan_ops[:9]) + tuple(scan_ops[9:])
    _, _, n_open, gmask_bits, _ = ffd_scan.fused_scan_reference(*head, g_max=g_max, objective=objective)
    return packing.unpack_rows(gmask_bits[: int(n_open)], scan_ops[9].shape[0]).sum(1)


def first_mixed_step(scan_ops, g_max, objective):
    """The first real class (after the first) whose step meets a narrow
    and a wide open group at once, or None."""
    from karpenter_tpu_torch.solver.kernels.ffd_scan import NARROW_TYPES

    for c in real_classes(scan_ops)[1:]:
        widths = open_widths(scan_ops, c, g_max, objective)
        if bool((widths > NARROW_TYPES).any() and (widths <= NARROW_TYPES).any()):
            return c
    return None


def real_classes(scan_ops) -> list:
    """Rows of kernel A's operands whose compat or fresh words are not all
    zero (the others are no-op steps)."""
    compat_w, fresh_w = scan_ops[1], scan_ops[2]
    return torch.nonzero((compat_w != 0).any(1) | (fresh_w != 0).any(1)).flatten().tolist()


def gap_repack(ops, seed=0):
    """Kernel B's operands with every third class infeasible everywhere
    but carrying 1..39 pods in every set (members drawn from `seed`)."""
    headroom0, feas, req, member, excl = (t.clone() for t in ops)
    feas[1::3] = False
    g = torch.Generator().manual_seed(seed)
    member.copy_(torch.randint(1, 40, tuple(member.shape), generator=g, dtype=torch.int32))
    return headroom0, feas, req, member, excl


def sparse_members(ops, density=0.07, pad=0.41, one_every=4, seed=0):
    """Kernel B's operands with a consolidation sweep's member counts: a
    (set, class) pair holds 1-5 pods with probability `density` (the
    `rampdown-sweep`'s stepping pairs are ~7 % of its real sets'), every
    `one_every`-th set holds pods of one class only, and the last `pad`
    share of the sets (the S bucket's padding) holds none. Members drawn
    from `seed`."""
    headroom0, feas, req, member, excl = (t.clone() for t in ops)
    S, C = member.shape
    g = torch.Generator().manual_seed(seed)
    pods = torch.randint(1, 6, (S, C), generator=g, dtype=torch.int32)
    keep = torch.rand((S, C), generator=g) < density
    single = torch.arange(S) % one_every == one_every - 1
    keep[single] = False
    keep[single, torch.randint(0, C, (S,), generator=g)[single]] = True
    keep[S - int(S * pad):] = False
    member.copy_(torch.where(keep, pods, 0))
    return headroom0, feas, req, member, excl


def sweep_cases(ops, seed=0):
    """name -> kernel B's operands for the sweep's edge cases, built from
    `ops` (S > 1 sets, a pods axis every class requests): the member-sparse
    world of `sparse_members`; padding sets only; one class a set; a class
    that requests nothing with member 0 in every set, feasible everywhere
    (its fits saturate, the prefix sum wraps and it places pods: it must
    take its step); a class with a negative request on every axis some
    class requests (no axis bounds any class's fits); member counts below
    zero, INT32_MIN among them (member - before wraps)."""
    sparse = sparse_members(ops, seed=seed)
    out = {"rampdown-like density": sparse,
           "padding sets only": sparse_members(ops, pad=1.0, seed=seed),
           "one class a set": sparse_members(ops, density=0.0, one_every=1, seed=seed)}
    headroom0, feas, req, member, excl = (t.clone() for t in sparse)
    c = int(torch.nonzero(feas.any(1)).flatten()[0])
    req[c] = 0.0
    feas[c] = True
    member[:, c] = 0
    out["zero-request class, member 0"] = (headroom0, feas, req, member, excl)
    headroom0, feas, req, member, excl = (t.clone() for t in sparse)
    req[c] = torch.where(req.amax(0) > 0, -2.0, 0.0)
    out["negative request axes"] = (headroom0, feas, req, member, excl)
    headroom0, feas, req, member, excl = (t.clone() for t in sparse)
    member[0::3, c] = -3
    member[1::5] = torch.where(member[1::5] > 0, -member[1::5], member[1::5])
    member[2, :] = -2**31
    out["members below zero"] = (headroom0, feas, req, member, excl)
    return out
