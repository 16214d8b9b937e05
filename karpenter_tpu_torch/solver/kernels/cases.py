"""Edge-case inputs that hold the kernels against their plain versions.

The rows a kernel skips -- kernel A's no-op classes (compat and fresh
words all zero), kernel B's classes with an empty feasibility row --
placed between real classes, and classes that request nothing, whose
int32 prefix sums wrap. The class-set builders take a PodClassSet of
either package (they touch only its row arrays), so one definition
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
