"""Seed discipline for the port: the convex tier's tie-break stream.

Copy of karpenter_tpu/seeding.py, cut to what the port has. The JAX
package fans one seed out to object names, intent tokens, uids, the
failpoint registry and the trace sampler as well; the port has none of
those yet, so `apply()` sets only the convex rounding's seed and
`snapshot()`/`restore()` carry only it. The streams are the JAX
package's: `random.Random` seeded with the same string draws the same
numbers in every process, so an applied seed gives both packages the
same type permutation in `solver/convex/rounding.py`.
"""
from __future__ import annotations

import random
from typing import Optional

# seed the convex rounding tie-break stream derives from; set by
# `apply()`, read through `convex_rng()` so a process that never called
# `apply()` still gets a deterministic stream (seed 0)
_convex_seed: Optional[int] = None


def seeded_rng(label: str, seed: int) -> random.Random:
    """A dedicated RNG stream for one consumer of the seed chain; the
    label is part of the derivation."""
    return random.Random(f"{label}:{seed}")


def convex_rng() -> random.Random:
    """A fresh RNG for the convex tier's rounding tie-breaks, derived
    from the applied seed (0 when `apply()` never ran). Fresh per call on
    purpose: every rounding pass starts from the stream's origin, so a
    tick's tie-breaks do not depend on how many ticks preceded it."""
    return seeded_rng("convex", _convex_seed if _convex_seed is not None else 0)


def apply(seed: Optional[int]) -> None:
    """Set the seed of the convex tie-break stream (None: the default)."""
    global _convex_seed
    _convex_seed = seed


def snapshot() -> tuple:
    """Capture every global `apply()` mutates."""
    return (_convex_seed,)


def restore(token: tuple) -> None:
    global _convex_seed
    (_convex_seed,) = token
