"""Seed discipline: the one fan-out from Options.seed to process RNGs.

Every RNG a trace replay can observe derives from one seed through this
module, each consumer under its own label so streams never alias:
generated object names (NodeClaim suffixes -> kwok node names), the
failpoint registry's per-site schedules, the trace sampler, and the
solver-wire breaker's backoff jitter (whose rng is injected where the
breaker is constructed -- `seeded_rng("breaker", seed)`).

`snapshot()`/`restore()` bracket the fan-out for embedders that build
seeded worlds inside a longer-lived process (the sim replay engine, bench
stages): the field list lives HERE, next to `apply()`, so the next RNG
added to the fan-out cannot silently escape the restore path.

Copy of karpenter_tpu/seeding.py, imports rewritten to the port's.
"""
from __future__ import annotations

import random
from typing import Optional

# seed the convex rounding tie-break stream derives from; set by
# `apply()`, read through `convex_rng()` so a process that never called
# `apply()` (unit tests, ad-hoc scripts) still gets a deterministic
# stream (seed 0) instead of ambient randomness
_convex_seed: Optional[int] = None


def seeded_rng(label: str, seed: int) -> random.Random:
    """A dedicated RNG stream for one consumer of the seed chain. The
    label is part of the derivation: the binary and the replay engine
    must use the SAME label for the same consumer or a recorded run and
    its replay stop sharing one seed chain."""
    return random.Random(f"{label}:{seed}")


def convex_rng() -> random.Random:
    """A fresh RNG for the convex tier's rounding tie-breaks, derived
    from the applied seed (0 when `apply()` never ran). Fresh per call
    ON PURPOSE: every rounding pass starts from the stream's origin, so
    tick N's tie-breaks do not depend on how many ticks preceded it --
    replay can round any tick in isolation."""
    return seeded_rng("convex", _convex_seed if _convex_seed is not None else 0)


def apply(seed: Optional[int]) -> None:
    """Fan one seed out to every process-global RNG on the replay path
    (None restores the production defaults where they exist). Process
    policy, like the tracer config: the last caller wins."""
    from karpenter_tpu_torch import tracing
    from karpenter_tpu_torch.apis.objects import (seed_intent_tokens,
                                            seed_object_names,
                                            seed_object_uids)
    from karpenter_tpu_torch.failpoints import FAILPOINTS

    global _convex_seed
    seed_object_names(seed)
    seed_intent_tokens(seed)
    seed_object_uids(seed)
    _convex_seed = seed
    if seed is not None:
        FAILPOINTS.seed = seed
        tracing.TRACER.configure(rng=seeded_rng("tracing", seed).random)


def snapshot() -> tuple:
    """Capture every global `apply()` mutates (plus the tracer's
    enabled/sample, which seeded embedders also reconfigure)."""
    from karpenter_tpu_torch import tracing
    from karpenter_tpu_torch.apis import objects
    from karpenter_tpu_torch.failpoints import FAILPOINTS

    return (
        objects._name_rng, objects._token_rng, objects._uid_rng,
        FAILPOINTS.seed,
        tracing.TRACER._rng, tracing.TRACER.enabled, tracing.TRACER.sample,
        _convex_seed,
    )


def restore(token: tuple) -> None:
    from karpenter_tpu_torch import tracing
    from karpenter_tpu_torch.apis import objects
    from karpenter_tpu_torch.failpoints import FAILPOINTS

    global _convex_seed
    (name_rng, token_rng, uid_rng, fp_seed,
     t_rng, t_enabled, t_sample, cx_seed) = token
    objects._name_rng = name_rng
    objects._token_rng = token_rng
    objects._uid_rng = uid_rng
    FAILPOINTS.seed = fp_seed
    _convex_seed = cx_seed
    tracing.TRACER.configure(enabled=t_enabled, sample=t_sample, rng=t_rng)
