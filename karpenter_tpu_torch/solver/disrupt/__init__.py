"""The consolidation engine (the disruption solve) on the card.

Counterpart of karpenter_tpu/solver/disrupt/: the batched candidate-set
evaluator the disruption controller drives. It fit-checks every evicted
pod of every candidate set (singletons, price-ranked multi-node prefixes,
underutilized pairs) against the surviving capacity, through kernel B, and
against the replacement instance-type options, and returns per-set
verdicts (delete / replace-cheaper / blocked, with replacement type and
savings) from one sweep.

- ``kernel.py`` -- ``disrupt_repack`` (kernel B) and ``disrupt_replace``;
- ``engine.py`` -- ``DisruptEngine``: host-side encoding, the
  candidate-set enumeration helpers and the local route.

``solver/consolidate.py`` re-exports this package's public names.
"""
from karpenter_tpu_torch.solver.disrupt.engine import (  # noqa: F401
    DisruptEngine,
    SetVerdict,
    device_eligible,
    enumerate_pairs,
)
