"""Convex global-solve tier: LP relaxation + deterministic rounding.

Copy of karpenter_tpu/solver/convex/ for ``TorchSolver(tier="convex")``:

- ``relax``    -- the LP relaxation on the device (projected subgradient
                  over the staged tensors) and its anytime lower bound,
                  which tightens ``solver/bound.py``'s gap
- ``rounding`` -- host-side bit-deterministic rounding to an integral
                  placement (seeded tie-breaks, None -> the FFD placement)
- ``tier``     -- the never-worse differential selection against FFD

The JAX package's ``repack`` (the global repack oracle) feeds only the
disruption controller, which the port does not have yet.
"""
from karpenter_tpu_torch.solver.convex import relax, rounding, tier  # noqa: F401
