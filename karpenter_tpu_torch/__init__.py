"""karpenter_tpu_torch: the provisioning system in PyTorch and CUDA.

A port of the JAX package `karpenter_tpu` to one NVIDIA H100. The module
layout mirrors the JAX package's paths; each module names its source.
The package imports torch and numpy, never jax and nothing of
`karpenter_tpu`: host modules it needs are copied in.

Entry points: `python -m karpenter_tpu_torch` (the operator binary, and
`sim replay`), `karpenter_tpu_torch.operator.Operator`, and the solver
`karpenter_tpu_torch.solver.service.TorchSolver`. Each runs on the card
unless the caller asks for the CPU (`--device cpu`, device="cpu").
"""
