"""karpenter_tpu_torch: the provisioning solver in PyTorch and CUDA.

A port of the JAX package `karpenter_tpu` to one NVIDIA H100. The module
layout mirrors the JAX package's paths; each module names its source.
The package imports torch and numpy, never jax and nothing of
`karpenter_tpu`: host modules it needs are copied in.

Entry point: `karpenter_tpu_torch.solver.service.TorchSolver`, which runs
on the card unless the caller passes device="cpu".
"""
