"""The provisioning solve: encoding, the FFD solve around kernel A, the
repack around kernel B, and the TorchSolver facade (mirrors
karpenter_tpu/solver)."""
