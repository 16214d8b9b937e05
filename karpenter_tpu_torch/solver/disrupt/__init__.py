"""Repack simulation over candidate sets (mirrors karpenter_tpu/solver/disrupt)."""
