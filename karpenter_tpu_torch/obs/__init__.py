"""Observability of the port's solves (mirrors karpenter_tpu/obs)."""
