"""Runtime witnesses of the port's device discipline (mirrors karpenter_tpu/analysis)."""
