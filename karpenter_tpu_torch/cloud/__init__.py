"""Raw cloud data types (mirrors karpenter_tpu/cloud)."""
