"""Catalog providers (mirrors karpenter_tpu/providers)."""
