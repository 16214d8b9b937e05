"""Scheduling vocabulary (copy of karpenter_tpu/scheduling/__init__.py)."""
from karpenter_tpu_torch.scheduling.resources import Resources, parse_quantity, format_quantity
from karpenter_tpu_torch.scheduling.requirements import (
    Requirement,
    Requirements,
    Operator,
)
from karpenter_tpu_torch.scheduling.taints import Taint, Toleration, tolerates, tolerates_all

__all__ = [
    "Resources",
    "parse_quantity",
    "format_quantity",
    "Requirement",
    "Requirements",
    "Operator",
    "Taint",
    "Toleration",
    "tolerates",
    "tolerates_all",
]
