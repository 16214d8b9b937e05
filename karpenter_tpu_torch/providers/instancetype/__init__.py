"""Copy of karpenter_tpu/providers/instancetype/__init__.py, imports rewritten to the port's."""
from karpenter_tpu_torch.providers.instancetype.types import InstanceType, Offering, Resolver
from karpenter_tpu_torch.providers.instancetype.provider import InstanceTypeProvider

__all__ = ["InstanceType", "Offering", "Resolver", "InstanceTypeProvider"]
