"""Copy of karpenter_tpu/providers/instanceprofile/__init__.py, imports rewritten to the port's."""
from karpenter_tpu_torch.providers.instanceprofile.provider import InstanceProfileProvider

__all__ = ["InstanceProfileProvider"]
