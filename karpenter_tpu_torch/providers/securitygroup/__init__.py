"""Copy of karpenter_tpu/providers/securitygroup/__init__.py, imports rewritten to the port's."""
from karpenter_tpu_torch.providers.securitygroup.provider import SecurityGroupProvider

__all__ = ["SecurityGroupProvider"]
