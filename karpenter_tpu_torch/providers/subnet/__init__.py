"""Copy of karpenter_tpu/providers/subnet/__init__.py, imports rewritten to the port's."""
from karpenter_tpu_torch.providers.subnet.provider import SubnetProvider

__all__ = ["SubnetProvider"]
