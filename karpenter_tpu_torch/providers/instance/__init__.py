"""Copy of karpenter_tpu/providers/instance/__init__.py, imports rewritten to the port's."""
from karpenter_tpu_torch.providers.instance.provider import InstanceProvider
from karpenter_tpu_torch.providers.instance import filters

__all__ = ["InstanceProvider", "filters"]
