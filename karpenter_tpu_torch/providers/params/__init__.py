"""Copy of karpenter_tpu/providers/params/__init__.py, imports rewritten to the port's."""
from karpenter_tpu_torch.providers.params.provider import ParamStoreProvider

__all__ = ["ParamStoreProvider"]
