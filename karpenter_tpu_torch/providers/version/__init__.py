"""Copy of karpenter_tpu/providers/version/__init__.py, imports rewritten to the port's."""
from karpenter_tpu_torch.providers.version.provider import VersionProvider

__all__ = ["VersionProvider"]
