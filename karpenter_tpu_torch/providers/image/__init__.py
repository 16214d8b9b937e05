"""Copy of karpenter_tpu/providers/image/__init__.py, imports rewritten to the port's."""
from karpenter_tpu_torch.providers.image.provider import ImageProvider, ResolvedImage

__all__ = ["ImageProvider", "ResolvedImage"]
