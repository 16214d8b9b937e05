"""Copy of karpenter_tpu/providers/pricing/__init__.py, imports rewritten to the port's."""
from karpenter_tpu_torch.providers.pricing.provider import PricingProvider

__all__ = ["PricingProvider"]
