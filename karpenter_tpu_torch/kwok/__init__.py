"""Copy of karpenter_tpu/kwok/__init__.py, imports rewritten to the port's."""
from karpenter_tpu_torch.kwok.cloud import FakeCloud, RateLimiter

__all__ = ["FakeCloud", "RateLimiter"]
