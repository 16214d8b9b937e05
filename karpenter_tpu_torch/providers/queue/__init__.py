"""Copy of karpenter_tpu/providers/queue/__init__.py, imports rewritten to the port's."""
from karpenter_tpu_torch.providers.queue.provider import QueueProvider

__all__ = ["QueueProvider"]
