"""Copy of karpenter_tpu/batcher/__init__.py, imports rewritten to the port's."""
from karpenter_tpu_torch.batcher.batcher import Batcher, BatchOptions

__all__ = ["Batcher", "BatchOptions"]
