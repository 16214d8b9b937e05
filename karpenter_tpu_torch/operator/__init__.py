"""Copy of karpenter_tpu/operator/__init__.py, imports rewritten to the port's."""
from karpenter_tpu_torch.operator.operator import Operator, Options

__all__ = ["Operator", "Options"]
