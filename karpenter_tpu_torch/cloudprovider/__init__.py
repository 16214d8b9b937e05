"""Copy of karpenter_tpu/cloudprovider/__init__.py, imports rewritten to the port's."""
from karpenter_tpu_torch.cloudprovider.cloudprovider import CloudProvider, RepairPolicy

__all__ = ["CloudProvider", "RepairPolicy"]
