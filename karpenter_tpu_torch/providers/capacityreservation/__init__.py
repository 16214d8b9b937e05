"""Copy of karpenter_tpu/providers/capacityreservation/__init__.py, imports rewritten to the port's."""
from karpenter_tpu_torch.providers.capacityreservation.provider import CapacityReservationProvider

__all__ = ["CapacityReservationProvider"]
