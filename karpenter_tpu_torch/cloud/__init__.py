"""Copy of karpenter_tpu/cloud/__init__.py, imports rewritten to the port's."""
from karpenter_tpu_torch.cloud.types import (
    InstanceTypeInfo,
    ZoneInfo,
    SubnetInfo,
    SecurityGroupInfo,
    ImageInfo,
    CapacityReservationInfo,
    CloudInstance,
    FleetRequest,
    FleetOverride,
    FleetResult,
    FleetError,
    LaunchTemplateInfo,
    QueueMessage,
)
from karpenter_tpu_torch.cloud.api import ComputeAPI, PricingAPI, QueueAPI, ParamStoreAPI, IdentityAPI, ClusterAPI

__all__ = [
    "InstanceTypeInfo",
    "ZoneInfo",
    "SubnetInfo",
    "SecurityGroupInfo",
    "ImageInfo",
    "CapacityReservationInfo",
    "CloudInstance",
    "FleetRequest",
    "FleetOverride",
    "FleetResult",
    "FleetError",
    "LaunchTemplateInfo",
    "QueueMessage",
    "ComputeAPI",
    "PricingAPI",
    "QueueAPI",
    "ParamStoreAPI",
    "IdentityAPI",
    "ClusterAPI",
]
