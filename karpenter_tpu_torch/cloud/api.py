"""Abstract cloud API interfaces.

The seam the reference cuts at pkg/aws/sdk.go:1-75 (EC2API/EKSAPI/PricingAPI/
SQSAPI/SSMAPI/IAMAPI): providers depend on these interfaces only, so the
in-memory emulator (karpenter_tpu_torch.kwok.cloud) and any real backend are
interchangeable. Methods mirror the call surface the reference providers
actually use, not whole cloud SDKs.

Copy of karpenter_tpu/cloud/api.py, imports rewritten to the port's.
"""
from __future__ import annotations

import abc
from typing import Dict, List, Optional, Sequence

from karpenter_tpu_torch.cloud.types import (
    CapacityReservationInfo,
    CloudInstance,
    FleetRequest,
    FleetResult,
    ImageInfo,
    InstanceTypeInfo,
    LaunchTemplateInfo,
    QueueMessage,
    SecurityGroupInfo,
    SubnetInfo,
    ZoneInfo,
)


class ComputeAPI(abc.ABC):
    """EC2-equivalent surface."""

    @abc.abstractmethod
    def describe_zones(self) -> List[ZoneInfo]: ...

    @abc.abstractmethod
    def describe_instance_types(self) -> List[InstanceTypeInfo]: ...

    @abc.abstractmethod
    def describe_instance_type_offerings(self) -> Dict[str, List[str]]:
        """instance type name -> zone names where offered."""

    @abc.abstractmethod
    def describe_subnets(self) -> List[SubnetInfo]: ...

    @abc.abstractmethod
    def describe_security_groups(self) -> List[SecurityGroupInfo]: ...

    @abc.abstractmethod
    def describe_images(self) -> List[ImageInfo]: ...

    @abc.abstractmethod
    def describe_capacity_reservations(self) -> List[CapacityReservationInfo]: ...

    @abc.abstractmethod
    def create_fleet(self, request: FleetRequest) -> FleetResult: ...

    @abc.abstractmethod
    def describe_instances(self, ids: Sequence[str] = (), tag_filter: Optional[Dict[str, str]] = None) -> List[CloudInstance]: ...

    @abc.abstractmethod
    def terminate_instances(self, ids: Sequence[str]) -> List[str]:
        """Returns ids accepted for termination."""

    @abc.abstractmethod
    def create_tags(self, resource_id: str, tags: Dict[str, str]) -> None: ...

    # launch templates
    @abc.abstractmethod
    def create_launch_template(self, lt: LaunchTemplateInfo) -> LaunchTemplateInfo: ...

    @abc.abstractmethod
    def describe_launch_templates(self, names: Sequence[str] = ()) -> List[LaunchTemplateInfo]: ...

    @abc.abstractmethod
    def delete_launch_template(self, name: str) -> None: ...

    @abc.abstractmethod
    def spot_price_history(self) -> Dict[tuple, float]:
        """(instance_type, zone) -> current spot $/hr."""


class PricingAPI(abc.ABC):
    @abc.abstractmethod
    def on_demand_prices(self) -> Dict[str, float]:
        """instance type name -> $/hr."""


class QueueAPI(abc.ABC):
    """SQS-equivalent interruption feed (reference: pkg/providers/sqs)."""

    @abc.abstractmethod
    def queue_url(self) -> str: ...

    @abc.abstractmethod
    def receive(self, max_messages: int = 10) -> List[QueueMessage]: ...

    @abc.abstractmethod
    def delete(self, receipt: str) -> None: ...

    @abc.abstractmethod
    def send(self, body: str) -> None: ...


class ParamStoreAPI(abc.ABC):
    """SSM-equivalent parameter store (image alias resolution)."""

    @abc.abstractmethod
    def get_parameter(self, name: str) -> Optional[str]: ...


class IdentityAPI(abc.ABC):
    """IAM-equivalent: instance profile lifecycle for spec.role."""

    @abc.abstractmethod
    def create_instance_profile(self, name: str, tags: Dict[str, str]) -> None: ...

    @abc.abstractmethod
    def get_instance_profile(self, name: str) -> Optional[Dict]: ...

    @abc.abstractmethod
    def delete_instance_profile(self, name: str) -> None: ...

    @abc.abstractmethod
    def add_role(self, profile_name: str, role: str) -> None: ...


class ClusterAPI(abc.ABC):
    """EKS-equivalent control-plane discovery (endpoint, version)."""

    @abc.abstractmethod
    def cluster_endpoint(self) -> str: ...

    @abc.abstractmethod
    def cluster_version(self) -> str: ...

    @abc.abstractmethod
    def cluster_ca_bundle(self) -> str: ...
