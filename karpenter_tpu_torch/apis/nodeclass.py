"""TPUNodeClass: provider-specific node configuration.

The analogue of EC2NodeClass (reference: pkg/apis/v1/ec2nodeclass.go:31-605):
selector terms resolve cloud resources into status (subnets, security groups,
images, capacity reservations); userdata/image-family drive boot config; the
status block is the input contract for the catalog provider and launch path
(reference: nodeclass status consumed at
pkg/providers/instancetype/instancetype.go:129-171 and
pkg/providers/launchtemplate/launchtemplate.go:131-169).

Copy of karpenter_tpu/apis/nodeclass.py, imports rewritten to the port's.
"""
from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from karpenter_tpu_torch.apis.objects import APIObject

# status condition types (reference: EC2NodeClass conditions)
COND_SUBNETS_READY = "SubnetsReady"
COND_SECURITY_GROUPS_READY = "SecurityGroupsReady"
COND_IMAGES_READY = "ImagesReady"
COND_INSTANCE_PROFILE_READY = "InstanceProfileReady"
COND_CAPACITY_RESERVATIONS_READY = "CapacityReservationsReady"
COND_VALIDATION_SUCCEEDED = "ValidationSucceeded"
COND_READY = "Ready"
NODECLASS_CONDITIONS = [
    COND_SUBNETS_READY,
    COND_SECURITY_GROUPS_READY,
    COND_IMAGES_READY,
    COND_INSTANCE_PROFILE_READY,
    COND_VALIDATION_SUCCEEDED,
]

HASH_ANNOTATION = "karpenter.tpu/nodeclass-hash"
HASH_VERSION_ANNOTATION = "karpenter.tpu/nodeclass-hash-version"
HASH_VERSION = "v1"


@dataclass
class SelectorTerm:
    """Discovery selector: match by tags, by id, or by name."""

    tags: Dict[str, str] = field(default_factory=dict)
    id: str = ""
    name: str = ""

    def matches(self, *, id: str = "", name: str = "", tags: Optional[Dict[str, str]] = None) -> bool:
        if self.id:
            return self.id == id
        if self.name:
            return self.name == name
        if self.tags:
            tags = tags or {}
            return all(tags.get(k) == v or (v == "*" and k in tags) for k, v in self.tags.items())
        return False


@dataclass
class ImageSelectorTerm(SelectorTerm):
    alias: str = ""  # e.g. "standard@latest" (reference: AMI alias via SSM)


@dataclass
class SubnetStatus:
    id: str = ""
    zone: str = ""
    zone_id: str = ""


@dataclass
class SecurityGroupStatus:
    id: str = ""
    name: str = ""


@dataclass
class ImageStatus:
    id: str = ""
    name: str = ""
    requirements: list = field(default_factory=list)  # [Requirement]


@dataclass
class CapacityReservationStatus:
    id: str = ""
    instance_type: str = ""
    zone: str = ""
    owner_id: str = ""
    reservation_type: str = "default"  # default | capacity-block
    state: str = "active"
    end_time: Optional[float] = None
    available_count: int = 0


@dataclass
class KubeletConfiguration:
    max_pods: Optional[int] = None
    pods_per_core: Optional[int] = None
    system_reserved: Dict[str, str] = field(default_factory=dict)
    kube_reserved: Dict[str, str] = field(default_factory=dict)
    eviction_hard: Dict[str, str] = field(default_factory=dict)
    eviction_soft: Dict[str, str] = field(default_factory=dict)
    eviction_soft_grace_period: Dict[str, str] = field(default_factory=dict)
    cluster_dns: List[str] = field(default_factory=list)


@dataclass
class BlockDeviceMapping:
    device_name: str = "/dev/xvda"
    volume_size_gib: int = 20
    volume_type: str = "ssd"
    iops: Optional[int] = None
    throughput: Optional[int] = None
    encrypted: bool = True
    delete_on_termination: bool = True


class TPUNodeClass(APIObject):
    KIND = "TPUNodeClass"

    def __init__(
        self,
        name: str = "default",
        image_family: str = "Standard",
        image_selector_terms: Optional[List[ImageSelectorTerm]] = None,
        subnet_selector_terms: Optional[List[SelectorTerm]] = None,
        security_group_selector_terms: Optional[List[SelectorTerm]] = None,
        capacity_reservation_selector_terms: Optional[List[SelectorTerm]] = None,
        role: str = "default-node-role",
        instance_profile: str = "",
        user_data: str = "",
        tags: Optional[Dict[str, str]] = None,
        kubelet: Optional[KubeletConfiguration] = None,
        block_device_mappings: Optional[List[BlockDeviceMapping]] = None,
        metadata_http_tokens: str = "required",
        associate_public_ip: Optional[bool] = None,
    ):
        super().__init__(name=name)
        self.image_family = image_family
        self.image_selector_terms = image_selector_terms or [ImageSelectorTerm(alias="standard@latest")]
        self.subnet_selector_terms = subnet_selector_terms or [SelectorTerm(tags={"karpenter.tpu/discovery": "*"})]
        self.security_group_selector_terms = security_group_selector_terms or [SelectorTerm(tags={"karpenter.tpu/discovery": "*"})]
        self.capacity_reservation_selector_terms = capacity_reservation_selector_terms or []
        self.role = role
        self.instance_profile = instance_profile
        self.user_data = user_data
        self.tags = tags or {}
        self.kubelet = kubelet or KubeletConfiguration()
        self.block_device_mappings = block_device_mappings or [BlockDeviceMapping()]
        self.metadata_http_tokens = metadata_http_tokens
        self.associate_public_ip = associate_public_ip

        # status (resolved by the nodeclass controller chain)
        self.status_subnets: List[SubnetStatus] = []
        self.status_security_groups: List[SecurityGroupStatus] = []
        self.status_images: List[ImageStatus] = []
        self.status_capacity_reservations: List[CapacityReservationStatus] = []
        self.status_instance_profile: str = ""

    def ready(self) -> bool:
        return self.status_conditions.is_true(COND_READY)

    def static_hash(self) -> str:
        """Hash of drift-relevant static fields (reference:
        pkg/controllers/nodeclass/hash/controller.go:1-119)."""
        payload = {
            "image_family": self.image_family,
            "role": self.role,
            "instance_profile": self.instance_profile,
            "user_data": self.user_data,
            "tags": self.tags,
            "metadata_http_tokens": self.metadata_http_tokens,
            "associate_public_ip": self.associate_public_ip,
            "block_device_mappings": [
                (b.device_name, b.volume_size_gib, b.volume_type, b.encrypted)
                for b in self.block_device_mappings
            ],
        }
        return hashlib.blake2b(
            json.dumps(payload, sort_keys=True).encode(), digest_size=8
        ).hexdigest()
