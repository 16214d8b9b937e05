"""Raw cloud-facing data types.

These are the wire-shape analogues of the aws-sdk types the reference's shim
exposes (pkg/aws/sdk.go wraps EC2/EKS/Pricing/SQS/SSM/IAM clients): instance
type info as DescribeInstanceTypes returns it, fleet create requests as
CreateFleet consumes them, etc. Providers convert these into scheduling-aware
types; nothing below this layer knows about pods or NodePools.

Copy of karpenter_tpu/cloud/types.py, imports rewritten to the port's.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple


@dataclass
class ZoneInfo:
    name: str           # e.g. "us-central1-a"
    zone_id: str        # e.g. "uc1-az1"
    zone_type: str = "availability-zone"  # or "local-zone"


@dataclass
class InstanceTypeInfo:
    """Raw machine shape, as the cloud describes it (before overhead math)."""

    name: str                       # "m5.large"
    category: str                   # "m"
    family: str                     # "m5"
    generation: int                 # 5
    size: str                       # "large"
    vcpu: int
    memory_mib: int
    arch: str                       # "amd64" | "arm64"
    cpu_manufacturer: str           # "intel" | "amd" | "arm-native"
    sustained_clock_mhz: int = 3100
    hypervisor: str = "nitro"       # "nitro" | "xen" | "" (metal)
    bare_metal: bool = False
    burstable: bool = False
    network_gbps: float = 10.0
    ebs_gbps: float = 4.75
    max_network_interfaces: int = 4
    ipv4_per_interface: int = 15
    local_nvme_gib: int = 0
    gpu_name: str = ""
    gpu_manufacturer: str = ""
    gpu_count: int = 0
    gpu_memory_mib: int = 0
    accelerator_name: str = ""
    accelerator_manufacturer: str = ""
    accelerator_count: int = 0
    nic_count: int = 0              # EFA-like high-perf NICs
    encryption_in_transit: bool = True
    supported_usage_classes: Tuple[str, ...] = ("on-demand", "spot")
    zones: Tuple[str, ...] = ()     # zone names offering this type

    def eni_pod_limit(self, reserved_nics: int = 0) -> int:
        """ENI-limited pod density (reference: pkg/providers/instancetype/
        types.go:461-475: interfaces * (ipv4-1) + 2), minus interfaces
        reserved for high-perf NICs."""
        return (self.max_network_interfaces - reserved_nics) * (self.ipv4_per_interface - 1) + 2

    @property
    def max_pods_eni(self) -> int:
        return self.eni_pod_limit()


@dataclass
class SubnetInfo:
    id: str
    zone: str
    zone_id: str
    available_ip_count: int
    tags: Dict[str, str] = field(default_factory=dict)


@dataclass
class SecurityGroupInfo:
    id: str
    name: str
    tags: Dict[str, str] = field(default_factory=dict)


@dataclass
class ImageInfo:
    id: str
    name: str
    arch: str                      # "amd64" | "arm64"
    family: str = "Standard"
    creation_time: float = 0.0
    deprecated: bool = False
    tags: Dict[str, str] = field(default_factory=dict)


@dataclass
class CapacityReservationInfo:
    id: str
    instance_type: str
    zone: str
    total_count: int
    available_count: int
    owner_id: str = "self"
    reservation_type: str = "default"    # "default" | "capacity-block"
    state: str = "active"                # "active" | "expiring"
    start_time: float = 0.0
    end_time: Optional[float] = None
    instance_match_criteria: str = "targeted"
    tags: Dict[str, str] = field(default_factory=dict)


@dataclass
class LaunchTemplateInfo:
    id: str
    name: str
    image_id: str
    security_group_ids: List[str]
    user_data: str = ""
    tags: Dict[str, str] = field(default_factory=dict)
    metadata_http_tokens: str = "required"
    block_devices: List[dict] = field(default_factory=list)
    instance_profile: str = ""
    capacity_reservation_id: Optional[str] = None
    nic_count: int = 0
    created_at: float = 0.0


@dataclass
class FleetOverride:
    """One (instance type x subnet) launch alternative inside a fleet request
    (reference: getOverrides pkg/providers/instance/instance.go:392-439)."""

    instance_type: str
    subnet_id: str
    zone: str
    priority: float = 0.0           # lower = preferred (capacity-optimized-prioritized)
    image_id: str = ""
    capacity_reservation_id: Optional[str] = None


@dataclass
class FleetRequest:
    launch_template_name: str
    capacity_type: str              # "spot" | "on-demand" | "reserved"
    overrides: List[FleetOverride]
    target_capacity: int = 1
    tags: Dict[str, str] = field(default_factory=dict)
    context: str = ""
    # idempotency client tokens, one per capacity slot (the EC2 ClientToken
    # analogue, minted by the provisioning journal): a replayed slot whose
    # token already backs a live instance returns THAT instance instead of
    # launching a second. Deliberately outside the batcher's bucket hash --
    # identical requests still merge, the merged call carries the union of
    # tokens slot-aligned (batcher/cloud.py).
    client_tokens: Tuple[Optional[str], ...] = ()


@dataclass
class FleetError:
    """Per-override launch failure (reference parses these into the ICE cache:
    pkg/providers/instance/instance.go:441-484)."""

    code: str                       # e.g. "InsufficientInstanceCapacity"
    message: str
    instance_type: str = ""
    zone: str = ""
    capacity_type: str = ""


@dataclass
class CloudInstance:
    id: str
    instance_type: str
    zone: str
    subnet_id: str
    capacity_type: str
    image_id: str
    state: str = "running"          # pending|running|shutting-down|terminated|stopped
    launch_time: float = 0.0
    tags: Dict[str, str] = field(default_factory=dict)
    capacity_reservation_id: Optional[str] = None
    provider_id: str = ""
    nic_count: int = 0
    security_group_ids: List[str] = field(default_factory=list)
    # fault injection (kwok rig): a degraded-but-running instance surfaces
    # this condition type as False on its Node (repair-path exercise)
    impaired_condition: str = ""

    def __post_init__(self):
        if not self.provider_id:
            self.provider_id = f"tpu:///{self.zone}/{self.id}"


@dataclass
class FleetResult:
    instances: List[CloudInstance]
    errors: List[FleetError]


@dataclass
class QueueMessage:
    id: str
    receipt: str
    body: str                       # JSON payload
