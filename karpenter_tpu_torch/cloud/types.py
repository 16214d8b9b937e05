"""Raw cloud-facing data types the catalog is built from.

Trimmed copy of karpenter_tpu/cloud/types.py: the zone and raw
instance-type records. Fleet, subnet, image and queue records belong to
the cloud-provider slices.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple


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
        """ENI-limited pod density: interfaces * (ipv4-1) + 2, minus
        interfaces reserved for high-perf NICs."""
        return (self.max_network_interfaces - reserved_nics) * (self.ipv4_per_interface - 1) + 2
