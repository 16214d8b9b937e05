"""Well-known label vocabulary.

Copy of karpenter_tpu/apis/labels.py.

Mirrors the label surface the reference exposes so users can express the same
constraints (reference: pkg/apis/v1/labels.go; the ~30 scheduling labels
computed per instance type at pkg/providers/instancetype/types.go:158-292).
Domain names are ours (karpenter.tpu / karpenter.sh core vocabulary kept for
portability of NodePool specs).
"""
from __future__ import annotations

# core (karpenter.sh) vocabulary -- kept verbatim so reference NodePool specs
# port over unchanged.
CORE_GROUP = "karpenter.sh"
NODEPOOL_LABEL = f"{CORE_GROUP}/nodepool"
CAPACITY_TYPE_LABEL = f"{CORE_GROUP}/capacity-type"
DO_NOT_DISRUPT_ANNOTATION = f"{CORE_GROUP}/do-not-disrupt"
NODEPOOL_HASH_ANNOTATION = f"{CORE_GROUP}/nodepool-hash"
NODEPOOL_HASH_VERSION_ANNOTATION = f"{CORE_GROUP}/nodepool-hash-version"
REGISTERED_LABEL = f"{CORE_GROUP}/registered"
INITIALIZED_LABEL = f"{CORE_GROUP}/initialized"
DISRUPTED_TAINT_KEY = f"{CORE_GROUP}/disrupted"
UNREGISTERED_TAINT_KEY = f"{CORE_GROUP}/unregistered"

CAPACITY_TYPE_SPOT = "spot"
CAPACITY_TYPE_ON_DEMAND = "on-demand"
CAPACITY_TYPE_RESERVED = "reserved"
CAPACITY_TYPES = (CAPACITY_TYPE_RESERVED, CAPACITY_TYPE_SPOT, CAPACITY_TYPE_ON_DEMAND)

# k8s upstream vocabulary
INSTANCE_TYPE_LABEL = "node.kubernetes.io/instance-type"
ZONE_LABEL = "topology.kubernetes.io/zone"
REGION_LABEL = "topology.kubernetes.io/region"
HOSTNAME_LABEL = "kubernetes.io/hostname"
ARCH_LABEL = "kubernetes.io/arch"
OS_LABEL = "kubernetes.io/os"

# provider vocabulary (reference: pkg/apis/v1/labels.go LabelInstance*)
GROUP = "karpenter.tpu"
LABEL_INSTANCE_CATEGORY = f"{GROUP}/instance-category"
LABEL_INSTANCE_FAMILY = f"{GROUP}/instance-family"
LABEL_INSTANCE_GENERATION = f"{GROUP}/instance-generation"
LABEL_INSTANCE_SIZE = f"{GROUP}/instance-size"
LABEL_INSTANCE_CPU = f"{GROUP}/instance-cpu"
LABEL_INSTANCE_CPU_MANUFACTURER = f"{GROUP}/instance-cpu-manufacturer"
LABEL_INSTANCE_MEMORY = f"{GROUP}/instance-memory"          # MiB, like reference
LABEL_INSTANCE_NETWORK_BANDWIDTH = f"{GROUP}/instance-network-bandwidth"
LABEL_INSTANCE_EBS_BANDWIDTH = f"{GROUP}/instance-ebs-bandwidth"
LABEL_INSTANCE_HYPERVISOR = f"{GROUP}/instance-hypervisor"
LABEL_INSTANCE_ENCRYPTION_IN_TRANSIT = f"{GROUP}/instance-encryption-in-transit-supported"
LABEL_INSTANCE_LOCAL_NVME = f"{GROUP}/instance-local-nvme"
LABEL_INSTANCE_GPU_NAME = f"{GROUP}/instance-gpu-name"
LABEL_INSTANCE_GPU_MANUFACTURER = f"{GROUP}/instance-gpu-manufacturer"
LABEL_INSTANCE_GPU_COUNT = f"{GROUP}/instance-gpu-count"
LABEL_INSTANCE_GPU_MEMORY = f"{GROUP}/instance-gpu-memory"
LABEL_INSTANCE_ACCELERATOR_NAME = f"{GROUP}/instance-accelerator-name"
LABEL_INSTANCE_ACCELERATOR_MANUFACTURER = f"{GROUP}/instance-accelerator-manufacturer"
LABEL_INSTANCE_ACCELERATOR_COUNT = f"{GROUP}/instance-accelerator-count"
LABEL_NODECLASS = f"{GROUP}/nodeclass"
LABEL_CAPACITY_RESERVATION_ID = f"{GROUP}/capacity-reservation-id"
LABEL_CAPACITY_RESERVATION_TYPE = f"{GROUP}/capacity-reservation-type"
LABEL_ZONE_ID = f"topology.{GROUP}/zone-id"

# Labels a NodePool requirement may reference that the provider computes per
# instance type. The scheduler treats membership here as "resolvable from the
# catalog" (the core's WellKnownLabels set).
WELL_KNOWN_LABELS = frozenset(
    {
        NODEPOOL_LABEL,
        CAPACITY_TYPE_LABEL,
        INSTANCE_TYPE_LABEL,
        ZONE_LABEL,
        REGION_LABEL,
        ARCH_LABEL,
        OS_LABEL,
        LABEL_INSTANCE_CATEGORY,
        LABEL_INSTANCE_FAMILY,
        LABEL_INSTANCE_GENERATION,
        LABEL_INSTANCE_SIZE,
        LABEL_INSTANCE_CPU,
        LABEL_INSTANCE_CPU_MANUFACTURER,
        LABEL_INSTANCE_MEMORY,
        LABEL_INSTANCE_NETWORK_BANDWIDTH,
        LABEL_INSTANCE_EBS_BANDWIDTH,
        LABEL_INSTANCE_HYPERVISOR,
        LABEL_INSTANCE_ENCRYPTION_IN_TRANSIT,
        LABEL_INSTANCE_LOCAL_NVME,
        LABEL_INSTANCE_GPU_NAME,
        LABEL_INSTANCE_GPU_MANUFACTURER,
        LABEL_INSTANCE_GPU_COUNT,
        LABEL_INSTANCE_GPU_MEMORY,
        LABEL_INSTANCE_ACCELERATOR_NAME,
        LABEL_INSTANCE_ACCELERATOR_MANUFACTURER,
        LABEL_INSTANCE_ACCELERATOR_COUNT,
        LABEL_CAPACITY_RESERVATION_ID,
        LABEL_CAPACITY_RESERVATION_TYPE,
        LABEL_ZONE_ID,
        HOSTNAME_LABEL,
    }
)

# Domains users may not set labels under directly (reference RestrictedLabelDomains)
RESTRICTED_LABEL_DOMAINS = frozenset({GROUP, CORE_GROUP})
