"""InstanceType model and Resolver.

Rebuilds the reference's conversion from raw cloud instance-type info into
scheduler-consumable InstanceTypes:

- ~30 scheduling requirements per type (reference: computeRequirements,
  pkg/providers/instancetype/types.go:158-292, incl. GPU/accelerator labels
  :252-273)
- capacity with VM-overhead-adjusted memory, ENI- or kubelet-limited pod
  density, local-NVMe ephemeral storage (computeCapacity types.go:313-331,
  ENI math :461-475)
- overhead = kube-reserved + system-reserved + eviction threshold
  (kube-reserved model types.go:492-522)
- offerings per (zone x capacity type) with price and availability
  (offering/offering.go:101-187)

Copy of karpenter_tpu/providers/instancetype/types.py, imports rewritten to the port's.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

from karpenter_tpu_torch.apis import labels as wk
from karpenter_tpu_torch.apis.nodeclass import TPUNodeClass
from karpenter_tpu_torch.cloud.types import InstanceTypeInfo
from karpenter_tpu_torch.scheduling import Operator, Requirement, Requirements, Resources
from karpenter_tpu_torch.scheduling import resources as res

GIB = 1024  # MiB
MIB = 2**20  # bytes

DEFAULT_VM_MEMORY_OVERHEAD_PERCENT = 0.075  # reference: options.go vm-memory-overhead-percent


@dataclass
class Offering:
    """One purchasable (capacity-type x zone) variant of an instance type."""

    capacity_type: str
    zone: str
    zone_id: str
    price: float
    available: bool = True
    reservation_id: Optional[str] = None
    reservation_capacity: int = 0

    def requirements(self) -> Requirements:
        reqs = Requirements(
            [
                Requirement(wk.CAPACITY_TYPE_LABEL, Operator.IN, [self.capacity_type]),
                Requirement(wk.ZONE_LABEL, Operator.IN, [self.zone]),
                Requirement(wk.LABEL_ZONE_ID, Operator.IN, [self.zone_id]),
            ]
        )
        if self.reservation_id:
            reqs.add(Requirement(wk.LABEL_CAPACITY_RESERVATION_ID, Operator.IN, [self.reservation_id]))
        return reqs


@dataclass
class InstanceType:
    name: str
    requirements: Requirements
    capacity: Resources
    overhead: Resources
    offerings: List[Offering] = field(default_factory=list)
    info: Optional[InstanceTypeInfo] = None
    _alloc_cache: Optional[Resources] = field(
        default=None, init=False, repr=False, compare=False)

    def allocatable(self) -> Resources:
        # memoized: the oracle's fit checks call this per (pod, node try)
        # -- thousands of times per tick -- and capacity/overhead are
        # immutable once the Resolver builds the type
        a = self._alloc_cache
        if a is None:
            a = self._alloc_cache = self.capacity - self.overhead
        return a

    def available_offerings(self) -> List[Offering]:
        return [o for o in self.offerings if o.available]

    def cheapest_price(self) -> float:
        prices = [o.price for o in self.available_offerings()]
        return min(prices) if prices else float("inf")

    def compatible_offerings(self, reqs: Requirements) -> List[Offering]:
        return [o for o in self.offerings if reqs.compatible(o.requirements())]


def kube_reserved_cpu_milli(vcpu: int) -> float:
    """Tiered CPU reservation: 6% of first core, 1% of second, 0.5% of the
    next two, 0.25% of the rest (the managed-node model the reference uses)."""
    milli = vcpu * 1000
    reserved = 0.0
    tiers = [(1000, 0.06), (1000, 0.01), (2000, 0.005), (float("inf"), 0.0025)]
    remaining = milli
    for span, frac in tiers:
        take = min(remaining, span)
        reserved += take * frac
        remaining -= take
        if remaining <= 0:
            break
    return reserved


def kube_reserved_memory_bytes(max_pods: int) -> float:
    """255 MiB + 11 MiB per pod slot."""
    return (255 + 11 * max_pods) * MIB


def pods_limit(info: InstanceTypeInfo, nodeclass: TPUNodeClass, reserved_nics: int = 0) -> int:
    """Pod density: kubelet maxPods wins, else pods-per-core cap, else the
    ENI-style limit (reference: types.go:461-490)."""
    kubelet = nodeclass.kubelet
    if kubelet.max_pods is not None:
        limit = kubelet.max_pods
    else:
        limit = info.eni_pod_limit(reserved_nics)
    if kubelet.pods_per_core:
        limit = min(limit, kubelet.pods_per_core * info.vcpu)
    return max(1, limit)


def volume_attach_limit(info: InstanceTypeInfo) -> int:
    """Per-instance data-volume attach budget.

    Models the EBS-style shared attachment ceiling: a fixed per-instance
    slot count shared between NICs and data volumes (so NIC-rich types
    attach fewer volumes), with the root volume already carved out.
    Deterministic from catalog fields, like the NIC-derived pod density
    above (reference: the core's CSI volume-limit scheduling; AWS's
    per-instance EBS attachment ceiling).
    """
    slots = 28 if info.vcpu <= 64 else 40
    return max(8, slots - info.max_network_interfaces - 1)


class Resolver:
    """Converts raw InstanceTypeInfo + nodeclass config into InstanceTypes.

    The reference's Resolver (types.go:58-121) caches per (info hash x
    nodeclass hash); caching lives in InstanceTypeProvider here.
    """

    def __init__(self, region: str, vm_memory_overhead_percent: float = DEFAULT_VM_MEMORY_OVERHEAD_PERCENT):
        self.region = region
        self.vm_memory_overhead_percent = vm_memory_overhead_percent

    # -- capacity -----------------------------------------------------------
    def compute_capacity(self, info: InstanceTypeInfo, nodeclass: TPUNodeClass) -> Resources:
        mem_bytes = info.memory_mib * MIB * (1 - self.vm_memory_overhead_percent)
        storage_gib = info.local_nvme_gib or sum(b.volume_size_gib for b in nodeclass.block_device_mappings)
        vals = {
            res.CPU: float(info.vcpu * 1000),
            res.MEMORY: float(int(mem_bytes)),
            res.EPHEMERAL_STORAGE: float(storage_gib * 2**30),
            res.PODS: float(pods_limit(info, nodeclass)),
            res.PRIVATE_IPV4: float(info.max_network_interfaces * info.ipv4_per_interface),
            res.ATTACHABLE_VOLUMES: float(volume_attach_limit(info)),
        }
        if info.gpu_count:
            vals[res.GPU] = float(info.gpu_count)
        if info.accelerator_count:
            vals[res.ACCELERATOR] = float(info.accelerator_count)
        if info.nic_count:
            vals[res.NIC] = float(info.nic_count)
        return Resources.from_base_units(vals)

    def compute_overhead(self, info: InstanceTypeInfo, nodeclass: TPUNodeClass) -> Resources:
        max_pods = pods_limit(info, nodeclass)
        kr = nodeclass.kubelet.kube_reserved
        sr = nodeclass.kubelet.system_reserved
        cpu = float(res.parse_quantity(kr["cpu"], res.CPU)) if "cpu" in kr else kube_reserved_cpu_milli(info.vcpu)
        mem = float(res.parse_quantity(kr["memory"], res.MEMORY)) if "memory" in kr else kube_reserved_memory_bytes(max_pods)
        cpu += float(res.parse_quantity(sr["cpu"], res.CPU)) if "cpu" in sr else 0.0
        mem += float(res.parse_quantity(sr["memory"], res.MEMORY)) if "memory" in sr else 100 * MIB
        # kubelet applies the LARGER of the hard and soft memory
        # thresholds for scheduling purposes (reference merges both signal
        # maps via MaxResources); each takes an absolute quantity ("100Mi")
        # or a percentage ("5%") of node memory -- resolved against the
        # vm-overhead-adjusted capacity compute_capacity reports, which is
        # what kubelet sees. Admission validates the value forms
        # (apis/validation.py), so parsing here is strict.
        node_mem = info.memory_mib * MIB * (1 - self.vm_memory_overhead_percent)

        def threshold_bytes(value: str) -> float:
            if value.endswith("%"):
                return node_mem * (float(value[:-1]) / 100.0)
            return float(res.parse_quantity(value, res.MEMORY))

        hard = nodeclass.kubelet.eviction_hard.get("memory.available", "100Mi")
        soft = nodeclass.kubelet.eviction_soft.get("memory.available")
        evict_bytes = threshold_bytes(hard)
        if soft is not None:
            evict_bytes = max(evict_bytes, threshold_bytes(soft))
        mem += evict_bytes
        return Resources.from_base_units({res.CPU: cpu, res.MEMORY: mem})

    # -- requirements -------------------------------------------------------
    def compute_requirements(self, info: InstanceTypeInfo) -> Requirements:
        def _in(key: str, *values) -> Requirement:
            return Requirement(key, Operator.IN, [str(v) for v in values])

        reqs = Requirements(
            [
                _in(wk.INSTANCE_TYPE_LABEL, info.name),
                _in(wk.ARCH_LABEL, info.arch),
                _in(wk.OS_LABEL, "linux"),
                _in(wk.REGION_LABEL, self.region),
                _in(wk.LABEL_INSTANCE_CATEGORY, info.category),
                _in(wk.LABEL_INSTANCE_FAMILY, info.family),
                _in(wk.LABEL_INSTANCE_GENERATION, info.generation),
                _in(wk.LABEL_INSTANCE_SIZE, info.size),
                _in(wk.LABEL_INSTANCE_CPU, info.vcpu),
                _in(wk.LABEL_INSTANCE_CPU_MANUFACTURER, info.cpu_manufacturer),
                _in(wk.LABEL_INSTANCE_MEMORY, info.memory_mib),
                _in(wk.LABEL_INSTANCE_NETWORK_BANDWIDTH, int(info.network_gbps * 1000)),
                _in(wk.LABEL_INSTANCE_EBS_BANDWIDTH, int(info.ebs_gbps * 1000)),
                _in(wk.LABEL_INSTANCE_HYPERVISOR, info.hypervisor or "none"),
                _in(wk.LABEL_INSTANCE_ENCRYPTION_IN_TRANSIT, str(info.encryption_in_transit).lower()),
                _in(wk.LABEL_INSTANCE_LOCAL_NVME, info.local_nvme_gib),
            ]
        )
        if info.gpu_count:
            reqs.add(
                _in(wk.LABEL_INSTANCE_GPU_NAME, info.gpu_name),
                _in(wk.LABEL_INSTANCE_GPU_MANUFACTURER, info.gpu_manufacturer),
                _in(wk.LABEL_INSTANCE_GPU_COUNT, info.gpu_count),
                _in(wk.LABEL_INSTANCE_GPU_MEMORY, info.gpu_memory_mib),
            )
        if info.accelerator_count:
            reqs.add(
                _in(wk.LABEL_INSTANCE_ACCELERATOR_NAME, info.accelerator_name),
                _in(wk.LABEL_INSTANCE_ACCELERATOR_MANUFACTURER, info.accelerator_manufacturer),
                _in(wk.LABEL_INSTANCE_ACCELERATOR_COUNT, info.accelerator_count),
            )
        return reqs

    def resolve(
        self,
        infos: Sequence[InstanceTypeInfo],
        nodeclass: TPUNodeClass,
        offerings_for: "OfferingFn",
    ) -> List[InstanceType]:
        out = []
        for info in infos:
            offerings = offerings_for(info)
            if not offerings:
                continue
            it = InstanceType(
                name=info.name,
                requirements=self.compute_requirements(info),
                capacity=self.compute_capacity(info, nodeclass),
                overhead=self.compute_overhead(info, nodeclass),
                offerings=offerings,
                info=info,
            )
            # zone / capacity-type / zone-id requirements summarize offerings
            zones = sorted({o.zone for o in offerings})
            zone_ids = sorted({o.zone_id for o in offerings})
            captypes = sorted({o.capacity_type for o in offerings})
            it.requirements.add(
                Requirement(wk.ZONE_LABEL, Operator.IN, zones),
                Requirement(wk.LABEL_ZONE_ID, Operator.IN, zone_ids),
                Requirement(wk.CAPACITY_TYPE_LABEL, Operator.IN, captypes),
            )
            rids = sorted({o.reservation_id for o in offerings if o.reservation_id})
            if rids:
                it.requirements.add(Requirement(wk.LABEL_CAPACITY_RESERVATION_ID, Operator.IN, rids))
            out.append(it)
        return out


from typing import Callable  # noqa: E402

OfferingFn = Callable[[InstanceTypeInfo], List[Offering]]
