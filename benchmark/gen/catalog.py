"""The catalog both sides are handed: ~630 generated instance types, each
offered on-demand and (where its usage classes allow) spot in each of its
zones, as plain data.

A frozen copy of the port's catalog generator
(karpenter_tpu_torch/providers/instancetype/gen_catalog.py) and of the
arithmetic of its Resolver (providers/instancetype/types.py: capacity,
kube-reserved overhead, labels) for a default node class with a subnet in
every zone and no reservations. The benchmark turns each entry into the
program's InstanceType (benchmark/program.py); the plain reference reads
the entries as they are. Every choice is a pure hash of a name, so the
catalog is the same in every run.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Dict, List, Tuple

REGION = "us-central-1"
ZONES = [(f"{REGION}a", "uc1-az1"), (f"{REGION}b", "uc1-az2"),
         (f"{REGION}c", "uc1-az3"), (f"{REGION}d", "uc1-az4")]
ZONE_NAMES = tuple(z for z, _ in ZONES)
ZONE_IDS = dict(ZONES)

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


GIB = 1024  # MiB per GiB

# size ladder: name -> vcpu multiplier relative to "large" (2 vCPU)
SIZES: List[Tuple[str, int]] = [
    ("medium", 1),
    ("large", 2),
    ("xlarge", 4),
    ("2xlarge", 8),
    ("4xlarge", 16),
    ("8xlarge", 32),
    ("12xlarge", 48),
    ("16xlarge", 64),
    ("24xlarge", 96),
    ("32xlarge", 128),
    ("48xlarge", 192),
]
SIZE_INDEX = {name: i for i, (name, _) in enumerate(SIZES)}

# memory GiB per vCPU by category
MEM_RATIO = {"c": 2, "m": 4, "r": 8, "x": 16, "t": 4, "i": 8, "d": 8, "g": 4, "p": 8, "acc": 4}

# price model ($/hr): vcpu * cpu_rate + mem_gib * mem_rate, then multipliers
CPU_RATE = 0.0255
MEM_RATE = 0.0058
ARCH_MULT = {"intel": 1.0, "amd": 0.90, "arm-native": 0.78}
GEN_MULT = {3: 1.10, 4: 1.05, 5: 1.00, 6: 0.98, 7: 0.97, 8: 0.96}
GPU_PRICE = {"t4g-like": 0.35, "a10-like": 0.60, "v100-like": 2.10, "a100-like": 4.10, "h100-like": 9.80}
ACCEL_PRICE = {"ml-v4": 1.10, "ml-v5": 1.45}

# family table: (family, category, generation, arch, cpu_mfr, flags, size slice)
# flags: d = local nvme, n = network optimized, e = extra memory
_FAM = []


def _fam(family, cat, gen, arch, mfr, flags="", lo="large", hi="24xlarge"):
    _FAM.append((family, cat, gen, arch, mfr, flags, lo, hi))


# compute-optimized
for gen, variants in [(4, ["i"]), (5, ["i", "a", "d", "n"]), (6, ["i", "a", "g", "gd", "gn", "id"]), (7, ["i", "a", "g", "gd"]), (8, ["g"])]:
    for v in variants:
        arm = v.startswith("g")  # graviton-style variants (incl. c6gn) are arm64
        _fam(
            f"c{gen}{'' if v == 'i' and gen < 6 else v}",
            "c",
            gen,
            "arm64" if arm else "amd64",
            "arm-native" if arm else ("amd" if "a" in v and not arm else "intel"),
            ("d" if "d" in v else "") + ("n" if "n" in v else ""),
            "large",
            "48xlarge" if gen >= 7 else "24xlarge",
        )
# general purpose
for gen, variants in [(4, [""]), (5, ["", "a", "d", "n", "ad"]), (6, ["i", "a", "g", "gd", "id", "idn"]), (7, ["i", "a", "g", "gd", "i-flex"]), (8, ["g"])]:
    for v in variants:
        arm = v.startswith("g")
        _fam(
            f"m{gen}{v}",
            "m",
            gen,
            "arm64" if arm else "amd64",
            "arm-native" if arm else ("amd" if v.startswith("a") else "intel"),
            ("d" if "d" in v else "") + ("n" if "n" in v else ""),
            "large",
            "32xlarge" if gen >= 6 else "24xlarge",
        )
# memory optimized
for gen, variants in [(4, [""]), (5, ["", "a", "d", "n", "b"]), (6, ["i", "a", "g", "gd", "id"]), (7, ["i", "a", "g", "iz"]), (8, ["g"])]:
    for v in variants:
        arm = v.startswith("g")
        _fam(
            f"r{gen}{v}",
            "r",
            gen,
            "arm64" if arm else "amd64",
            "arm-native" if arm else ("amd" if v.startswith("a") else "intel"),
            ("d" if "d" in v else ""),
            "large",
            "48xlarge" if gen >= 7 else "24xlarge",
        )
# extra-high memory
_fam("x1", "x", 4, "amd64", "intel", "e", "16xlarge", "32xlarge")
_fam("x1e", "x", 4, "amd64", "intel", "e", "xlarge", "32xlarge")
_fam("x2idn", "x", 6, "amd64", "intel", "de", "16xlarge", "32xlarge")
_fam("x2iedn", "x", 6, "amd64", "intel", "de", "xlarge", "32xlarge")
_fam("x2gd", "x", 6, "arm64", "arm-native", "de", "large", "16xlarge")
# burstable
_fam("t2", "t", 2, "amd64", "intel", "b", "medium", "2xlarge")
_fam("t3", "t", 3, "amd64", "intel", "b", "medium", "2xlarge")
_fam("t3a", "t", 3, "amd64", "amd", "b", "medium", "2xlarge")
_fam("t4g", "t", 4, "arm64", "arm-native", "b", "medium", "2xlarge")
# storage optimized
_fam("i3", "i", 3, "amd64", "intel", "d", "large", "16xlarge")
_fam("i3en", "i", 3, "amd64", "intel", "dn", "large", "24xlarge")
_fam("i4i", "i", 6, "amd64", "intel", "d", "large", "32xlarge")
_fam("i4g", "i", 6, "arm64", "arm-native", "d", "large", "16xlarge")
_fam("d2", "d", 2, "amd64", "intel", "d", "xlarge", "8xlarge")
_fam("d3", "d", 3, "amd64", "intel", "d", "xlarge", "8xlarge")
# gpu
_GPU_FAMS = {
    "g4dn": ("t4g-like", 16, 1),   # gpu name, gpu mem GiB, base count
    "g5": ("a10-like", 24, 1),
    "g6": ("a10-like", 24, 1),
    "p3": ("v100-like", 16, 1),
    "p4d": ("a100-like", 40, 8),
    "p5": ("h100-like", 80, 8),
}
_fam("g4dn", "g", 4, "amd64", "intel", "dg", "xlarge", "16xlarge")
_fam("g5", "g", 5, "amd64", "amd", "dg", "xlarge", "48xlarge")
_fam("g6", "g", 6, "amd64", "amd", "dg", "xlarge", "48xlarge")
_fam("p3", "p", 3, "amd64", "intel", "g", "2xlarge", "16xlarge")
_fam("p4d", "p", 4, "amd64", "intel", "gn", "24xlarge", "24xlarge")
_fam("p5", "p", 5, "amd64", "amd", "gn", "48xlarge", "48xlarge")
# ML accelerator (trainium/inferentia-like)
_ACC_FAMS = {"acc1": ("ml-v4", 1), "acc2": ("ml-v5", 1)}
_fam("acc1", "acc", 6, "amd64", "intel", "an", "xlarge", "24xlarge")
_fam("acc2", "acc", 7, "amd64", "amd", "an", "xlarge", "48xlarge")


def _h(s: str) -> float:
    """Deterministic uniform [0,1) from a string."""
    return int(hashlib.blake2b(s.encode(), digest_size=8).hexdigest(), 16) / 2**64


def _eni_limits(vcpu: int) -> Tuple[int, int]:
    """(interfaces, ipv4 per interface), an ENI-style tier table."""
    if vcpu <= 2:
        return 3, 10
    if vcpu <= 4:
        return 4, 15
    if vcpu <= 8:
        return 4, 15
    if vcpu <= 16:
        return 8, 30
    if vcpu <= 48:
        return 8, 30
    return 15, 50


def _network_gbps(vcpu: int, flags: str, category: str) -> float:
    base = min(100.0, max(1.0, vcpu * 0.4))
    if "n" in flags:
        base = min(400.0, base * 4)
    if category in ("p", "acc"):
        base = max(base, 100.0)
    return round(base, 2)


def _zones_for(name: str, category: str, bare_metal: bool) -> Tuple[str, ...]:
    """Most types in all zones; exotic shapes in fewer (deterministic)."""
    if category in ("p", "x", "acc") or bare_metal:
        k = 2 if _h(name + "|z") < 0.7 else 3
    elif _h(name + "|z") < 0.08:
        k = 3
    else:
        k = 4
    start = int(_h(name + "|zs") * 4)
    return tuple(ZONE_NAMES[(start + i) % 4] for i in range(k))


def generate_instance_types() -> List[InstanceTypeInfo]:
    out: List[InstanceTypeInfo] = []
    for family, cat, gen, arch, mfr, flags, lo, hi in _FAM:
        lo_i, hi_i = SIZE_INDEX[lo], SIZE_INDEX[hi]
        sizes = [s for s in SIZES[lo_i : hi_i + 1]]
        # burstable families also get nano/micro/small below medium
        if "b" in flags and cat == "t":
            sizes = [("nano", 2), ("micro", 2), ("small", 2)] + [(n, m) for n, m in sizes]
        for size_name, mult in sizes:
            if cat == "t" and size_name in ("nano", "micro", "small"):
                vcpu = 2  # burstable minis: 2 shared vCPUs, sub-GiB memory
                mem_gib = {"nano": 0.5, "micro": 1, "small": 2}[size_name]
            else:
                vcpu = mult  # SIZES second element is the vCPU count
                mem_gib = vcpu * MEM_RATIO[cat]
            if "e" in flags:
                mem_gib *= 2
            name = f"{family}.{size_name}"
            ifaces, ips = _eni_limits(vcpu)
            nvme = int(vcpu * 58.25) if "d" in flags else 0
            gpu_name = gpu_mfr = ""
            gpu_count = gpu_mem = 0
            if family in _GPU_FAMS:
                gname, gmem, gbase = _GPU_FAMS[family]
                gpu_name, gpu_mfr = gname, "gpu-corp"
                gpu_count = max(1, min(8, gbase * max(1, vcpu // 48) if gbase > 1 else max(1, vcpu // 16)))
                gpu_mem = gmem * GIB
            acc_name = acc_mfr = ""
            acc_count = 0
            if family in _ACC_FAMS:
                aname, abase = _ACC_FAMS[family]
                acc_name, acc_mfr = aname, "accel-corp"
                acc_count = max(1, min(16, abase * max(1, vcpu // 8)))
            nic = 0
            if "n" in flags and vcpu >= 32:
                nic = 1 if vcpu < 96 else (4 if cat in ("p", "acc") else 2)
            usage = ("on-demand",) if cat == "x" and gen <= 4 else ("on-demand", "spot")
            out.append(
                InstanceTypeInfo(
                    name=name,
                    category=cat,
                    family=family,
                    generation=gen,
                    size=size_name,
                    vcpu=vcpu,
                    memory_mib=int(mem_gib * GIB),
                    arch=arch,
                    cpu_manufacturer=mfr,
                    sustained_clock_mhz=3500 - gen * 50 + (400 if cat == "c" else 0),
                    hypervisor="nitro" if gen >= 5 else "xen",
                    bare_metal=False,
                    burstable="b" in flags and cat == "t",
                    network_gbps=_network_gbps(vcpu, flags, cat),
                    ebs_gbps=round(min(80.0, max(2.0, vcpu * 0.6)), 2),
                    max_network_interfaces=ifaces,
                    ipv4_per_interface=ips,
                    local_nvme_gib=nvme,
                    gpu_name=gpu_name,
                    gpu_manufacturer=gpu_mfr,
                    gpu_count=gpu_count,
                    gpu_memory_mib=gpu_mem,
                    accelerator_name=acc_name,
                    accelerator_manufacturer=acc_mfr,
                    accelerator_count=acc_count,
                    nic_count=nic,
                    encryption_in_transit=gen >= 5,
                    supported_usage_classes=usage,
                    zones=_zones_for(name, cat, False),
                )
            )
        # metal variant for modern non-burstable families
        if gen >= 5 and cat not in ("t", "g", "p", "acc"):
            vcpu = SIZES[hi_i][1]
            mem_gib = vcpu * MEM_RATIO[cat] * (2 if "e" in flags else 1)
            name = f"{family}.metal"
            ifaces, ips = _eni_limits(vcpu)
            out.append(
                InstanceTypeInfo(
                    name=name,
                    category=cat,
                    family=family,
                    generation=gen,
                    size="metal",
                    vcpu=vcpu,
                    memory_mib=int(mem_gib * GIB),
                    arch=arch,
                    cpu_manufacturer=mfr,
                    hypervisor="",
                    bare_metal=True,
                    network_gbps=_network_gbps(vcpu, flags, cat),
                    ebs_gbps=round(min(80.0, vcpu * 0.6), 2),
                    max_network_interfaces=ifaces,
                    ipv4_per_interface=ips,
                    local_nvme_gib=int(vcpu * 58.25) if "d" in flags else 0,
                    encryption_in_transit=True,
                    zones=_zones_for(name, cat, True),
                )
            )
    return out


def on_demand_price(it: InstanceTypeInfo) -> float:
    mem_gib = it.memory_mib / GIB
    price = it.vcpu * CPU_RATE + mem_gib * MEM_RATE
    price *= ARCH_MULT[it.cpu_manufacturer]
    price *= GEN_MULT.get(it.generation, 1.08)
    if it.burstable:
        price *= 0.55
    if it.local_nvme_gib:
        price *= 1.08
    if it.nic_count:
        price *= 1.06
    if it.bare_metal:
        price *= 1.12
    if it.gpu_count:
        # a device name the table does not know is priced from its memory
        price += it.gpu_count * GPU_PRICE.get(
            it.gpu_name, 0.3 + 0.25 * (it.gpu_memory_mib / 16384.0))
    if it.accelerator_count:
        price += it.accelerator_count * ACCEL_PRICE.get(it.accelerator_name, 1.2)
    return round(price, 4)


def spot_price(it: InstanceTypeInfo, zone: str) -> float:
    """Zonal spot price: 25-45% of on-demand, deterministic per (type, zone)."""
    od = on_demand_price(it)
    frac = 0.25 + 0.20 * _h(f"{it.name}|{zone}|spot")
    return round(od * frac, 4)


# -- the Resolver's arithmetic (default node class) ---------------------------

MIB = 2**20
VM_MEMORY_OVERHEAD_PERCENT = 0.075
ROOT_VOLUME_GIB = 20            # the default node class's one block device

# resource axes, in the program's dense order (scheduling/resources.py)
CPU, MEMORY, STORAGE, PODS = "cpu", "memory", "ephemeral-storage", "pods"
GPU, ACCELERATOR, NIC = "gpu.devices.dev/gpu", "accelerator.dev/chips", "network.dev/nic"
PRIVATE_IPV4, VOLUMES = "private-ipv4", "attachable-volumes"
AXES = (CPU, MEMORY, STORAGE, PODS, GPU, ACCELERATOR, NIC, PRIVATE_IPV4, VOLUMES)

SPOT, ON_DEMAND = "spot", "on-demand"
ZONE_LABEL = "topology.kubernetes.io/zone"
ZONE_ID_LABEL = "topology.karpenter.tpu/zone-id"
CAPACITY_TYPE_LABEL = "karpenter.sh/capacity-type"
ARCH_LABEL = "kubernetes.io/arch"
NODEPOOL_LABEL = "karpenter.sh/nodepool"
HOSTNAME_LABEL = "kubernetes.io/hostname"


def kube_reserved_cpu_milli(vcpu: int) -> float:
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


def _pods_limit(info: InstanceTypeInfo) -> int:
    return max(1, info.eni_pod_limit())


def _volume_attach_limit(info: InstanceTypeInfo) -> int:
    slots = 28 if info.vcpu <= 64 else 40
    return max(8, slots - info.max_network_interfaces - 1)


def _capacity(info: InstanceTypeInfo) -> Dict[str, float]:
    mem_bytes = info.memory_mib * MIB * (1 - VM_MEMORY_OVERHEAD_PERCENT)
    storage_gib = info.local_nvme_gib or ROOT_VOLUME_GIB
    vals = {
        CPU: float(info.vcpu * 1000),
        MEMORY: float(int(mem_bytes)),
        STORAGE: float(storage_gib * 2**30),
        PODS: float(_pods_limit(info)),
        PRIVATE_IPV4: float(info.max_network_interfaces * info.ipv4_per_interface),
        VOLUMES: float(_volume_attach_limit(info)),
    }
    if info.gpu_count:
        vals[GPU] = float(info.gpu_count)
    if info.accelerator_count:
        vals[ACCELERATOR] = float(info.accelerator_count)
    if info.nic_count:
        vals[NIC] = float(info.nic_count)
    return {k: v for k, v in vals.items() if v != 0.0}


def _overhead(info: InstanceTypeInfo) -> Dict[str, float]:
    cpu = kube_reserved_cpu_milli(info.vcpu)
    mem = float((255 + 11 * _pods_limit(info)) * MIB)
    mem += 100 * MIB                    # system-reserved
    mem += float(100 * MIB)             # eviction threshold memory.available 100Mi
    return {k: v for k, v in {CPU: cpu, MEMORY: mem}.items() if v != 0.0}


def _labels(info: InstanceTypeInfo) -> Dict[str, str]:
    p = "karpenter.tpu/instance-"
    out = {
        "node.kubernetes.io/instance-type": info.name,
        ARCH_LABEL: info.arch,
        "kubernetes.io/os": "linux",
        "topology.kubernetes.io/region": REGION,
        p + "category": info.category,
        p + "family": info.family,
        p + "generation": str(info.generation),
        p + "size": info.size,
        p + "cpu": str(info.vcpu),
        p + "cpu-manufacturer": info.cpu_manufacturer,
        p + "memory": str(info.memory_mib),
        p + "network-bandwidth": str(int(info.network_gbps * 1000)),
        p + "ebs-bandwidth": str(int(info.ebs_gbps * 1000)),
        p + "hypervisor": info.hypervisor or "none",
        p + "encryption-in-transit-supported": str(info.encryption_in_transit).lower(),
        p + "local-nvme": str(info.local_nvme_gib),
    }
    if info.gpu_count:
        out.update({p + "gpu-name": info.gpu_name, p + "gpu-manufacturer": info.gpu_manufacturer,
                    p + "gpu-count": str(info.gpu_count), p + "gpu-memory": str(info.gpu_memory_mib)})
    if info.accelerator_count:
        out.update({p + "accelerator-name": info.accelerator_name,
                    p + "accelerator-manufacturer": info.accelerator_manufacturer,
                    p + "accelerator-count": str(info.accelerator_count)})
    return out


def build_catalog() -> List[dict]:
    """The catalog as plain entries, in the generator's order: name,
    labels (one value each), capacity and overhead (base units: cpu in
    millicores, memory and storage in bytes), and offerings as
    (capacity type, zone, zone id, price) in the order the program's
    offering builder lists them (per zone: on-demand, then spot)."""
    out = []
    for info in generate_instance_types():
        offerings = []
        for zone in info.zones:
            if "on-demand" in info.supported_usage_classes:
                offerings.append((ON_DEMAND, zone, ZONE_IDS[zone], on_demand_price(info)))
            if "spot" in info.supported_usage_classes:
                offerings.append((SPOT, zone, ZONE_IDS[zone], spot_price(info, zone)))
        if offerings:
            out.append({"name": info.name, "labels": _labels(info), "capacity": _capacity(info),
                        "overhead": _overhead(info), "offerings": offerings})
    return out


def allocatable(entry: dict) -> Dict[str, float]:
    """capacity - overhead, key by key in float64 (zero entries dropped)."""
    out = dict(entry["capacity"])
    for k, v in entry["overhead"].items():
        out[k] = out.get(k, 0.0) - v
    return {k: v for k, v in out.items() if v != 0.0}
