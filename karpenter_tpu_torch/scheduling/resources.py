"""Resource-quantity vocabulary and vector math.

Copy of karpenter_tpu/scheduling/resources.py (the port imports nothing
of the JAX package, so it carries its own copy of the host modules).

The reference models resources as k8s `corev1.ResourceList` maps and computes
fit as per-resource comparisons inside the core scheduler's FFD loop
(reference: designs/bin-packing.md:17-43; capacity construction at
pkg/providers/instancetype/types.go:313-331). Here the same vocabulary has a
dual representation:

- `Resources`: a small dict-like value type for host-side (control-plane) code.
- a fixed, ordered axis list `RESOURCE_AXES` so any Resources value can be
  densified into a float32 vector of static length for the TPU solver
  (XLA needs static shapes; a sparse resource map would defeat tiling).

All quantities normalize to base units at parse time: cpu -> millicores,
memory/ephemeral-storage -> bytes, counts -> unit. This avoids carrying k8s
Quantity objects into the hot path.
"""
from __future__ import annotations

import math
import re
from typing import Dict, Iterable, Mapping, Tuple, Union

# Canonical resource names (k8s vocabulary, as used throughout the reference).
CPU = "cpu"
MEMORY = "memory"
EPHEMERAL_STORAGE = "ephemeral-storage"
PODS = "pods"
GPU = "gpu.devices.dev/gpu"            # generic GPU-like extended resource
ACCELERATOR = "accelerator.dev/chips"  # generic ML accelerator (TPU-like)
NIC = "network.dev/nic"                # EFA-like high-perf NIC resource
PRIVATE_IPV4 = "private-ipv4"          # per-instance IP budget (subnet math)
# Per-node persistent-volume attach budget. The reference core counts a
# pod's CSI volumes against the node's attach limit during its scheduling
# simulation (karpenter core scheduling volume-usage tracking; the AWS
# analogue is the EBS per-instance attachment ceiling). Here it is ONE
# MORE DENSE AXIS: pods with resolved claims carry their volume count on
# it, instance types carry their attach limit, and the same vector fit
# that bounds cpu/mem/pods bounds attachments -- on the device kernel,
# the oracle, and the binder, with zero special-case code in any of them.
ATTACHABLE_VOLUMES = "attachable-volumes"

# The dense axis order for the solver. Static: changing it is a schema bump.
RESOURCE_AXES: Tuple[str, ...] = (
    CPU,
    MEMORY,
    EPHEMERAL_STORAGE,
    PODS,
    GPU,
    ACCELERATOR,
    NIC,
    PRIVATE_IPV4,
    ATTACHABLE_VOLUMES,
)
AXIS_INDEX: Dict[str, int] = {name: i for i, name in enumerate(RESOURCE_AXES)}
NUM_RESOURCE_AXES = len(RESOURCE_AXES)

_BINARY_SUFFIX = {"Ki": 2**10, "Mi": 2**20, "Gi": 2**30, "Ti": 2**40, "Pi": 2**50, "Ei": 2**60}
_DECIMAL_SUFFIX = {"k": 10**3, "M": 10**6, "G": 10**9, "T": 10**12, "P": 10**15, "E": 10**18}

_QTY_RE = re.compile(r"^\s*([+-]?[0-9]*\.?[0-9]+(?:[eE][+-]?[0-9]+)?)\s*([A-Za-z]*)\s*$")


def parse_quantity(value: Union[str, int, float], resource: str = "") -> float:
    """Parse a k8s-style quantity into base units.

    cpu values normalize to *millicores* ("1" -> 1000.0, "250m" -> 250.0);
    everything else normalizes to its plain unit (memory in bytes).
    """
    is_cpu = resource == CPU
    if isinstance(value, (int, float)):
        # Numeric inputs are already in base units (cpu: millicores) --
        # only strings carry k8s quantity notation.
        return float(value)
    m = _QTY_RE.match(value)
    if not m:
        raise ValueError(f"unparseable quantity {value!r}")
    num = float(m.group(1))
    suffix = m.group(2)
    if suffix == "":
        scale = 1.0
    elif suffix == "m":
        # milli-units: for cpu this IS the base unit; for others scale down.
        return num if is_cpu else num / 1000.0
    elif suffix in _BINARY_SUFFIX:
        scale = float(_BINARY_SUFFIX[suffix])
    elif suffix in _DECIMAL_SUFFIX:
        scale = float(_DECIMAL_SUFFIX[suffix])
    else:
        raise ValueError(f"unknown quantity suffix {suffix!r} in {value!r}")
    base = num * scale
    return base * 1000.0 if is_cpu else base


def format_quantity(value: float, resource: str = "") -> str:
    """Render a base-unit value back into a compact k8s-style string."""
    if resource == CPU:
        if value == int(value) and int(value) % 1000 == 0:
            return str(int(value) // 1000)
        return f"{int(value)}m" if value == int(value) else f"{value}m"
    if resource in (MEMORY, EPHEMERAL_STORAGE):
        for suffix, scale in (("Ti", 2**40), ("Gi", 2**30), ("Mi", 2**20), ("Ki", 2**10)):
            if value >= scale and (value / scale) == int(value / scale):
                return f"{int(value / scale)}{suffix}"
        return str(int(value))
    if value == int(value):
        return str(int(value))
    return str(value)


class Resources:
    """An immutable-ish resource vector with dict semantics.

    Values are floats in base units (cpu: millicores, memory: bytes).
    Arithmetic is element-wise over the union of keys; comparisons used by
    the schedulers are provided as `fits` (self <= other on every axis).
    """

    __slots__ = ("_v", "_sig")

    def __init__(self, values: Mapping[str, Union[str, int, float]] | None = None, **kw):
        self._sig = None
        self._v: Dict[str, float] = {}
        merged: Dict[str, Union[str, int, float]] = dict(values or {})
        merged.update(kw)
        for k, raw in merged.items():
            # Strings go through k8s-quantity parsing (cpu -> millicores).
            # Numeric values are taken as base units verbatim, so host code
            # and the solver's dense encoding agree without guessing.
            val = parse_quantity(raw, k) if isinstance(raw, str) else float(raw)
            if val != 0.0:
                self._v[k] = self._v.get(k, 0.0) + val

    # -- constructors -------------------------------------------------------
    @classmethod
    def from_base_units(cls, values: Mapping[str, float]) -> "Resources":
        r = cls()
        r._v = {k: float(v) for k, v in values.items() if v != 0.0}
        return r

    @classmethod
    def from_vector(cls, vec) -> "Resources":
        """Dense RESOURCE_AXES vector -> Resources, skipping the dict
        round-trip (the decode hot loop builds one per opened group)."""
        r = cls.__new__(cls)
        r._sig = None
        r._v = {k: v for k, v in zip(RESOURCE_AXES, vec) if v != 0.0}
        return r

    def sig(self) -> tuple:
        """Canonical content tuple, memoized. Resources are immutable after
        construction, and pods of one workload template share one Resources
        object (ReplicaSet replicas carry literally identical specs), so the
        sort amortizes across the whole template on the 50k-pod grouping
        path (solver/encode.group_pods)."""
        s = self._sig
        if s is None:
            s = self._sig = tuple(sorted(self._v.items()))
        return s

    # -- dict-ish -----------------------------------------------------------
    def get(self, key: str, default: float = 0.0) -> float:
        return self._v.get(key, default)

    def __getitem__(self, key: str) -> float:
        return self._v.get(key, 0.0)

    def __contains__(self, key: str) -> bool:
        return key in self._v

    def keys(self):
        return self._v.keys()

    def items(self):
        return self._v.items()

    def __iter__(self):
        return iter(self._v)

    def __len__(self):
        return len(self._v)

    def __bool__(self):
        return any(v != 0.0 for v in self._v.values())

    # -- arithmetic ---------------------------------------------------------
    def __add__(self, other: "Resources") -> "Resources":
        out = dict(self._v)
        for k, v in other._v.items():
            out[k] = out.get(k, 0.0) + v
        return Resources.from_base_units(out)

    def __sub__(self, other: "Resources") -> "Resources":
        out = dict(self._v)
        for k, v in other._v.items():
            out[k] = out.get(k, 0.0) - v
        return Resources.from_base_units(out)

    def __mul__(self, scalar: float) -> "Resources":
        return Resources.from_base_units({k: v * scalar for k, v in self._v.items()})

    __rmul__ = __mul__

    def __eq__(self, other) -> bool:
        if not isinstance(other, Resources):
            return NotImplemented
        keys = set(self._v) | set(other._v)
        return all(math.isclose(self.get(k), other.get(k), rel_tol=1e-9, abs_tol=1e-9) for k in keys)

    def __repr__(self) -> str:
        inner = ", ".join(f"{k}={format_quantity(v, k)}" for k, v in sorted(self._v.items()))
        return f"Resources({inner})"

    # -- scheduling ---------------------------------------------------------
    def fits(self, capacity: "Resources") -> bool:
        """True iff every requested axis is satisfiable within `capacity`."""
        return all(v <= capacity.get(k) + 1e-9 for k, v in self._v.items())

    def within(self, limits: "Resources") -> bool:
        """True iff every axis NAMED BY `limits` is at or under it. Axes
        absent from limits are UNCONSTRAINED -- NodePool-limits semantics
        (the reference caps only the resources the operator lists,
        `nodepool.spec.limits`). fits() is the wrong shape for that check:
        a cpu-only limit would read every other axis as capacity 0 and
        refuse all capacity (round-5 finding)."""
        return all(self._v.get(k, 0.0) <= v + 1e-9 for k, v in limits._v.items())

    def any_negative(self) -> bool:
        return any(v < -1e-9 for v in self._v.values())

    def nonzero_axes(self) -> Iterable[str]:
        return (k for k, v in self._v.items() if v != 0.0)

    # -- dense encoding for the solver -------------------------------------
    def to_vector(self) -> Tuple[float, ...]:
        """Densify onto RESOURCE_AXES. Unknown extended resources raise --
        the catalog schema must be extended deliberately, not silently."""
        vec = [0.0] * NUM_RESOURCE_AXES
        for k, v in self._v.items():
            if k not in AXIS_INDEX:
                raise KeyError(
                    f"resource {k!r} has no dense axis; add it to RESOURCE_AXES"
                )
            vec[AXIS_INDEX[k]] = v
        return tuple(vec)


def merge_requests(*rs: Resources) -> Resources:
    total = Resources()
    for r in rs:
        total = total + r
    return total
