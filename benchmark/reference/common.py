"""What both plain references share: the catalog and the pod classes, worked
out from the plain inputs (benchmark/gen), and the arithmetic's precision.

Plain NumPy. Nothing here imports the program: the encoding below is
worked out again from the inputs the benchmark hands to both sides.

Semantics (those of Karpenter's provisioning simulation, as the program
states them):
- resources are compared in small integers held in float32: cpu in
  millicores, memory in MiB, storage in GiB, counts as they are;
- pods that are identical for scheduling (requests, node selector,
  tolerations) form one class; classes are taken in first-fit-decreasing
  order: cpu descending, then memory, then the whole request vector, then
  a stable hash of the node selector's requirements, then tolerations;
- a class may run on a type when the type carries every selected label
  value and offers a zone and a capacity type the class admits.
"""
from __future__ import annotations

import hashlib
from typing import Dict, List, Sequence, Tuple

import numpy as np

from gen.catalog import (
    ARCH_LABEL, AXES, CAPACITY_TYPE_LABEL, MEMORY, ON_DEMAND, PODS, SPOT, STORAGE,
    ZONE_LABEL, allocatable,
)

R = len(AXES)
AXIS = {a: i for i, a in enumerate(AXES)}
CAPTYPES = ("reserved", SPOT, ON_DEMAND)       # the price tensor's captype axis
CT_SHIFT = 8                                   # captype bits above the zone bits

SCALE = np.ones((R,), dtype=np.float64)
SCALE[AXIS[MEMORY]] = 1.0 / 2**20
SCALE[AXIS[STORAGE]] = 1.0 / 2**30

# node-selector keys the references model; any other key is refused
SELECTOR_KEYS = (ZONE_LABEL, CAPACITY_TYPE_LABEL, ARCH_LABEL)


def vector(values: Dict[str, float]) -> np.ndarray:
    """Base units by axis name -> the dense float64 axis vector."""
    v = np.zeros((R,), dtype=np.float64)
    for k, x in values.items():
        v[AXIS[k]] = x
    return v


class Precision:
    """The arithmetic of a comparison: float32 as the program states it,
    or a lower one (the control). `q` rounds a float32 array to it."""

    def __init__(self, name: str = "float32"):
        if name not in ("float32", "bfloat16"):
            raise ValueError(f"unknown precision {name!r}")
        self.name = name

    def q(self, x):
        x = np.asarray(x, dtype=np.float32)
        if self.name == "float32":
            return x
        # round to nearest even on the top 16 bits (bfloat16), kept in float32
        b = x.view(np.uint32).astype(np.uint64)
        b = (b + 0x7FFF + ((b >> 16) & 1)) & 0xFFFF0000
        out = b.astype(np.uint32).view(np.float32)
        return np.where(np.isfinite(x), out, x)


class Catalog:
    """The plain catalog as arrays: allocatable [K, R] (scaled, float32),
    per type its arch, zones and capacity types as bits, the price tensor
    [K, Z, CT] (float32, +inf where not offered), and the decode order
    (types by their cheapest offering, stable)."""

    def __init__(self, entries: Sequence[dict]):
        self.entries = list(entries)
        self.names = [e["name"] for e in entries]
        self.K = len(entries)
        self.zones: List[str] = []
        for e in entries:
            for _, zone, _, _ in e["offerings"]:
                if zone not in self.zones:
                    self.zones.append(zone)
        self.Z = len(self.zones)
        self.alloc64 = np.stack([vector(allocatable(e)) for e in entries])
        self.alloc = (self.alloc64 * SCALE).astype(np.float32)
        self.arch = np.array([e["labels"][ARCH_LABEL] for e in entries])
        self.price = np.full((self.K, self.Z, len(CAPTYPES)), np.inf, dtype=np.float32)
        for k, e in enumerate(entries):
            for ct, zone, _, price in e["offerings"]:
                z, c = self.zones.index(zone), CAPTYPES.index(ct)
                self.price[k, z, c] = min(self.price[k, z, c], price)
        offered = np.isfinite(self.price)
        self.tzc = bits(offered.any(axis=2), offered.any(axis=1))
        cheapest = np.array([min(o[3] for o in e["offerings"]) for e in entries])
        self.order = np.argsort(cheapest, kind="stable")


def bits(zones: np.ndarray, captypes: np.ndarray) -> np.ndarray:
    """[..., Z] bool x [..., CT] bool -> [...] int64 zone|captype bits."""
    z = (zones.astype(np.int64) << np.arange(zones.shape[-1])).sum(-1)
    c = (captypes.astype(np.int64) << (CT_SHIFT + np.arange(captypes.shape[-1]))).sum(-1)
    return z | c


def joint_ok(x: np.ndarray) -> np.ndarray:
    """A zone bit and a captype bit both survive."""
    return ((x & ((1 << CT_SHIFT) - 1)) != 0) & ((x >> CT_SHIFT) != 0)


def selector_hash(selector: Dict[str, str]) -> str:
    """The stable hash of a node selector's requirements (one In value per
    key): the class order's tie-break."""
    h = hashlib.blake2b(digest_size=16)
    for k in sorted(selector):
        h.update(f"{k}|False|{[selector[k]]}|None|None;".encode())
    return h.hexdigest()


class PodClass:
    """Pods identical for scheduling, in their input order."""

    __slots__ = ("requests", "selector", "tolerations", "base", "req", "pods")

    def __init__(self, requests: Dict[str, float], selector: Dict[str, str], tolerations):
        unknown = set(selector) - set(SELECTOR_KEYS)
        if unknown:
            raise ValueError(f"the reference models no node selector on {sorted(unknown)}")
        self.requests = dict(requests)
        self.selector = dict(selector)
        self.tolerations = tuple(sorted(tuple(t) for t in tolerations))
        base = vector(requests)
        base[AXIS[PODS]] += 1.0
        self.base = base                           # float64, base units, one pod slot
        self.req = (base * SCALE).astype(np.float32)
        self.pods: List[str] = []

    def sort_key(self) -> tuple:
        return (-self.requests.get("cpu", 0.0), -self.requests.get(MEMORY, 0.0),
                tuple(-(self.base * SCALE)), selector_hash(self.selector), self.tolerations)


def group(specs) -> List[PodClass]:
    """Pods as (name, requests, selector, tolerations) -> classes in
    first-fit-decreasing order, each class's pods in input order."""
    by_key: Dict[tuple, PodClass] = {}
    for name, requests, selector, tolerations in specs:
        key = (tuple(sorted(requests.items())), tuple(sorted(selector.items())),
               tuple(sorted(tuple(t) for t in tolerations)))
        pc = by_key.get(key)
        if pc is None:
            pc = by_key[key] = PodClass(requests, selector, tolerations)
        pc.pods.append(name)
    return sorted(by_key.values(), key=PodClass.sort_key)


def admits(pc: PodClass, catalog: Catalog, pool_captype: str = "") -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(compat [K] bool, allowed zones [Z] bool, allowed captypes [CT] bool)
    of one class on a pool that admits every capacity type, or only
    `pool_captype`. `catalog` may be a catalog or ffd.Columns. Taints are
    the caller's: the provisioning tick gates them per pool, the sweep's
    pools carry none."""
    zone = pc.selector.get(ZONE_LABEL)
    azone = np.array([zone is None or z == zone for z in catalog.zones])
    ct = pc.selector.get(CAPACITY_TYPE_LABEL)
    acap = np.array([(ct is None or c == ct) and (not pool_captype or c == pool_captype)
                     for c in CAPTYPES])
    arch = pc.selector.get(ARCH_LABEL)
    ok = np.ones((catalog.K,), dtype=bool) if arch is None else catalog.arch == arch
    azc = bits(azone, acap)
    return ok & joint_ok(catalog.tzc & azc), azone, acap
