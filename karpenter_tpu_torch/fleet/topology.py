"""Topology epochs: the mesh's membership ledger and degrade ladder.

Copy of karpenter_tpu/fleet/topology.py over the port's positional
`parallel.mesh.Mesh`: shards are indexed by position, so "device i" here
is shard i even where several shards share one card. Changed: the mesh
type, the HBM ledger labels (`cuda:<i>`, obs/hbm.py) and four CUDA
runtime texts for a device that is lost or unusable in the classifier.

Every other seam in the stack has a typed failure ladder -- wire,
crash, overload, error paths -- but the mesh fleet path assumed the
device mesh was immortal. This module is the missing ledger: a
monotonic **topology epoch** that names one healthy-device set + mesh
layout, bumped on ANY membership change (device lost, quarantined by
the shard-straggler watchdog, or returned). Staged shards are stamped
with the epoch they were staged under; a solve dispatched against a
stale epoch surfaces as a typed ``StaleTopologyError`` (a
``StaleSeqnumError`` subclass, so every existing recovery rung --
synchronous restage-retry, pipelined barrier fallback, breaker, delta
epochs -- handles a topology change exactly like any other staging
gap).

The degrade ladder, every rung bit-identical on decisions (GSPMD only
changes placement, never semantics; the unsharded rung IS the proven
single-device entry set):

    full mesh -> shrunk mesh -> unsharded single-device
              -> wire breaker -> in process on the client's device

``current_mesh`` computes the shrunk layout DETERMINISTICALLY from the
healthy set: a 2D ``(hosts, types)`` mesh collapses whole rows first
(a host with any lost chip leaves as a unit -- the DCN fabric's
failure domain), falling back to a flat mesh over the largest
power-of-two prefix of the surviving devices (pow2 counts are the only
ones every padded solver axis divides by), then to ``None`` (the
unsharded rung) when fewer than two remain. Shrunk ``Mesh`` objects are memoized per healthy-set
so a stable topology reuses its per-shard streams (``Mesh`` hashes by
devices+axes), and re-promotion to the full mesh returns the ORIGINAL
mesh object -- the shards' streams from before the loss.
"""
from __future__ import annotations

import re
import threading
from typing import Dict, Optional, Tuple

from karpenter_tpu_torch import metrics
from karpenter_tpu_torch.parallel import mesh as mesh_mod
from karpenter_tpu_torch.parallel.mesh import Mesh

# substrings (lowercased) that classify a RuntimeError out of a mesh
# dispatch as a DEVICE LOSS rather than a program bug: the runtime's
# device-failure surfaces, plus the repo's own injected fault (the
# `mesh.device.lost` failpoint raises RuntimeError with the site name in
# the message -- the chaos soak exercises exactly this classifier).
# Anything else re-raises unchanged: misclassifying a compile error as a
# dead chip would shrink the mesh forever on every dispatch. The CUDA
# runtime's texts below name a device that is lost or unusable (an
# uncorrectable ECC or NVLink error, a device busy or unavailable, no
# device at all); a program fault -- an illegal address, a refused launch
# configuration, a device-side assert -- is never one of them.
_DEVICE_LOSS_PATTERNS = (
    "mesh.device.lost",
    "device lost",
    "device failure",
    "device unavailable",
    "device halted",
    "chip halted",
    "data_loss",
    "hardware_error",
    "device or resource busy",
    "uncorrectable ecc error",
    "uncorrectable nvlink error",
    "busy or unavailable",
    "no cuda-capable device",
)

_DEVICE_INDEX_RE = re.compile(r"device[ #:]*(\d+)")


def _pow2_floor(n: int) -> int:
    """Largest power of two <= n (0 for n < 1): the legal shrunk-mesh
    device counts -- see _build_mesh_locked."""
    if n < 1:
        return 0
    p = 1
    while p * 2 <= n:
        p *= 2
    return p


def classify_device_error(exc: BaseException) -> Optional[str]:
    """The reason string when `exc` looks like a lost device, else None.

    Pattern-matched on the message because the runtime surfaces device
    death as bare ``RuntimeError`` text (torch's ``AcceleratorError`` is a
    RuntimeError subclass carrying the CUDA runtime's message) -- there is
    no typed exception to catch at this layer."""
    msg = str(exc).lower()
    for pat in _DEVICE_LOSS_PATTERNS:
        if pat in msg:
            return pat
    return None


def device_index_hint(exc: BaseException) -> Optional[int]:
    """A device index named in the error message, if any (the runtime
    often includes one; the failpoint message does not)."""
    m = _DEVICE_INDEX_RE.search(str(exc).lower())
    return int(m.group(1)) if m else None


class TopologyTracker:
    """The healthy-device ledger behind one mesh engine.

    Thread-safe; the epoch is monotonic and bumps on every membership
    change in either direction, so ``epoch`` equality IS topology
    equality -- a solve staged at epoch N and dispatched at epoch M>N
    is provably against a different device set.
    """

    def __init__(self, devices: Tuple, shape: Tuple[int, ...],
                 axis_names: Tuple[str, ...], full_mesh: Optional[Mesh] = None):
        self._devices = tuple(devices)          # flat, host-major
        self._shape = tuple(shape)
        self._axis_names = tuple(axis_names)
        # the original mesh object: re-promotion hands this exact object
        # back so the engine's per-mesh state (keyed on the Mesh) is reused
        self._full_mesh = full_mesh
        self._epoch = 1
        self._lost: Dict[int, str] = {}         # flat index -> reason
        self._mesh_cache: Dict[tuple, Mesh] = {}
        self._lock = threading.Lock()
        self._observe_locked()

    @classmethod
    def from_mesh(cls, mesh: Mesh) -> "TopologyTracker":
        return cls(
            tuple(mesh.devices), tuple(mesh.shape),
            tuple(mesh.axis_names), full_mesh=mesh,
        )

    # -- membership ----------------------------------------------------------
    @property
    def epoch(self) -> int:
        return self._epoch

    @property
    def size(self) -> int:
        return len(self._devices)

    def healthy_indices(self) -> Tuple[int, ...]:
        with self._lock:
            return tuple(
                i for i in range(len(self._devices)) if i not in self._lost
            )

    def quarantined(self) -> Dict[int, str]:
        with self._lock:
            return dict(self._lost)

    def mark_lost(self, index: int, reason: str) -> bool:
        """Record device `index` as lost; bump the epoch iff this is a
        real membership change. Returns True on a bump."""
        index = int(index) % max(len(self._devices), 1)
        with self._lock:
            if index in self._lost:
                return False
            self._lost[index] = str(reason)
            self._epoch += 1
            self._observe_locked()
            metrics.MESH_TOPOLOGY_TRANSITIONS.inc(kind="device-lost")
            return True

    def mark_returned(self, index: int) -> bool:
        """Record device `index` as healthy again (the probe saw it come
        back, or the operator cleared a quarantine); bump the epoch iff
        it was actually out."""
        index = int(index) % max(len(self._devices), 1)
        with self._lock:
            if index not in self._lost:
                return False
            del self._lost[index]
            self._epoch += 1
            self._observe_locked()
            metrics.MESH_TOPOLOGY_TRANSITIONS.inc(kind="device-returned")
            return True

    def _observe_locked(self) -> None:
        metrics.MESH_TOPOLOGY_EPOCH.set(float(self._epoch))
        metrics.MESH_TOPOLOGY_HEALTHY.set(
            float(len(self._devices) - len(self._lost)))
        metrics.MESH_TOPOLOGY_QUARANTINED.set(float(len(self._lost)))

    # -- layout --------------------------------------------------------------
    def current_mesh(self) -> Optional[Mesh]:
        """The deterministic mesh for the CURRENT healthy set, or None
        for the unsharded single-device rung.

        All healthy -> the original full mesh object (its streams).
        2D layouts collapse rows first: any row containing a lost
        device leaves whole (hosts are the DCN failure domain), and the
        largest power-of-two prefix of the surviving full rows keeps
        the 2D layout when >= 2 remain. Otherwise a flat mesh over the
        largest power-of-two prefix of the healthy devices, when >= 2
        remain; below that, sharding buys nothing -- descend to the
        unsharded rung. Power-of-two counts only: the padded axes the
        shardings split guarantee even division for them and nothing
        else (_build_mesh_locked)."""
        with self._lock:
            if not self._lost:
                return self._full_mesh
            healthy = tuple(
                i for i in range(len(self._devices)) if i not in self._lost
            )
            key = (self._shape, healthy)
            cached = self._mesh_cache.get(key)
            if cached is not None:
                return cached
            mesh = self._build_mesh_locked(healthy)
            if mesh is not None:
                self._mesh_cache[key] = mesh
            return mesh

    def _build_mesh_locked(self, healthy: Tuple[int, ...]) -> Optional[Mesh]:
        """Shrunk layouts use POWER-OF-TWO device counts only: every
        padded axis the shardings split (k_pad multiple of 128, c_pad
        multiple of 16, the disrupt pools' pow2 buckets) divides evenly
        by any power of two, while e.g. 7 survivors of 8 would fail
        GSPMD's even-split check at stage time. So 8 -> 4 -> 2 ->
        unsharded, always taking the LOWEST-indexed healthy devices
        (and earliest full rows) -- deterministic across processes."""
        if len(self._shape) == 2:
            n_hosts, per_host = self._shape
            full_rows = [
                r for r in range(n_hosts)
                if all(r * per_host + c in healthy for c in range(per_host))
            ]
            n_rows = _pow2_floor(len(full_rows))
            if n_rows >= 2:
                idx = [r * per_host + c for r in full_rows[:n_rows] for c in range(per_host)]
                return Mesh([self._devices[i] for i in idx], self._axis_names,
                            shape=(n_rows, per_host), ranks=self._ranks_of(idx))
        n_flat = _pow2_floor(len(healthy))
        if n_flat >= 2:
            idx = list(healthy[:n_flat])
            return Mesh([self._devices[i] for i in idx], (mesh_mod.TYPES_AXIS,),
                        ranks=self._ranks_of(idx))
        return None

    def _ranks_of(self, idx) -> Optional[list]:
        if self._full_mesh is None:
            return None
        return [self._full_mesh.ranks[i] for i in idx]

    def shrunk_meshes(self) -> Tuple[Mesh, ...]:
        """Every DETERMINISTIC shrunk layout the degrade ladder can build
        (largest first), independent of which devices are currently
        healthy: pow2 row prefixes for a 2D mesh, then pow2 flat device
        prefixes down to 2. These are exactly the meshes
        _build_mesh_locked produces when the HIGHEST-indexed devices go
        (the quarantine rung removes highest-index first), so the
        warm-up ladder (solver/aot.py) can run their sharded dispatches
        BEFORE any device is lost -- a reshard then lands on a
        layout the warm-up already ran (Mesh equality is by devices+axis names)."""
        with self._lock:
            devices, shape, names = self._devices, self._shape, self._axis_names
        out = []
        if len(shape) == 2:
            n_hosts, per_host = shape
            n_rows = _pow2_floor(n_hosts - 1) if n_hosts > 1 else 0
            while n_rows >= 2:
                idx = list(range(n_rows * per_host))
                out.append(Mesh([devices[i] for i in idx], names, shape=(n_rows, per_host),
                                ranks=self._ranks_of(idx)))
                n_rows //= 2
        n_flat = _pow2_floor(len(devices) - 1) if len(devices) > 1 else 0
        while n_flat >= 2:
            idx = list(range(n_flat))
            out.append(Mesh(devices[:n_flat], (mesh_mod.TYPES_AXIS,),
                            ranks=self._ranks_of(idx)))
            n_flat //= 2
        return tuple(out)

    def mode(self) -> str:
        """Which ladder rung the current layout is: "full" | "shrunk" |
        "unsharded"."""
        with self._lock:
            if not self._lost:
                return "full"
        return "shrunk" if self.current_mesh() is not None else "unsharded"

    def describe(self) -> dict:
        with self._lock:
            lost = dict(self._lost)
            return {
                "epoch": self._epoch,
                "devices": len(self._devices),
                "healthy": len(self._devices) - len(lost),
                "quarantined": {str(k): v for k, v in sorted(lost.items())},
                "shape": list(self._shape),
            }
