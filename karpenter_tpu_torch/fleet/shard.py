"""Mesh-sharded production solve: the sharded entries on the real tick.

Copy of karpenter_tpu/fleet/shard.py over the port's positional mesh
(parallel/mesh.py). The JAX engine jits the XLA bodies with K-sharded
inputs and replicated outputs; the port has no XLA scan on the card, so
every entry here is the split written out in parallel/mesh.py:

- the catalog axis K splits over the mesh's ``types`` axis: each shard
  computes the fused scan's prologue for its columns, the columns gather
  onto the primary shard and kernel A runs once there (``fused``,
  ``compact``, ``dense``: the same epilogues as solver/ffd.py);
- on a 2D ``(hosts, types)`` mesh the ``[C, K]`` blocks also split their
  class axis over ``hosts``;
- disrupt candidate pools (the ``[S, ...]`` repack/replace tensors)
  split their set axis over every shard, kernel B once per shard;
- the fractional bound's per-class rates take their minimum over the
  shards, and the float64 totals run once after the combine;
- every output is whole on the primary device, so the fetch is one local
  read -- one designed host barrier per tick (``fetch``), exactly like
  the single-device path.

The JAX engine's per-(mesh, entry, statics) state is a jit cache; the
port's is the staged catalog and the mesh's per-shard streams, and
``describe()`` lists the (entry, statics) keys each mesh has dispatched.

The pipelined contract holds unchanged: ``solve_fused`` enqueues (the
caller's fetch at the finish barrier is the one host read), and the
delta-epoch staging in ``solver/rpc.py`` is untouched -- epochs are
host-side state patched before dispatch, so per-shard epochs compose by
construction and pressure eviction/restage stays a non-error.

Operator-facing specs (``parse_mesh_spec``: ``--mesh``,
``--mesh-devices``, ``$KARPENTER_TPU_MESH``) count real devices -- cards
for ``cuda``, one for the CPU -- and raise when there are too few, as the
JAX spec parse does; several shards on one device come only from the
Python API (``make_mesh(n, devices=...)``).
"""
from __future__ import annotations

import os
import threading
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from karpenter_tpu_torch import failpoints, metrics
from karpenter_tpu_torch.fleet import topology as topo_mod
from karpenter_tpu_torch.parallel import mesh as mesh_mod
from karpenter_tpu_torch.parallel.mesh import Mesh
from karpenter_tpu_torch.solver import ffd
from karpenter_tpu_torch.solver.device_engine import DeviceEngine

# mesh layout for the production solve: "8" -> flat 8-device mesh,
# "2x4" -> (hosts, types); unset/empty/"0"/"1" -> single-device path
MESH_ENV = "KARPENTER_TPU_MESH"


def _real_devices(device) -> int:
    """How many devices of `device`'s kind a spec may count: the cards
    for cuda (0 without CUDA), one for the CPU."""
    if torch.device(device).type == "cuda":
        return torch.cuda.device_count() if torch.cuda.is_available() else 0
    return 1


def parse_mesh_spec(spec: Optional[str], device="cuda") -> Optional[Mesh]:
    """A Mesh from an operator-facing layout spec, or None for the
    single-device path. "NxM" builds the (hosts, types) 2D layout;
    a bare count builds the flat catalog-parallel mesh. A spec asking
    for more devices than exist is a configuration error and raises --
    silently shrinking the mesh would change which programs run
    without changing the operator's mental model. Specs count real
    devices (`device`'s kind): several shards on one card come only
    from make_mesh(n, devices=...)."""
    if not spec:
        return None
    spec = spec.strip().lower()
    if not spec or spec in ("0", "1", "off", "none"):
        return None
    have = _real_devices(device)
    kind = torch.device(device).type
    if "x" in spec:
        hosts_s, types_s = spec.split("x", 1)
        n_hosts, per_host = int(hosts_s), int(types_s)
        if n_hosts * per_host > have:
            raise ValueError(
                f"mesh spec {spec!r} needs {n_hosts * per_host} devices; "
                f"{have} {kind} available"
            )
        return mesh_mod.make_mesh_2d(n_hosts, per_host)
    n = int(spec)
    if n > have:
        raise ValueError(
            f"mesh spec {spec!r} needs {n} devices; {have} {kind} available"
        )
    return mesh_mod.make_mesh(n)


def mesh_from_env(device="cuda") -> Optional[Mesh]:
    return parse_mesh_spec(os.environ.get(MESH_ENV), device)


# the (entry, statics) keys each mesh has dispatched, keyed by the Mesh
# (equal meshes share it, as the JAX module cache shares programs)
_ENTRIES: Dict[Mesh, set] = {}
_ENTRIES_LOCK = threading.Lock()


class MeshSolveEngine:
    """Sharded dispatch for every production solve entry.

    One engine per mesh; TorchSolver (in-process) and SolverServer (the
    sidecar) both hold one and route their dispatches through it. Its
    dispatch surface is DeviceEngine's (solver/device_engine.py), and its
    unsharded rung is a DeviceEngine on the first healthy device.
    Decisions are byte-identical to the single-device entries (the split
    only moves work, never decisions) -- differential-asserted in
    tests/test_torch_mesh.py and by the ``mesh`` sim backend's digests."""

    replayed = False    # mesh entries take no armed graph (DeviceEngine.replayed)

    def __init__(self, mesh):
        if isinstance(mesh, int):
            mesh = mesh_mod.make_mesh(mesh)
        elif isinstance(mesh, str):
            parsed = parse_mesh_spec(mesh)
            if parsed is None:
                raise ValueError(f"mesh spec {mesh!r} parses to no mesh")
            mesh = parsed
        # the membership ledger: every dispatch syncs against it, every
        # staged catalog is stamped with the epoch it was staged under
        self.topology = topo_mod.TopologyTracker.from_mesh(mesh)
        self._full_mesh = mesh
        # reshard is a swap of the engine's mesh: one writer at a time,
        # re-entrant because stage_catalog_versioned holds it across _sync_topology
        self._topo_lock = threading.RLock()
        self._watchdog = None      # ShardStragglerWatchdog, attached by the owner
        self._apply_mesh(mesh)
        self._applied_epoch = self.topology.epoch

    def _apply_mesh(self, mesh: Optional[Mesh]) -> None:
        """Point the engine at `mesh`; ``None`` is the UNSHARDED rung of
        the degrade ladder -- dispatches fall through to the proven
        single-device entries on the first healthy device."""
        self.mesh = mesh
        self._device_engine = DeviceEngine(self.device)
        self._multiproc = mesh is not None and mesh_mod._is_multiprocess(mesh)
        metrics.MESH_DEVICES.set(float(mesh.size) if mesh is not None else 1.0)

    @property
    def device(self) -> torch.device:
        """Where staging and the primary shard live: the current mesh's
        first device; on the unsharded rung the first healthy device."""
        if self.mesh is not None:
            return self.mesh.primary
        healthy = self.topology.healthy_indices()
        return self._full_mesh.devices[healthy[0] if healthy else 0]

    # -- topology -------------------------------------------------------------
    @property
    def epoch(self) -> int:
        """The topology epoch staged catalogs are stamped with."""
        return self.topology.epoch

    def attach_watchdog(self, watchdog) -> None:
        """Bracket every dispatch with the shard-straggler watchdog's
        started/finished hooks (fleet/straggler.py)."""
        self._watchdog = watchdog

    def _sync_topology(self) -> None:
        """Lazily re-point the engine at the topology's current mesh.
        Double-checked: the unlocked epoch read keeps the healthy-path
        dispatch free of the reshard lock."""
        if self._applied_epoch == self.topology.epoch:
            return
        with self._topo_lock:
            if self._applied_epoch != self.topology.epoch:
                self._reshard()

    def _reshard(self) -> None:
        """Swap the engine onto the topology's current mesh (caller holds
        ``_topo_lock``). The restage seam of the degrade ladder: a
        failure HERE (the ``mesh.restage`` failpoint, or a mesh build
        raising on a half-dead runtime) descends one rung to the
        unsharded single-device path instead of escaping -- the engine
        must always come out of a reshard dispatchable."""
        t0 = time.monotonic()
        target = self.topology.epoch
        try:
            failpoints.eval("mesh.restage")
            self._apply_mesh(self.topology.current_mesh())
            reason = "unsharded" if self.mesh is None else self.topology.mode()
        except RuntimeError:
            metrics.HANDLED_ERRORS.inc(site="mesh.reshard")
            self._apply_mesh(None)
            reason = "restage-failed"
        self._applied_epoch = target
        metrics.MESH_RESHARDS.inc(reason=reason)
        metrics.MESH_RESHARD_SECONDS.observe(time.monotonic() - t0)

    def mark_device_lost(self, index: int, reason: str = "probe") -> bool:
        """Health-probe/operator entry: declare device `index` lost. The
        epoch bumps; the next dispatch reshards onto the survivors."""
        return self.topology.mark_lost(index, reason)

    def mark_device_returned(self, index: int) -> bool:
        """Declare device `index` healthy again; the next dispatch
        re-promotes (up to the full mesh, the original Mesh object)."""
        return self.topology.mark_returned(index)

    def quarantine_worst_device(self, reason: str = "straggler") -> Optional[int]:
        """The straggler watchdog's quarantine rung: deterministically
        pick the highest-index healthy device and mark it lost. Returns
        the quarantined index, or None when already unsharded (nothing
        left to shrink -- the watchdog escalates to its next rung)."""
        healthy = self.topology.healthy_indices()
        if self.mesh is None or len(healthy) == 0:
            return None
        idx = healthy[-1]
        self.topology.mark_lost(idx, reason)
        return idx

    def _dispatch(self, entry: str, epoch: Optional[int], fn, *args):
        """Every solve entry funnels through here: sync the topology,
        fence stale epochs, bracket the straggler watchdog, and convert
        a device-loss RuntimeError into the typed ladder rung.

        LADDER_SEAM (analysis/checkers/errflow.py): the only exceptions
        crossing this frame are ``StaleTopologyError`` (typed: staged
        epoch no longer current, or a device died mid-dispatch -- the
        caller's StaleSeqnumError rung restages and retries), plain
        ``RuntimeError`` (a real program error, NOT a device loss --
        re-raised unchanged), and ``OperatorCrashed`` (never absorbed).
        """
        from karpenter_tpu_torch.solver import rpc as rpc_mod

        self._sync_topology()
        if epoch is not None and epoch != self._applied_epoch:
            metrics.MESH_STALE_SOLVES.inc(site=entry)
            raise rpc_mod.StaleTopologyError(
                f"{entry}: staged under topology epoch {epoch}, "
                f"mesh is now at epoch {self._applied_epoch}"
            )
        metrics.MESH_DISPATCHES.inc(entry=entry)
        wd = self._watchdog
        if wd is not None:
            wd.dispatch_started(entry)
        try:
            failpoints.eval("mesh.device.lost")
            failpoints.eval("mesh.shard.stall")
            return fn(*args)
        except RuntimeError as e:
            if isinstance(e, rpc_mod.StaleSeqnumError):
                raise
            reason = topo_mod.classify_device_error(e)
            if reason is None or self.mesh is None:
                raise
            healthy = self.topology.healthy_indices()
            hint = topo_mod.device_index_hint(e)
            idx = hint if hint in healthy else (healthy[-1] if healthy else 0)
            self.topology.mark_lost(idx, reason)
            metrics.MESH_STALE_SOLVES.inc(site=entry)
            raise rpc_mod.StaleTopologyError(
                f"{entry}: device {idx} lost mid-dispatch ({reason}); "
                f"topology epoch now {self.topology.epoch}"
            ) from e
        finally:
            if wd is not None:
                wd.dispatch_finished()

    def _note(self, kind: str, statics: tuple) -> None:
        """Record (entry, statics) against the current mesh (describe())."""
        mesh = self.mesh
        if mesh is None:
            return
        with _ENTRIES_LOCK:
            _ENTRIES.setdefault(mesh, set()).add((kind,) + statics)

    def _rung(self, sharded, method: str, args: tuple, kw: dict):
        """The current rung's call (after _dispatch's topology sync):
        `sharded(mesh)`, or unsharded the DeviceEngine's `method`."""
        if self.mesh is None:
            return getattr(self._device_engine, method)(*args, **kw)
        return sharded(self.mesh)

    # -- catalog staging ------------------------------------------------------
    def stage_catalog_versioned(
        self, catalog
    ) -> Tuple[ffd.StagedCatalog, Tuple[int, ...], Tuple[int, ...], int]:
        """The catalog uploads ONCE per seqnum to the primary shard's
        device (every later solve's shards read their columns of it),
        stamped with the topology epoch it was staged under -- read under
        the reshard lock, so the stamp can never name a NEWER mesh than
        the one holding the tensors. Callers keep the stamp beside the
        staged handle and pass it back at dispatch (`epoch=`); a
        membership change in between surfaces as StaleTopologyError and
        one restage."""
        with self._topo_lock:
            self._sync_topology()
            epoch = self._applied_epoch
            staged, offsets, words, _ = self._device_engine.stage_catalog_versioned(catalog)
            return staged, offsets, words, epoch

    # -- dispatch -------------------------------------------------------------
    def solve_fused(
        self, inp: ffd.SolveInputs, *, g_max: int, nnz_max: int,
        word_offsets: Tuple[int, ...], words: Tuple[int, ...],
        objective: str = "price", epoch: Optional[int] = None,
    ) -> torch.Tensor:
        """The production tick's sharded dispatch: enqueued, one 32-bit
        buffer out on the primary device, the same fused layout as
        ffd.ffd_solve_fused -- the caller's fetch + expand_fused path is
        unchanged. `epoch` is the topology stamp the inputs were staged
        under (stage_catalog_versioned)."""
        return self._scan("fused", "solve_fused", ffd.ffd_solve_fused, inp, epoch, dict(
            g_max=g_max, nnz_max=nnz_max, word_offsets=word_offsets, words=words,
            objective=objective))

    def solve_compact(
        self, inp: ffd.SolveInputs, *, g_max: int, nnz_max: int,
        word_offsets: Tuple[int, ...], words: Tuple[int, ...],
        objective: str = "price", epoch: Optional[int] = None,
    ) -> ffd.CompactDecision:
        return self._scan("compact", "solve_compact", ffd.ffd_solve_compact, inp, epoch, dict(
            g_max=g_max, nnz_max=nnz_max, word_offsets=word_offsets, words=words,
            objective=objective))

    def solve_dense(
        self, inp: ffd.SolveInputs, *, g_max: int,
        word_offsets: Tuple[int, ...], words: Tuple[int, ...],
        objective: str = "price", epoch: Optional[int] = None,
    ) -> ffd.SolveOutputs:
        return self._scan("dense", "solve_dense", ffd.ffd_solve, inp, epoch, dict(
            g_max=g_max, word_offsets=word_offsets, words=words, objective=objective))

    def _scan(self, entry: str, method: str, fn, inp: ffd.SolveInputs, epoch: Optional[int],
              kw: dict):
        """fused, compact and dense: each shard computes the prologue for
        its columns, and `fn` (the ffd entry) runs kernel A once on the
        primary device. `kw`'s values, in order, key describe()."""
        def sharded(mesh):
            self._note(entry, tuple(kw.values()))
            cols = mesh_mod.sharded_scan_columns(mesh, inp, kw["word_offsets"], kw["words"],
                                                 kw["objective"])
            return fn(inp, columns=cols, **kw)

        return self._dispatch(entry, epoch, self._rung, sharded, method, (inp,), kw)

    def refetch_dense(
        self, inp: ffd.SolveInputs, *, g_max: int,
        word_offsets: Tuple[int, ...], words: Tuple[int, ...],
        objective: str = "price", epoch: Optional[int] = None,
    ) -> tuple:
        """`solve_dense` read through the fenced barrier as the decode
        tuple: the refetch when a fused buffer's sparse take overflowed."""
        f = self.fetch(self.solve_dense(inp, g_max=g_max, word_offsets=word_offsets, words=words,
                                        objective=objective, epoch=epoch), epoch=epoch)
        return (f.take, f.unplaced, int(f.n_open), f.gmask, f.gzone, f.gcap)

    def price_bound(
        self, inp: ffd.SolveInputs, placed, *,
        word_offsets: Tuple[int, ...], words: Tuple[int, ...],
        epoch: Optional[int] = None,
    ) -> torch.Tensor:
        """The optimality-gap bound's sharded dispatch (solver/bound.py):
        enqueued, [R] totals out on the primary device -- the caller's
        fetch_bound barrier is unchanged."""
        kw = dict(word_offsets=word_offsets, words=words)

        def sharded(mesh):
            placed_t = (placed if isinstance(placed, torch.Tensor)
                        else ffd._to_device(np.asarray(placed, np.float32), inp.req.device))
            self._note("bound", (word_offsets, words))
            return mesh_mod.sharded_price_bound(mesh, inp, placed_t, **kw)

        return self._dispatch("bound", epoch, self._rung, sharded, "price_bound", (inp, placed), kw)

    def repack(self, headroom, feas, req, member, excl, *, epoch: Optional[int] = None):
        """Disrupt candidate-pool repack, set axis split over every shard
        (kernel B once per shard; the results concatenate on the primary
        device). Host arrays upload through the pinned path."""
        return self._repack((headroom, feas, req, member, excl), epoch, leftover_only=False)

    def repack_leftover(self, headroom, feas, req, member, excl, *, epoch: Optional[int] = None):
        """`repack`'s [S, C] leftovers alone (the sweep's, as the sidecar's
        ``solve_disrupt`` op serves it): kernel B's leftover-only entry, no
        [S, C, N] takes on any shard. Dispatched and counted as `repack`."""
        return self._repack((headroom, feas, req, member, excl), epoch, leftover_only=True)

    def _repack(self, arrays, epoch: Optional[int], *, leftover_only: bool):
        def sharded(mesh):
            self._note("repack", ())
            if leftover_only:
                return mesh_mod.sharded_repack_leftover(mesh, *arrays)
            return mesh_mod.sharded_repack(mesh, *arrays)

        return self._dispatch("repack", epoch, self._rung, sharded,
                              "repack_leftover" if leftover_only else "repack", arrays, {})

    def replace(self, leftover, creq, compat, azone, acap, cap, ovh, price, *,
                od_col: int, epoch: Optional[int] = None):
        """Disrupt replacement search: leftover split on the set axis over
        every shard, the catalog's cap/price replicated."""
        args = (leftover, creq, compat, azone, acap, cap, ovh, price)

        def sharded(mesh):
            self._note("replace", (od_col,))
            return mesh_mod.sharded_replace(mesh, *args, od_col=od_col)

        return self._dispatch("replace", epoch, self._rung, sharded, "replace", args,
                              dict(od_col=od_col))

    def fetch(self, out, *, epoch: Optional[int] = None):
        """SANCTIONED_FETCH site (analysis/checkers/torch_discipline.py):
        the mesh engine's designed host barrier. Outputs are already
        whole on the primary device (the gathers), so this is one local
        read. With an `epoch`, the barrier is fenced: reading a buffer
        computed on a mesh that has since lost a device would block on a
        dead chip, so a stale stamp raises StaleTopologyError BEFORE the
        read and the caller's staging-gap rung re-solves on the current
        topology. A fused buffer and packed lanes come back as uint32
        (the JAX package's dtypes)."""
        if epoch is not None and epoch != self.topology.epoch:
            from karpenter_tpu_torch.solver import rpc as rpc_mod

            metrics.MESH_STALE_SOLVES.inc(site="fetch")
            raise rpc_mod.StaleTopologyError(
                f"fetch: buffer computed at topology epoch {epoch}, "
                f"mesh is now at epoch {self.topology.epoch}"
            )
        if isinstance(out, torch.Tensor):
            return ffd.fetch_fused(out)
        if isinstance(out, ffd.CompactDecision):
            return ffd.CompactDecision(**ffd.fetch_compact(out))
        host = [t.cpu().numpy() for t in out]
        return type(out)(*host) if hasattr(out, "_fields") else tuple(host)

    def describe(self) -> dict:
        """Mesh shape, the dispatched (entry, statics) keys of the current
        mesh, and the topology ledger, for /debug and the fleet stage."""
        mesh = self.mesh
        with _ENTRIES_LOCK:
            entries = sorted(str(k) for k in _ENTRIES.get(mesh, ())) if mesh is not None else []
        return {
            "devices": int(mesh.size) if mesh is not None else 1,
            "axes": (
                {name: int(size) for name, size in zip(mesh.axis_names, mesh.shape)}
                if mesh is not None else {}
            ),
            "multiprocess": bool(self._multiproc),
            "entries": entries,
            "topology": self.topology.describe(),
            "mode": self.topology.mode(),
        }
