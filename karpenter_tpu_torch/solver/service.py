"""TorchSolver: the provisioning solve on the GPU, with schedule() routing.

Counterpart of the in-process path of TPUSolver
(karpenter_tpu/solver/service.py). `schedule(scheduler, pods)` is the
entry point the provisioner calls: it decides, per batch, which pods the
device solve places and which go to the pure-Python oracle `Scheduler`
(solver/oracle.py), exactly as TPUSolver.schedule does:

    device                all classes on the card
    device+suffix         (anti-)affinity/preference classes continue on
                          the oracle after the device pass
    prefix+device         minValues classes on the oracle before it
    prefix+device+suffix  both
    merged                overlapping pools in one joint-catalog solve
                          (solver/multipool.py)
    oracle                the whole batch on the oracle

`solve` = `solve_finish(solve_begin(...))` is the inner, single-pool call:

    host    group_pods, spread split       pods -> classes, zone-spread
                                           classes -> zone-pinned chunks
    device  _pack_existing                 kernel B (S=1) packs pending pods
                                           onto existing nodes
    host    encode_classes                 classes -> dense arrays
    device  ffd.ffd_solve_fused            prologue, kernel A, fused buffer
    device  convex_relax (tier="convex")   the LP relaxation, enqueued
                                           behind the FFD solve
    host    one fetch, expand_fused        the FFD decision
    host    rounding, choose (convex)      the never-worse placement
    device  fractional_price_bound         enqueued before decode
    host    _decode -> NewNodeGroups
    host    fetch_bound, solve_quality     -> last_quality

The catalog is staged on the device once per catalog list. Each tick
fetches one fused buffer; the dense refetch runs only when the sparse
take overflows its budget.

Degrade rungs, as TPUSolver's (`_dispatch_convex`, `_finish_convex`,
`_begin_quality`, `_finish_quality`): a failure of the relaxation's
dispatch or fetch makes the tick the FFD tick bit for bit
(`karpenter_convex_fallbacks_total{reason="dispatch"}`); a rounding
exception or a rounding that returns None leaves `choose` the FFD
placement (`{reason="rounding"}`); a failure of the observe-only bound
costs the tick its quality document only
(`karpenter_handled_errors_total{site="solver.quality_dispatch"|
"solver.quality_finish"}`). Each rung counts and logs once per change
of its exception type; `failpoints.OperatorCrashed`, a BaseException,
escapes every one. The failpoint sites `solver.solve_begin`,
`solver.solve_finish`, `rpc.convex.dispatch` and `convex.rounding`
(solver/convex/rounding.py) drill them; the tick's spans carry the JAX
package's names (tracing.py).

The wire (`client=`, solver/rpc.py): with a `SolverClient` the tensor
half of every solve goes to the sidecar -- `python -m
karpenter_tpu_torch.solver.rpc` on the card, or the JAX package's
sidecar -- exactly as in TPUSolver: the catalog stages once per seqnum,
`solve_begin` streams a compact (or delta) solve frame with
`begin_solve_compact` and `solve_finish` claims it (`_finish_remote_wire`:
the pipelined reply, then the synchronous compact op, then the dense op);
the convex tier sends one `solve_convex` op at the barrier. Grouping,
encode, the existing-node pre-pass (kernel B on this solver's device)
and decode stay in process. Wire ticks publish `last_quality` without the
fractional bound, as TPUSolver's do (nothing is staged locally to bound
against; a convex wire tick's document carries the sidecar's lower
bound), and `last_convex` is the sidecar's certificate (`winner`,
`lower`, `iterations`, `fallback`, `price_ffd`, `price_convex`).

The breaker (`breaker=`, solver/breaker.py; a self-probing one by
default when a client is given): a whole failed wire ladder solves the
tick in process (`fallback="rpc-down"`) and counts toward opening the
breaker; while it is open, `solve_begin` skips the wire before any socket
work and solves in process (`fallback="breaker-open"`). The in-process
rung runs on this solver's device -- the card unless device="cpu" -- and
decides exactly as the wire does. Each rung tick counts where the JAX
package counts it -- `karpenter_scheduler_pipeline_fallbacks_total{
reason="rpc-down"}` or `karpenter_scheduler_breaker_short_circuits_total`
-- and nowhere else, so both registries read alike after the same run;
each rung logs once per change.

Cold start (solver/aot.py), as TPUSolver's: `auto_warm=True` warms every
class-count bucket of `WARM_C_PADS` in a background thread on each freshly
staged catalog (in process only); `warm(instance_types, c_pads)` does it
on the calling thread. On the card a warm call runs the real kernels --
it loads the libraries, raises their shared-memory ceilings, loads lazy
modules and grows the allocator -- never a plain version. A tick whose
class-count bucket was not warmed logs so once per new (c_pad, catalog
geometry) key. `enable_aot(exec_dir, ...)` loads the kernel-library store
and runs the warm-up ladder over every staged catalog; the dispatch
seams (`_dispatch_fused`, `_dispatch_bound`, `_dispatch_convex`,
`_dispatch_disrupt_repack`) then replay an armed CUDA graph where one
matches exactly (`karpenter_solver_kernel_dispatches_total{impl="aot"}`
for the two kernels' entries), and take the ordinary dispatch of the
same kernel on any miss or counted rung. `describe_aot()` is the
/debug/aot document.

Host-to-device uploads of a tick go through page-locked staging buffers
with non_blocking copies (ffd._to_device), held on the _PendingSolve
until its fetch has returned: the tick waits for the card only at its
sanctioned fetches (analysis/sync_witness.py).

The mesh (`mesh=`, fleet/shard.py), as TPUSolver's: with a
`MeshSolveEngine` (or a `parallel.mesh.Mesh`) and no client, catalog
staging goes through the engine, stamped with its topology epoch, and the
fused solve and the bound dispatch through its sharded entries -- the
shards' prologue, kernel A once on the primary shard -- while the
existing-node pre-pass (kernel B, S=1) and the convex relaxation stay
unsharded, as in the JAX package. Mesh entries never take an armed
graph. A topology change between ticks restages the same encoding under
a fresh seqnum; a change mid-dispatch (`StaleTopologyError`) re-enters
`solve_begin` once per epoch step; a change before the barrier re-solves
(`karpenter_scheduler_pipeline_fallbacks_total{reason="stale-topology"}`).
"""
from __future__ import annotations

import threading
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from karpenter_tpu_torch import failpoints, metrics, tracing
from karpenter_tpu_torch.apis import NodePool, Pod, labels as wk
from karpenter_tpu_torch.logging import ChangeMonitor, get_logger
from karpenter_tpu_torch.scheduling import (
    Operator, Requirement, Requirements, Resources, tolerates_all,
)
from karpenter_tpu_torch.scheduling import resources as res
from karpenter_tpu_torch.obs import hbm, quality
from karpenter_tpu_torch.solver import bound, encode, ffd, multipool, rpc, spread
from karpenter_tpu_torch.solver.breaker import CircuitBreaker
from karpenter_tpu_torch.solver.convex import relax, rounding
from karpenter_tpu_torch.solver.convex import tier as convex_tier
from karpenter_tpu_torch.solver.disrupt import engine as disrupt_engine
from karpenter_tpu_torch.solver.disrupt import kernel as disrupt_kernel
from karpenter_tpu_torch.solver.encode import CatalogTensors
from karpenter_tpu_torch.solver.oracle import (
    _ALLOW_UNDEFINED, ExistingNode, NewNodeGroup, Scheduler, SchedulingResult,
)
from karpenter_tpu_torch.utils import gc_paused

_bucket = encode.bucket
_C_PAD_MIN = 16     # smallest class bucket: few shapes, few padded rows


def resolve_device(device=None) -> torch.device:
    """`None` means the card. Without CUDA that is an error, not a quiet
    move to the CPU: only an explicit device="cpu" runs there."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "TorchSolver runs on a CUDA device and none is available; "
                "pass device='cpu' to run the plain torch versions on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def _impl(t: torch.Tensor) -> str:
    """The SOLVER_KERNEL_DISPATCHES impl of a kernel call on `t`: a CUDA
    tensor launches the kernel, a CPU tensor runs its plain version."""
    return "cuda" if t.is_cuda else "plain"


def _note_dispatch(entry: str, impl: str) -> None:
    """Stamp a kernel dispatch on the current span: its `dispatch`
    attribute maps each entry the span dispatched to the implementation
    that ran (`aot`: an armed graph replayed), so a traced tick shows a
    kernel built or launched outside the warm-up ladder."""
    cur = tracing.TRACER.current()
    if cur is not None:
        cur.attributes.setdefault("dispatch", {})[entry] = impl


def _count_dispatch(entry: str, impl: str) -> None:
    metrics.SOLVER_KERNEL_DISPATCHES.inc(entry=entry, impl=impl)
    _note_dispatch(entry, impl)


def _spread_keys(classes) -> set:
    """Topology-spread identity per class representative -- spread counts
    are global per (topology key, selector), so two partitions sharing a
    key would need shared state (both partition guards check this)."""
    return {
        (t.topology_key, tuple(sorted(t.label_selector.items())))
        for pc in classes
        for t in pc.pods[0].topology_spread
    }


class _CatalogEntry(NamedTuple):
    """One catalog's immutable staged snapshot (see TorchSolver._catalog)."""

    tensors: CatalogTensors
    staged: ffd.StagedCatalog
    offsets: Tuple[int, ...]
    words: Tuple[int, ...]
    types_by_price: np.ndarray         # object array, cheapest first
    order: np.ndarray                  # argsort indices into the catalog list
    catalog_list: Sequence             # strong ref: keeps the id() key sound
    row_cache: dict                    # encode_classes row memo for this encoding
    # the wire seqnum this snapshot stages under on the sidecar
    seqnum: str = ""
    # merged multi-pool solves only (solver/multipool.py): pool index per
    # real column, the pool objects (weight order), and the ORIGINAL type
    # objects in types_by_price order for decode emission
    col_pools: Optional[np.ndarray] = None
    pools: Optional[tuple] = None
    decode_types: Optional[np.ndarray] = None
    # mesh mode only (fleet/topology.py): the topology epoch the catalog
    # was staged under. _catalog revalidates it -- a device loss/return
    # between ticks restages the SAME encoding onto the new mesh under a
    # fresh seqnum, and a mid-dispatch change surfaces as
    # StaleTopologyError
    mesh_epoch: Optional[int] = None


class _MergedVirtualPool(NodePool):
    """The solve-level stand-in pool for merged multi-pool dispatches: no
    requirements of its own (each class carries its admitted-pool pin; each
    column carries its pool's requirements), no taints (toleration is part
    of host-side admission), no limits (carved out)."""

    def requirements(self):
        return Requirements()


class _PendingSolve:
    """One solve split at the device dispatch: `solve_begin` runs the host
    stages and enqueues the device work; `solve_finish` fetches, expands
    and decodes. A ticket with nothing in flight carries its result."""

    __slots__ = ("done", "pool", "entry", "class_set", "result", "placed_existing",
                 "nodepool_usage", "buf", "inp", "nnz_max", "cx", "rpc_handle", "uploads",
                 "call_args", "call_kwargs")

    def __init__(self, done: Optional[SchedulingResult] = None):
        self.done = done
        # the in-process dispatch's fused buffer and inputs (None on the wire)
        self.buf = None
        self.inp = None
        # the convex tier's in-flight RelaxOutputs (None on the FFD tier)
        self.cx = None
        # the pipelined wire solve's reply slot (None: the barrier runs
        # the synchronous wire ladder)
        self.rpc_handle = None
        # the pinned staging buffers of this solve's uploads, kept until
        # the barrier's fetch has waited for their copies
        self.uploads = None
        # solve()'s arguments, for the mesh's stale-topology re-solve
        self.call_args = ()
        self.call_kwargs = {}

    @property
    def completed(self) -> bool:
        return self.done is not None


class TorchSolver:
    log = get_logger("solver")

    def __init__(self, g_max: int = 1024, objective: str = "price", device=None,
                 incremental: bool = True, tier: str = "ffd", client=None, breaker=None,
                 auto_warm: bool = False, mesh=None):
        if objective not in ("price", "fit"):
            raise ValueError(f"objective must be 'price' or 'fit', got {objective!r}")
        # the solve tier: "convex" enqueues the LP relaxation next to the
        # FFD solve, rounds it at the finish barrier and takes the rounded
        # placement only when it is strictly cheaper without leaving more
        # pods of any class behind (solver/convex/tier.py)
        if tier not in ("ffd", "convex"):
            raise ValueError(f"tier must be 'ffd' or 'convex', got {tier!r}")
        # mesh-sharded production solve (fleet/shard.py): with a mesh
        # configured (and no wire client -- the sidecar owns its own mesh
        # in remote mode), catalog staging and the fused solve and bound
        # route through the MeshSolveEngine's sharded entries, on the
        # mesh's primary device. Decisions are byte-identical to the
        # single-device path, so everything downstream -- pipelining, the
        # degrade ladder -- is untouched.
        self.mesh_engine = None
        if mesh is not None and client is None:
            from karpenter_tpu_torch.fleet.shard import MeshSolveEngine
            from karpenter_tpu_torch.parallel.mesh import _norm_device

            self.mesh_engine = (
                mesh if isinstance(mesh, MeshSolveEngine) else MeshSolveEngine(mesh))
            if device is not None and _norm_device(device) != self.mesh_engine.device:
                raise ValueError(f"TorchSolver(device={device!r}) differs from the mesh's "
                                 f"primary device {self.mesh_engine.device}")
            device = self.mesh_engine.device
        self.device = resolve_device(device)
        self.tier = tier
        # the last convex differential: {"winner", "price_ffd",
        # "price_convex", "lower", "iterations"}
        self.last_convex: Optional[dict] = None
        # the last device solve's quality document (obs/quality.py):
        # optimality gap against the fractional bound, waste attribution,
        # price decomposition; observe-only
        self.last_quality: Optional[dict] = None
        # auto_warm: warm every class-count bucket in a background thread
        # whenever a new catalog is staged (see warm()); opt-in, as in
        # TPUSolver
        self.auto_warm = auto_warm
        # warm-coverage keys (_warm_key) of the buckets warm() dispatched
        self._warmed_pads: set = set()
        self._warm_thread: Optional[threading.Thread] = None
        # g_max sized for the price objective at 50k pods: cost-optimal
        # packing opens ~1.6x the groups max-fit does
        self.g_max = g_max
        self.objective = objective
        # catalog entries keyed by list identity, LRU-capped: one solver
        # serves several nodepools whose catalogs alternate within a tick
        self._catalog_cache: Dict[int, _CatalogEntry] = {}
        self._catalog_cache_cap = 8
        # the cross-tick grouping cache (encode.IncrementalGrouper): the
        # same classes as group_pods, with per-signature canonical work
        # memoized across ticks; incremental=False groups afresh each call
        self.incremental = incremental
        self._grouper = encode.IncrementalGrouper()
        self.last_group_stats = dict(self._grouper.last_stats)
        # routing of the last schedule() batch
        self.last_route = {"device_pods": 0, "oracle_pods": 0, "path": "none"}
        # merged multi-pool catalog lists, keyed by (per-pool catalog ids,
        # per-pool requirement hashes, overheads, taints); bounded
        self._merged_cache: Dict[tuple, tuple] = {}
        # device-memory attribution (obs/hbm.py): bytes of the last
        # solve's input tensors and of its open/join masks (packed, and
        # the full-width bool form they stand for)
        self._last_solve_bytes = 0
        self._last_mask_bytes = 0
        self._last_mask_full_bytes = 0
        # degrade rungs log once per change (logging.ChangeMonitor)
        self._route_monitor = ChangeMonitor()
        self._lock = threading.Lock()
        # held by each dispatch seam while it enqueues and by each warm-up
        # ladder task while it captures (solver/aot.py)
        self._dispatch_lock = threading.RLock()
        # the cold-start layer (solver/aot.py), armed by enable_aot(): None
        # means every dispatch takes the ordinary path
        self._aot = None
        # the sidecar (solver/rpc.SolverClient, or anything speaking its
        # surface): the tensor half of each solve goes over the wire
        self.client = client
        # wire seqnums: a per-solver random prefix plus a counter bumped on
        # every encode (id() is unsound across catalog lifetimes, and two
        # controllers must never collide on a shared sidecar)
        import uuid

        self._seq_prefix = uuid.uuid4().hex[:12]
        self._seq_counter = 0
        # the wire's circuit breaker: default-on with a client, self-probing
        # (auto_probe) so an embedder that never calls maybe_probe()
        # recovers; breaker=False disables it
        if breaker is None and client is not None:
            breaker = CircuitBreaker(auto_probe=True)
        self.breaker = breaker if breaker else None
        if self.breaker is not None:
            if self.breaker._probe is None:
                self.breaker._probe = self._probe_sidecar
            if self.breaker._on_promote is None:
                self.breaker._on_promote = self._on_wire_restored

    # -- the cold-start layer (solver/aot.py) ---------------------------------
    def enable_aot(self, exec_dir: Optional[str] = None, serialize: bool = True,
                   duty: float = 0.05, pads: Optional[Sequence[int]] = None):
        """Arm the cold-start layer: load the kernel-library store at
        `exec_dir` NOW (the restart path), and run the warm-up ladder over
        every staged catalog from here on. In process only: a sidecar
        owns its own. Returns the manager, or None in wire mode."""
        if self.client is not None:
            return None
        from karpenter_tpu_torch.solver import aot as aot_mod

        self._aot = aot_mod.AotManager(
            self, exec_dir=exec_dir, serialize=serialize, duty=duty, pads=pads)
        self._aot.load_store()
        return self._aot

    def describe_aot(self) -> dict:
        """The /debug/aot document ({} while AOT is not enabled)."""
        return self._aot.describe() if self._aot is not None else {}

    def stop_warm_up(self, timeout_s: float = 60.0) -> None:
        """Stop the warm-up ladder and wait, at most `timeout_s` each, for
        its task and a background warm in flight: a process ending mid-
        capture would tear CUDA down under them."""
        if self._aot is not None:
            self._aot.stop(timeout_s=timeout_s)
        if self._warm_thread is not None:
            self._warm_thread.join(timeout_s)

    # -- catalog staging ----------------------------------------------------
    def _catalog(self, instance_types: Sequence) -> _CatalogEntry:
        """The staged-catalog snapshot for one catalog list, memoized by
        object identity. The entry holds a strong reference to the keyed
        list, which makes the id() key sound; staging uploads the catalog
        to the device once, and per-tick solves move only class tensors."""
        key = id(instance_types)
        staged_entry = None
        with self._lock:
            entry = self._catalog_cache.pop(key, None)
            if entry is not None and entry.catalog_list is instance_types:
                if (
                    self.mesh_engine is not None
                    and entry.mesh_epoch != self.mesh_engine.epoch
                ):
                    # topology changed since this catalog was staged:
                    # restage the SAME encoding (tensors/row_cache survive)
                    # onto the current mesh under a FRESH seqnum, so
                    # in-flight barriers legally fall back -- exactly one
                    # restage per epoch change, never a loop (the stamp is
                    # read under the engine's reshard lock)
                    staged, offsets, words, tepoch = (
                        self.mesh_engine.stage_catalog_versioned(entry.tensors))
                    self._seq_counter += 1
                    entry = entry._replace(
                        staged=staged, offsets=offsets, words=words,
                        seqnum=f"{self._seq_prefix}-{self._seq_counter}",
                        mesh_epoch=tepoch,
                    )
                self._catalog_cache[key] = entry   # LRU touch (and publish)
                return entry
            tensors = encode.encode_catalog(instance_types)
            tepoch = None
            if self.client is not None:
                # remote mode: the sidecar stages on ITS device; the
                # in-process rungs stage locally on first use
                staged, offsets, words = None, (), ()
            elif self.mesh_engine is not None:
                # fleet: staged through the engine, stamped with the
                # topology epoch it was staged under
                staged, offsets, words, tepoch = (
                    self.mesh_engine.stage_catalog_versioned(tensors))
            else:
                staged, offsets, words = ffd.stage_catalog(tensors, self.device)
            # decode acceleration: type objects pre-sorted by cheapest
            # price so a group's survivors are one boolean fancy-index
            prices = np.array([it.cheapest_price() for it in instance_types])
            order = np.argsort(prices, kind="stable")
            self._seq_counter += 1
            entry = _CatalogEntry(
                tensors=tensors, staged=staged, offsets=offsets, words=words,
                types_by_price=np.array(list(instance_types), dtype=object)[order],
                order=order, catalog_list=instance_types, row_cache={},
                seqnum=f"{self._seq_prefix}-{self._seq_counter}", mesh_epoch=tepoch,
            )
            self._catalog_cache[key] = entry
            while len(self._catalog_cache) > self._catalog_cache_cap:
                self._catalog_cache.pop(next(iter(self._catalog_cache)))
            # memory-pressure eviction (obs/hbm.py): with the card's
            # headroom below the evict threshold, shrink to the entry just
            # staged; dropping the references frees its device tensors.
            # No ledger (the CPU, or CUDA not initialized) = capacity only
            if len(self._catalog_cache) > 1 and hbm.under_pressure():
                while len(self._catalog_cache) > 1:
                    self._catalog_cache.pop(next(iter(self._catalog_cache)))
                    metrics.SOLVER_STAGED_PRESSURE_EVICTIONS.inc(kind="catalog")
            if staged is not None:
                staged_entry = entry
        if staged_entry is not None and self.auto_warm:
            self._warm_thread = threading.Thread(
                target=self._bg_warm, args=(staged_entry,), daemon=True,
                name="torchsolver-warm",
            )
            self._warm_thread.start()
        # the warm-up ladder (solver/aot.py) re-plans over every freshly
        # staged catalog in the background
        if staged_entry is not None and self._aot is not None:
            self._aot.on_catalog(staged_entry)
        return entry

    def _local_staged(self, entry: _CatalogEntry) -> _CatalogEntry:
        """The entry with tensors staged on this solver's device: remote
        entries stage on the sidecar only, but the breaker-open and
        wire-dead rungs solve in process against the SAME snapshot.
        Memoized back into the cache under the same seqnum."""
        if entry.staged is not None:
            return entry
        staged, offsets, words = ffd.stage_catalog(entry.tensors, self.device)
        entry2 = entry._replace(staged=staged, offsets=offsets, words=words)
        with self._lock:
            cur = self._catalog_cache.get(id(entry.catalog_list))
            if (
                cur is not None
                and cur.catalog_list is entry.catalog_list
                and cur.seqnum == entry.seqnum
            ):
                self._catalog_cache[id(entry.catalog_list)] = entry2
        return entry2

    def _bg_warm(self, entry: _CatalogEntry) -> None:
        from karpenter_tpu_torch.analysis import sync_witness

        try:
            # warm-up's syncs are not the tick's (sync_witness.aot_phase)
            with sync_witness.aot_phase():
                self._warm_entry(entry)
        except Exception as e:  # noqa: BLE001 - warm-up is best-effort
            self.log.info("background bucket warm-up failed", error=repr(e))

    # class-count buckets warmed: powers of two up to the group-slot budget
    # (g_max defaults to 1024 -- more classes than groups cannot all place
    # anyway). A dispatch beyond the warmed set still works; its first
    # dispatch pays the cold costs once and logs it (see solve_begin)
    WARM_C_PADS = (16, 32, 64, 128, 256, 512, 1024)

    def warm(self, instance_types: Sequence, c_pads: Sequence[int] = WARM_C_PADS) -> None:
        """Dispatch the solve and its bound once for every class-count
        bucket a live tick is expected to hit, so no tick pays a bucket's
        first dispatch: on the card the kernels' libraries load, their
        shared-memory ceilings rise, lazy modules load and the allocator
        grows here. Zero-class sets dispatch the same shapes the real
        ones do. In process only."""
        if self.client is not None:
            return
        self._warm_entry(self._catalog(instance_types), c_pads)

    @staticmethod
    def _warm_key(c_pad: int, entry: _CatalogEntry) -> tuple:
        """Warm-coverage key: a bucket is warm per catalog geometry, so
        the key is (c_pad, k_pad, offsets, words), as TPUSolver's."""
        return (c_pad, entry.tensors.k_pad, entry.offsets, entry.words)

    def _warm_entry(self, entry: _CatalogEntry, c_pads: Sequence[int] = WARM_C_PADS) -> None:
        """Warm from a pinned snapshot: the warm thread never re-stages
        (its catalog may already be stale by the time it runs)."""
        # bound the geometry-keyed coverage BEFORE adding this entry's keys
        # (a cleared stale key merely re-fires the unwarmed-bucket log once)
        if len(self._warmed_pads) > 128:
            self._warmed_pads.clear()
        for cp in c_pads:
            cs = encode.encode_classes([], entry.tensors, c_pad=cp)
            inp = ffd.make_inputs_staged(entry.staged, cs, packed_masks=True)
            self._dispatch_fused(inp, ffd.nnz_budget(cp, self.g_max), entry.offsets, entry.words)
            # the bound runs behind every solve, so its shape warms too
            self._dispatch_bound(inp, np.zeros((cp,), np.float32), entry.offsets, entry.words)
            self._warmed_pads.add(self._warm_key(cp, entry))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- wire health (solver/breaker.py) -------------------------------------
    def wire_healthy(self) -> bool:
        """True while the solve path needs no degraded handling: no wire,
        or the breaker is closed. The JAX provisioner gates its
        double-buffered tick on this."""
        return self.client is None or self.breaker is None or self.breaker.allow()

    def _probe_sidecar(self) -> bool:
        """The breaker's half-open probe: one bounded ping on a THROWAWAY
        connection (no ring, no transport gauge), so a wedged sidecar
        fails the probe fast and the probe stays off the real client's
        lock."""
        if self.client is None:
            return False
        c = self.client
        probe = None
        try:
            probe = rpc.SolverClient(
                c.addr[0] if c.addr else None, c.addr[1] if c.addr else None,
                timeout=max(2.0, 2.0 * c.connect_timeout), path=c.path,
                token=c.token, ssl_context=c._ssl_context,
                server_hostname=c._server_hostname,
                connect_timeout=c.connect_timeout,
                shm=False, track_transport=False,
            )
            return bool(probe.ping())
        except Exception:  # noqa: BLE001 -- any wire failure = not recovered
            return False
        finally:
            if probe is not None:
                probe.close()

    def _on_wire_restored(self) -> None:
        """Re-promotion gate: drop the stale connection so the first
        post-promotion solve reconnects, re-auths and RE-STAGES the
        catalog (close() clears the per-connection staged seqnums)."""
        try:
            self.client.close()
        except Exception:  # noqa: BLE001 -- closing a dead socket is best-effort
            metrics.HANDLED_ERRORS.inc(site="solver.wire_restored_close")

    def describe_wire(self) -> dict:
        """Delta/staging state document for /debug/solver: the grouping
        churn stats, the last solve's shipping mode, staged bytes by
        owner, the client's staged seqnums and epoch bases, and
        (best-effort) the sidecar's own staging/eviction counters via the
        debug op, and the per-entry table of obs/jitstats.py."""
        from karpenter_tpu_torch.obs import jitstats

        doc = {
            "incremental": self.incremental,
            "group_stats": dict(self.last_group_stats),
            "wire": self.client is not None,
            "staged_bytes": self.staged_bytes_by_kind(),
            "jit_entries": jitstats.table(),
        }
        c = self.client
        if c is None:
            return doc
        doc["delta_enabled"] = c.delta
        doc["last_delta"] = dict(c.last_delta)
        doc["transport"] = "shm" if c._ring is not None else "tcp"
        doc["shm_enabled"] = c.shm
        doc["shm_failures"] = c._shm_failures
        doc["last_reply"] = dict(c.last_reply)
        with c._lock:
            doc["staged_seqnums"] = sorted(c._staged_seqnums)
            doc["epoch_bases"] = {sn: e for sn, (e, _) in c._epoch_bases.items()}
            pending = len(c._pending)
        doc["replies_in_flight"] = pending
        # the debug op is a synchronous roundtrip under the client lock:
        # skip it while a pipelined reply is in flight
        if self.wire_healthy() and pending == 0:
            try:
                server = c.debug_info()
                doc["server"] = {
                    k: server[k]
                    for k in ("staged_seqnums", "class_epochs",
                              "disrupt_epochs", "evictions", "staged_bytes")
                    if k in server
                }
            except Exception:  # noqa: BLE001 -- debug output must never fail a probe
                metrics.HANDLED_ERRORS.inc(site="solver.describe_wire")
        return doc

    def staged_bytes_by_kind(self) -> Dict[str, int]:
        """Staged tensor bytes by owner (TPUSolver.staged_bytes_by_kind):
        ``catalog`` = every LRU entry's host encoding and device-staged
        tensors, ``class_masks`` / ``class_masks_full_equiv`` = the last
        solve's open/join masks as staged (packed) and in full-width
        bool, ``solve_temporaries`` = the last solve's input tensors.
        Metadata reads only (nbytes), mirrored into
        karpenter_solver_staged_bytes{kind}."""
        with self._lock:
            entries = list(self._catalog_cache.values())
            temporaries = self._last_solve_bytes
            mask_bytes = self._last_mask_bytes
            mask_full = self._last_mask_full_bytes
        catalog = sum(hbm.sum_nbytes(e.tensors) + hbm.sum_nbytes(e.staged) for e in entries)
        metrics.SOLVER_STAGED_BYTES.set(float(catalog), kind="catalog")
        metrics.SOLVER_STAGED_BYTES.set(float(mask_bytes), kind="class_masks")
        metrics.SOLVER_STAGED_BYTES.set(float(temporaries), kind="solve_temporaries")
        metrics.SOLVER_PACKED_MASK_BYTES.set(float(mask_bytes), form="packed")
        metrics.SOLVER_PACKED_MASK_BYTES.set(float(mask_full), form="full_equiv")
        return {
            "catalog": int(catalog),
            "class_masks": int(mask_bytes),
            "class_masks_full_equiv": int(mask_full),
            "solve_temporaries": int(temporaries),
        }

    # -- routing ------------------------------------------------------------
    @staticmethod
    def supports(scheduler: Scheduler, pods: Sequence[Pod], classes=None,
                 overlap: Optional[bool] = None) -> bool:
        """True when the batch may take a device route (TPUSolver.supports):
        routing features live on the classes, so a 50k-pod scan becomes a
        few dozen class checks."""
        if classes is None:
            classes = encode.group_pods(pods)
        # un-encodable requirement keys (custom labels, zone-id, ...): two
        # classes with DIFFERENT constraints on one such key would falsely
        # share groups on the device, so they take the oracle
        unenc: Dict[str, set] = {}
        for pc in classes:
            for r in pc.requirements:
                if r.key not in encode.ENCODABLE_KEYS:
                    unenc.setdefault(r.key, set()).add(
                        (r.complement, tuple(sorted(r.values)), r.greater_than, r.less_than))
        if any(len(v) > 1 for v in unenc.values()):
            return False
        # minValues classes split off to an oracle prefix unless every
        # class is affected or the two partitions could contend
        mv_classes = TorchSolver._mv_classes(scheduler, classes)
        if mv_classes:
            mv_ids = {id(pc) for pc in mv_classes}
            rest = [pc for pc in classes if id(pc) not in mv_ids]
            if not rest or TorchSolver._mv_partition_blocked(scheduler, mv_classes, rest):
                return False
        # affinity/preference classes sort last in the canonical order and
        # continue on the oracle after the device pass, provided the
        # partitions cannot interact and the pools do not overlap
        aff_classes = TorchSolver._suffix_classes(classes)
        device_classes = classes
        if aff_classes:
            aff_ids = {id(pc) for pc in aff_classes}
            device_classes = [pc for pc in classes if id(pc) not in aff_ids]
            if not device_classes:
                return False
            if overlap is None:
                overlap = len(scheduler.nodepools) > 1 and TorchSolver._pools_overlap(
                    scheduler.nodepools, pods, classes=classes)
            if overlap:
                return False
            if TorchSolver._aff_partition_blocked(scheduler, aff_classes, device_classes):
                return False
        reps = []
        any_spread = False
        any_soft = False
        for pc in device_classes:
            p = pc.pods[0]
            reps.append(p)
            if any(r.min_values is not None for r in pc.requirements):
                return False
            if any(t.hard() for t in p.topology_spread):
                any_spread = True
            elif spread.soft_zone_tsc(p) is not None:
                any_spread = any_soft = True
        if any_soft and any(p.limits is not None for p in scheduler.nodepools):
            # soft spread is pin-then-relax: a pool limit can reject the
            # pinned zone while the relaxed pod fits elsewhere, which one
            # device dispatch cannot express
            return False
        if any_spread:
            # hostname spread and multi-constraint pods take the oracle
            if not spread.spread_eligible(reps):
                return False
            if overlap is None:
                overlap = len(scheduler.nodepools) > 1 and TorchSolver._pools_overlap(
                    scheduler.nodepools, pods, classes=classes)
            if (
                len(scheduler.nodepools) > 1 and not overlap
                and TorchSolver._spread_spans_pools(scheduler, device_classes)
            ):
                # one selector's classes in different disjoint pools: its
                # counts are cross-pool state the pool-sequential solve
                # cannot thread in the oracle's interleaved order
                return False
        return True

    @staticmethod
    def _spread_spans_pools(scheduler: Scheduler, classes) -> bool:
        """True when one topology-spread selector's classes are admitted
        by DIFFERENT pools (disjoint-pool context)."""
        pool_reqs = [p.requirements() for p in scheduler.nodepools]
        owner: Dict[tuple, int] = {}
        for pc in classes:
            rep = pc.pods[0]
            if not rep.topology_spread:
                continue
            pi = next(
                (i for i, reqs in enumerate(pool_reqs)
                 if reqs.compatible(pc.requirements, allow_undefined=_ALLOW_UNDEFINED)),
                -1,
            )
            if pi < 0:
                continue  # admitted nowhere: unschedulable either way
            for t in rep.topology_spread:
                key = (t.topology_key, tuple(sorted(t.label_selector.items())))
                if owner.setdefault(key, pi) != pi:
                    return True
        return False

    @staticmethod
    def _mv_classes(scheduler: Scheduler, classes) -> list:
        """The classes some minValues pool could schedule (the
        oracle-bound prefix), scoped to pools a class is compatible with."""
        mv_pools = [
            p for p in scheduler.nodepools
            if any(r.min_values is not None for r in p.requirements())
        ]
        if not mv_pools:
            return []
        return [
            pc for pc in classes
            if any(p.requirements().compatible(pc.requirements, allow_undefined=_ALLOW_UNDEFINED)
                   for p in mv_pools)
        ]

    @staticmethod
    def _mv_partition_blocked(scheduler: Scheduler, mv_classes, rest) -> bool:
        """True when the minValues partition could CONTEND with the device
        partition: some existing node admits pods from both sides, or the
        two sides share a topology-spread selector."""
        def side_reqs(side):
            return [(pc.pods[0].tolerations, pc.pods[0].scheduling_requirements()) for pc in side]

        mv_reqs, rest_reqs = side_reqs(mv_classes), side_reqs(rest)

        def admits(node, tol, alts) -> bool:
            if not tolerates_all(tol, node.taints):
                return False
            return any(alt.matches_labels(node.labels) for alt in alts)

        for node in scheduler.existing:
            if any(admits(node, tol, alts) for tol, alts in mv_reqs) and any(
                admits(node, tol, alts) for tol, alts in rest_reqs
            ):
                return True
        return bool(_spread_keys(mv_classes) & _spread_keys(rest))

    @staticmethod
    def _suffix_classes(classes) -> list:
        """Classes whose pods the device kernels cannot place: (anti-)
        affinity, several node-affinity terms, preferences (the class-level
        mirror of encode.oracle_suffix_rank)."""
        return [
            pc for pc in classes
            if pc.has_affinity or pc.multi_node_affinity or pc.has_preferences
        ]

    @staticmethod
    def _aff_partition_blocked(scheduler: Scheduler, aff_classes, rest) -> bool:
        """True when the oracle-suffix partition could interact with the
        device partition other than through the sequenced hand-off: a
        suffix selector matches a device pod's labels, the two share a
        spread selector or a rank-stripped envelope key under some pool's
        merge, or any pool carries limits (the oracle charges a group at
        open time, the device decode at its final survivors)."""
        if any(p.limits is not None for p in scheduler.nodepools):
            return True
        selectors: Dict[tuple, dict] = {}
        for pc in aff_classes:
            for p in pc.pods:
                for t in p.affinity_terms:
                    selectors[tuple(sorted(t.label_selector.items()))] = t.label_selector
                for _, t in p.preferred_affinity_terms:
                    selectors[tuple(sorted(t.label_selector.items()))] = t.label_selector
        if selectors:
            # single-pair selectors check as one set lookup per label pair
            single: set = set()
            multi: List[dict] = []
            for key, s in selectors.items():
                if not s:
                    return True  # an empty selector matches every pod
                if len(s) == 1:
                    single.add(key[0])
                else:
                    multi.append(s)
            for pc in rest:
                for p in pc.pods:
                    labels = p.metadata.labels
                    if single and any(kv in single for kv in labels.items()):
                        return True
                    for s in multi:
                        if all(labels.get(k) == v for k, v in s.items()):
                            return True
        if _spread_keys(aff_classes) & _spread_keys(rest):
            return True

        def merged_keys(side, extra) -> set:
            out = set()
            for pc in side:
                reqs = pc.requirements.copy().add(*extra) if extra else pc.requirements
                out.add(encode._class_key(pc.pods[0], reqs)[1:])
            return out

        for pool in scheduler.nodepools:
            extra = list(pool.requirements())
            if merged_keys(aff_classes, extra) & merged_keys(rest, extra):
                return True
        return False

    @staticmethod
    def _pools_overlap(pools: Sequence[NodePool], pods: Sequence[Pod], classes=None) -> bool:
        """True when some pod class is compatible with more than one pool
        (the oracle's _open_group gate, per class instead of per pod)."""
        pool_reqs = [p.requirements() for p in pools]
        if classes is None:
            classes = encode.group_pods(pods)
        for pc in classes:
            n = 0
            for reqs in pool_reqs:
                if reqs.compatible(pc.requirements, allow_undefined=_ALLOW_UNDEFINED):
                    n += 1
                    if n > 1:
                        return True
        return False

    @staticmethod
    def _spread_seeds(scheduler: Scheduler):
        """The oracle's seeded per-selector zone counts, re-keyed for the
        split pass (spread.py keys by selector only)."""
        seeds: Dict[tuple, Dict[str, int]] = {}
        for (tkey, sel_key), counts in scheduler.topology._counts.items():
            if tkey == wk.ZONE_LABEL:
                seeds[sel_key] = dict(counts)
        return seeds

    def _group(self, pods: Sequence[Pod]) -> List:
        """The tick's grouping pass: the cross-tick cache when incremental
        mode is on, a fresh group_pods otherwise (the same classes)."""
        with tracing.span("group"):
            if not self.incremental:
                return encode.group_pods(pods)
            classes = self._grouper.group(pods)
            st = self._grouper.last_stats
            self.last_group_stats = st
            if not st.get("full_rebuild"):
                metrics.DELTA_DIRTY_FRACTION.observe(st["dirty_fraction"])
            tracing.annotate(
                group_classes=st["classes"],
                group_dirty=st["dirty_classes"],
                group_dirty_fraction=round(st["dirty_fraction"], 4),
            )
            return classes

    # -- entry point (Provisioner contract) ---------------------------------
    def schedule(self, scheduler: Scheduler, pods: Sequence[Pod]) -> SchedulingResult:
        # ONE grouping pass serves routing and the first pool's solve
        base_classes = self._group(pods)
        pools = scheduler.nodepools
        self.last_route = {"device_pods": len(pods), "oracle_pods": 0, "path": "device"}
        with tracing.span("route") as route_sp:
            overlap = len(pools) > 1 and self._pools_overlap(pools, pods, classes=base_classes)
            supported = self.supports(scheduler, pods, classes=base_classes, overlap=overlap)
        result = self._schedule_routed(scheduler, pods, base_classes, overlap, supported)
        # the route taken, once known: a merged solve may still end on the oracle
        route_sp.set(path=self.last_route["path"])
        return result

    def _schedule_routed(self, scheduler: Scheduler, pods: Sequence[Pod], base_classes,
                         overlap: bool, supported: bool) -> SchedulingResult:
        """schedule() past its routing checks: the oracle, the merged
        solve, or the device solve per pool with the oracle's prefix and
        suffix; sets last_route."""
        pools = scheduler.nodepools
        if not supported:
            # the oracle packs with THIS solver's objective
            scheduler.objective = self.objective
            self.last_route = {"device_pods": 0, "oracle_pods": len(pods), "path": "oracle"}
            return scheduler.schedule(pods)
        if overlap:
            # classes compatible with SEVERAL pools can join another
            # class's group across the pool boundary: the merged-catalog
            # solve expresses that; the oracle takes its carve-outs
            merged = self._try_solve_merged(scheduler, pods, base_classes)
            if merged is not None:
                self.last_route = {"device_pods": len(pods), "oracle_pods": 0, "path": "merged"}
                return merged
            scheduler.objective = self.objective
            self.last_route = {"device_pods": 0, "oracle_pods": len(pods), "path": "oracle"}
            return scheduler.schedule(pods)
        # oracle suffix: affinity/preference classes sort last in the
        # canonical order, so the device solves the plain prefix and the
        # oracle continues the same pass over the suffix
        with tracing.span("route"):
            aff_pods: List[Pod] = []
            aff_classes = self._suffix_classes(base_classes)
            if aff_classes:
                aff_ids = {id(pc) for pc in aff_classes}
                aff_pods = [p for pc in aff_classes for p in pc.pods]
                base_classes = [pc for pc in base_classes if id(pc) not in aff_ids]
                pods = [p for pc in base_classes for p in pc.pods]
                self.last_route = {
                    "device_pods": len(pods), "oracle_pods": len(aff_pods),
                    "path": "device+suffix",
                }
            # minValues prefix: those classes run on the oracle first and book
            # the shared existing-node capacity the device pass then sees
            mv_classes = self._mv_classes(scheduler, base_classes)
        mv_result = None
        if mv_classes:
            mv_ids = {id(pc) for pc in mv_classes}
            mv_pods = [p for pc in mv_classes for p in pc.pods]
            base_classes = [pc for pc in base_classes if id(pc) not in mv_ids]
            pods = [p for pc in base_classes for p in pc.pods]
            self.last_route = {
                "device_pods": len(pods),
                "oracle_pods": len(mv_pods) + len(aff_pods),
                "path": "prefix+device+suffix" if aff_pods else "prefix+device",
            }
            scheduler.objective = self.objective
            mv_result = scheduler.schedule(mv_pods)
        result = SchedulingResult()
        device_assignments: Dict[str, str] = {}
        if mv_result is not None:
            result.new_groups.extend(mv_result.new_groups)
            result.existing_assignments.update(mv_result.existing_assignments)
            if not pods:
                result.unschedulable.update(mv_result.unschedulable)
                if aff_pods:
                    # no plain middle: the prefix already booked node.used
                    self._oracle_suffix(scheduler, aff_pods, [], result, device_assignments)
                return result
        # pools in weight order, first feasible pool wins: each pool's solve
        # takes the previous pool's leftovers; existing capacity is packed
        # in the first round only
        pods_left: List[Pod] = list(pods)
        for i, pool in enumerate(pools):
            items = scheduler.instance_types.get(pool.name, [])
            existing = scheduler.existing if i == 0 else ()
            if not items and not existing:
                continue
            res_pool = self.solve(
                pool, items, pods_left,
                nodepool_usage=scheduler.usage.get(pool.name),
                existing_nodes=existing,
                zones=sorted(scheduler.zones),
                # seeds every round: a pool-local spread class may only be
                # admitted by a LATER pool in the weight order
                spread_seeds=self._spread_seeds(scheduler),
                classes=base_classes if i == 0 else None,
                daemon_overhead=scheduler.daemon_overhead.get(pool.name),
            )
            result.new_groups.extend(res_pool.new_groups)
            result.existing_assignments.update(res_pool.existing_assignments)
            device_assignments.update(res_pool.existing_assignments)
            by_name = {p.metadata.name: p for p in pods_left}
            result.unschedulable = res_pool.unschedulable
            pods_left = [by_name[n] for n in res_pool.unschedulable if n in by_name]
            if not pods_left:
                break
        if pods_left and not result.unschedulable:
            for p in pods_left:
                result.unschedulable[p.metadata.name] = "no instance types for nodepool"
        if mv_result is not None:
            # merged last: the pool loop REPLACES result.unschedulable
            result.unschedulable.update(mv_result.unschedulable)
        if aff_pods:
            self._oracle_suffix(scheduler, aff_pods, pods, result, device_assignments)
        return result

    # -- pipelined entry point ------------------------------------------------
    def schedule_begin(self, scheduler: Scheduler, pods: Sequence[Pod]) -> _PendingSolve:
        """The dispatch half of schedule(): host stages run and the device
        solve is enqueued; the fetch/decode barrier waits for
        schedule_finish. Only one nodepool with the whole batch on the
        device pipelines; every other route completes inside this call."""
        base_classes = self._group(pods)
        pools = scheduler.nodepools
        items = scheduler.instance_types.get(pools[0].name, []) if pools else []
        with tracing.span("route"):
            overlap = len(pools) > 1 and self._pools_overlap(pools, pods, classes=base_classes)
            pipelinable = (
                len(pools) == 1
                and bool(items)
                and self.supports(scheduler, pods, classes=base_classes, overlap=overlap)
                and not self._suffix_classes(base_classes)
                and not self._mv_classes(scheduler, base_classes)
            )
        if not pipelinable:
            return _PendingSolve(done=self.schedule(scheduler, pods))
        pool = pools[0]
        self.last_route = {"device_pods": len(pods), "oracle_pods": 0, "path": "device"}
        return self.solve_begin(
            pool, items, list(pods),
            nodepool_usage=scheduler.usage.get(pool.name),
            existing_nodes=scheduler.existing,
            zones=sorted(scheduler.zones),
            spread_seeds=self._spread_seeds(scheduler),
            classes=base_classes,
            daemon_overhead=scheduler.daemon_overhead.get(pool.name),
        )

    def schedule_finish(self, pending: _PendingSolve) -> SchedulingResult:
        """The barrier half of schedule_begin."""
        return self.solve_finish(pending)

    def _oracle_suffix(
        self, scheduler: Scheduler, aff_pods: List[Pod],
        device_pods: Sequence[Pod], result: SchedulingResult,
        device_assignments: Dict[str, str],
    ) -> None:
        """Continue the canonical pass on the oracle for the suffix
        partition: book the device pass's existing-node assignments into
        node.used (_pack_existing records them without mutating the
        nodes), then schedule the suffix INTO the shared result, so suffix
        pods join device-opened groups as one full oracle pass would.
        The device pods' labels are not ingested: supports() blocked the
        split unless no suffix selector can match them."""
        if device_assignments:
            by_name = {p.metadata.name: p for p in device_pods}
            nodes = {n.name: n for n in scheduler.existing}
            one_pod = Resources.from_base_units({res.PODS: 1})
            for pod_name, node_name in device_assignments.items():
                p, node = by_name.get(pod_name), nodes.get(node_name)
                if p is not None and node is not None:
                    node.used = node.used + p.requests + one_pod
        scheduler.objective = self.objective
        scheduler.schedule(aff_pods, seed_result=result)

    @staticmethod
    def _unify_envelopes(classes, class_set, pool_of) -> None:
        """The oracle's price envelope is keyed per (pool, merged
        requirement class): classes whose requirements COINCIDE once a
        pool's requirements merge share ONE remaining-count envelope. Per
        row r opening in pool p = pool_of(r): the first member of a key
        encodes env_count = -(1 + pods of LATER members coinciding under
        p) (kernel semantics: leftover + (-env - 1)); later members get a
        static pin equal to the first member's envelope total. `pool_of`
        gives (pool name, extra requirements or None), or None for a row
        that opens nowhere."""
        n = len(classes)
        infos = [pool_of(c) for c in range(n)]
        keys_under: Dict[str, list] = {}

        def keys_for(pool_name: str, extra) -> list:
            out = keys_under.get(pool_name)
            if out is None:
                out = []
                for pc in classes:
                    reqs = pc.requirements
                    if extra is not None:
                        reqs = reqs.copy().add(*extra)
                    out.append(encode._class_key(pc.pods[0], reqs))
                keys_under[pool_name] = out
            return out

        first_member: Dict[tuple, int] = {}
        for c in range(n):
            if class_set.env_count[c] != -1 or infos[c] is None:
                continue
            pool_name, extra = infos[c]
            keys = keys_for(pool_name, extra)
            group_key = (pool_name, keys[c])
            first = first_member.get(group_key)
            if first is None:
                first_member[group_key] = c
                tail_after = sum(
                    len(classes[j].pods) for j in range(c + 1, n) if keys[j] == keys[c])
                if tail_after:
                    class_set.env_count[c] = -(1 + tail_after)
            else:
                class_set.env_count[c] = sum(
                    len(classes[j].pods) for j in range(first, n) if keys[j] == keys[c])

    # -- merged multi-pool solve (solver/multipool.py) -----------------------
    def _merged_catalog(self, scheduler: Scheduler):
        """(merged_items, entry) for the scheduler's pools, or None when no
        pool has a usable type. The merged list is cached per pool
        catalogs, requirements, overheads and taints; its staged entry
        carries the column -> pool map."""
        pools = scheduler.nodepools  # weight-descending (oracle order)
        overheads = [scheduler.daemon_overhead.get(p.name) or Resources() for p in pools]
        cat_lists = tuple(scheduler.instance_types.get(p.name) for p in pools)
        key = (
            tuple(id(cl) for cl in cat_lists),
            tuple(p.requirements().stable_hash() for p in pools),
            tuple(encode.scale_vector(o.to_vector()).tobytes() for o in overheads),
            tuple(tuple((t.key, t.value, t.effect) for t in p.template.taints) for p in pools),
        )
        cached = self._merged_cache.get(key)
        if cached is not None and all(a is b for a, b in zip(cached[0], cat_lists)):
            _, merged_items, originals, col_pools = cached
        else:
            merged_items, originals, col_pools = multipool.build_merged(
                pools, scheduler.instance_types, overheads=overheads)
            if not merged_items:
                return None
            self._merged_cache[key] = (cat_lists, merged_items, originals, col_pools)
            while len(self._merged_cache) > 4:
                self._merged_cache.pop(next(iter(self._merged_cache)))
        entry = self._catalog(merged_items)
        if entry.col_pools is None:
            entry = entry._replace(
                col_pools=col_pools, pools=tuple(pools),
                decode_types=np.array(list(originals), dtype=object)[entry.order],
            )
            with self._lock:
                self._catalog_cache[id(merged_items)] = entry
        return merged_items, entry

    def _try_solve_merged(self, scheduler, pods, base_classes):
        """Overlapping-compat multi-pool batch on the device via the
        merged catalog, or None when a carve-out applies (pool limits,
        minValues pools): the caller then takes the oracle."""
        pools = scheduler.nodepools
        if any(p.limits is not None for p in pools):
            return None
        if any(any(r.min_values is not None for r in p.requirements()) for p in pools):
            return None
        merged = self._merged_catalog(scheduler)
        if merged is None:
            return None
        merged_items, _ = merged
        if any(p.template.taints for p in pools) and self.client is not None:
            # the taint gate rides SolveInputs.join_allowed, which an older
            # sidecar drops silently: taint-carrying merged batches need
            # the server to advertise the feature, else oracle. With the
            # breaker open the wire is not touched (the cached feature set
            # decides; unknown -> oracle)
            if self.wire_healthy():
                try:
                    if "join_allowed" not in self.client.features():
                        return None
                except (ConnectionError, OSError):
                    return None
            else:
                cached = getattr(self.client, "_features", None)
                if cached is None or "join_allowed" not in cached:
                    return None
        # the virtual pool carries NO taints and NO overhead: toleration
        # gates per column via join_allowed, and each column's allocatable
        # already carries its pool's daemonset reserve (build_merged)
        return self.solve(
            _MergedVirtualPool("__merged__"), merged_items, list(pods),
            existing_nodes=scheduler.existing,
            zones=sorted(scheduler.zones),
            spread_seeds=self._spread_seeds(scheduler),
            classes=base_classes,
        )

    # -- the batch solve ----------------------------------------------------
    def solve(
        self,
        pool: NodePool,
        instance_types: Sequence,
        pods: Sequence[Pod],
        nodepool_usage: Optional[Resources] = None,
        existing_nodes: Sequence[ExistingNode] = (),
        zones: Sequence[str] = (),
        spread_seeds: Optional[Dict] = None,
        classes: Optional[List] = None,
        daemon_overhead: Optional[Resources] = None,
    ) -> SchedulingResult:
        """The synchronous solve: dispatch + barrier in one call."""
        return self.solve_finish(self.solve_begin(
            pool, instance_types, pods,
            nodepool_usage=nodepool_usage, existing_nodes=existing_nodes,
            zones=zones, spread_seeds=spread_seeds, classes=classes,
            daemon_overhead=daemon_overhead))

    def solve_begin(
        self,
        pool: NodePool,
        instance_types: Sequence,
        pods: Sequence[Pod],
        nodepool_usage: Optional[Resources] = None,
        existing_nodes: Sequence[ExistingNode] = (),
        zones: Sequence[str] = (),
        spread_seeds: Optional[Dict] = None,
        classes: Optional[List] = None,
        daemon_overhead: Optional[Resources] = None,
    ) -> _PendingSolve:
        # chaos site for the dispatch half of the tick (latency = a slow
        # host stage; error = a dispatch-time crash)
        failpoints.eval("solver.solve_begin")
        call_args = (pool, instance_types, pods)
        call_kwargs = dict(nodepool_usage=nodepool_usage, existing_nodes=existing_nodes,
                           zones=zones, spread_seeds=spread_seeds, classes=classes,
                           daemon_overhead=daemon_overhead)
        with tracing.span("prepare"):
            pool_reqs = pool.requirements()
            # per-fresh-node daemonset reserve, scaled to the solver's exact
            # small-int float32 vector; None/zero = no reserve
            overhead_vec = None
            if daemon_overhead is not None and any(daemon_overhead.to_vector()):
                overhead_vec = encode.scale_vector(daemon_overhead.to_vector()).astype(np.float32)
            if classes is None:
                classes = encode.group_pods(pods, extra_requirements=pool_reqs)
            else:
                # pre-grouped by schedule(): merge the pool's requirements per class
                classes = encode.with_extra_requirements(classes, pool_reqs)
            # spread constraints are part of class identity, so one pod per
            # class decides for the class
            if not spread.spread_eligible([pc.pods[0] for pc in classes]):
                raise ValueError(
                    "TorchSolver.solve: pods carry out-of-scope spread constraints "
                    "(hostname or multiple hard constraints); call schedule() so "
                    "routing can fall back to the oracle")
            if self._suffix_classes(classes):
                raise ValueError(
                    "TorchSolver.solve: pods carry (anti-)affinity or preference "
                    "terms the device kernels do not model; call schedule() so "
                    "routing can carve them to the oracle suffix")
        result = SchedulingResult()

        # phase 0 (host): the zone-spread split runs before the existing-
        # node phase so the pinned zones gate node packing
        if not instance_types and any(spread.hard_zone_tsc(pc.pods[0]) for pc in classes):
            # no catalog -> no feasible spread domains: the oracle rejects
            # every node for these pods
            kept = []
            for pc in classes:
                if spread.hard_zone_tsc(pc.pods[0]):
                    for p in pc.pods:
                        result.unschedulable[p.metadata.name] = (
                            "topology spread constraints unsatisfiable")
                else:
                    kept.append(pc)
            classes = kept
            if not classes:
                return _PendingSolve(done=result)
        if instance_types and any(
            spread.hard_zone_tsc(pc.pods[0]) is not None
            or spread.soft_zone_tsc(pc.pods[0]) is not None
            for pc in classes
        ):
            with tracing.span("spread"):
                classes = self._split_spread(
                    pool, instance_types, classes, zones, spread_seeds, overhead_vec, result)
            if not classes:
                return _PendingSolve(done=result)

        # phase 1 (device): pack onto existing capacity first, exactly as
        # the oracle tries existing nodes before opening groups
        placed_existing = np.zeros((len(classes),), dtype=np.int64)
        if existing_nodes:
            with tracing.span("pack_existing", nodes=len(existing_nodes)):
                placed_existing = self._pack_existing(classes, existing_nodes, result)
        remaining = int(sum(len(pc.pods) for pc in classes) - placed_existing.sum())
        if remaining == 0:
            return _PendingSolve(done=result)
        if not instance_types:
            for c, pc in enumerate(classes):
                for p in pc.pods[int(placed_existing[c]):]:
                    result.unschedulable[p.metadata.name] = "no instance types for nodepool"
            return _PendingSolve(done=result)

        # phase 2 (device): batched FFD over the leftovers
        with tracing.span("encode", classes=len(classes)) as enc_sp:
            entry = self._catalog(instance_types)
            class_set = self._encode(pool, entry, classes, placed_existing, overhead_vec)
            enc_sp.set(c_pad=class_set.c_pad)
        warm_key = self._warm_key(class_set.c_pad, entry)
        if (
            self._warmed_pads
            and warm_key not in self._warmed_pads
            and self._route_monitor.has_changed("unwarmed_c_pad", warm_key)
        ):
            # this tick pays the bucket's first dispatch; say so instead of
            # leaving an unexplained latency spike in the logs
            self.log.info(
                "class-count bucket was not warmed; this tick pays its first dispatch",
                c_pad=class_set.c_pad, classes=len(classes),
            )
        wire = self.client is not None
        if wire and self.breaker is not None and not self.breaker.allow():
            # breaker OPEN (or half-open): skip the wire BEFORE any socket
            # work and solve in process on the same catalog snapshot
            wire = False
            metrics.BREAKER_SHORT_CIRCUITS.inc()
            tracing.annotate(fallback="breaker-open")
            if self._route_monitor.has_changed("breaker_open", entry.seqnum):
                self.log.warning(
                    "solver wire breaker open; solving in process",
                    seqnum=entry.seqnum, breaker=self.breaker.state,
                    device=str(self.device),
                )
            entry = self._local_staged(entry)
        pending = _PendingSolve()
        pending.pool = pool
        pending.entry = entry
        pending.class_set = class_set
        pending.result = result
        pending.placed_existing = placed_existing
        pending.nodepool_usage = nodepool_usage
        pending.call_args, pending.call_kwargs = call_args, call_kwargs
        if wire:
            # the convex tier sends one synchronous solve_convex op at the
            # barrier (the sidecar runs the relaxation next to its FFD
            # solve), so nothing is dispatched here
            if self.tier == "convex":
                return pending
            # async wire dispatch: the frame streams now and the reply is
            # claimed at the barrier; a dispatch-time failure leaves
            # rpc_handle None and the barrier runs the synchronous ladder
            with tracing.span("wire_dispatch") as wd_sp:
                try:
                    pending.rpc_handle = self.client.begin_solve_compact(
                        entry.seqnum, entry.tensors, class_set, g_max=self.g_max,
                        objective=self.objective,
                    )
                    ld = self.client.last_delta
                    wd_sp.set(
                        delta_mode=ld["mode"], delta_rows=ld["rows"],
                        delta_bytes=ld["payload_bytes"], full_bytes=ld["full_bytes"],
                    )
                except (ConnectionError, OSError, RuntimeError) as e:
                    wd_sp.set(dispatch_error=f"{type(e).__name__}: {e}"[:200])
                    pending.rpc_handle = None
            return pending
        try:
            with tracing.span("dispatch_device"):
                # the open/join masks travel bit-packed (the form kernel A
                # reads); the uploads' pinned buffers live on the pending
                # solve
                pending.uploads = []
                inp = ffd.make_inputs_staged(entry.staged, class_set, packed_masks=True,
                                             hold=pending.uploads)
                nnz_max = ffd.nnz_budget(class_set.c_pad, self.g_max)
                # attribution: nbytes is tensor metadata, not a sync
                self._last_solve_bytes = hbm.sum_nbytes(inp)
                self._last_mask_bytes = inp.open_allowed.nbytes + inp.join_allowed.nbytes
                self._last_mask_full_bytes = 2 * class_set.c_pad * entry.tensors.k_pad
                pending.buf = self._dispatch_fused(inp, nnz_max, entry.offsets, entry.words,
                                                   epoch=entry.mesh_epoch)
                # convex tier: the LP relaxation, enqueued right behind the
                # FFD solve so the two are in flight together
                pending.cx = self._dispatch_convex(inp, entry.offsets, entry.words)
        except rpc.StaleSeqnumError as e:
            # only the mesh's dispatch raises this in process: a device
            # lost between staging and dispatch (or killed BY this
            # dispatch -- the engine classifies the error, quarantines the
            # device and bumps the epoch). One rung: re-enter solve_begin,
            # whose _catalog restages the same encoding onto the surviving
            # mesh. Each retry requires the epoch to have ADVANCED past the
            # stamp it dispatched with, so no other error can loop; repeated
            # losses walk the ladder down to the unsharded rung, where the
            # engine stops classifying.
            if (
                self.mesh_engine is None
                or entry.mesh_epoch is None
                or self.mesh_engine.epoch == entry.mesh_epoch
            ):
                raise  # no topology progress: a retry would loop
            return self._stale_topology(self.solve_begin, call_args, call_kwargs, e)
        pending.inp = inp
        pending.nnz_max = nnz_max
        return pending

    def _stale_topology(self, again, args, kwargs, error: Optional[BaseException] = None):
        """The mesh's stale-topology rung: count it, log once per epoch,
        and run `again` (solve_begin or solve) on the same arguments,
        whose _catalog restages onto the current device set --
        byte-identical, the ladder only moves computation."""
        metrics.SOLVER_PIPELINE_FALLBACKS.inc(reason="stale-topology")
        tracing.annotate(fallback="stale-topology")
        if self._route_monitor.has_changed("mesh_topology", self.mesh_engine.epoch):
            self.log.warning(
                "mesh topology changed; restaging onto the current device set",
                error="" if error is None else f"{type(error).__name__}: {error}"[:200],
                epoch=self.mesh_engine.epoch,
            )
        return again(*args, **kwargs)

    def _dispatch_fused(self, inp: ffd.SolveInputs, nnz_max: int, offsets, words,
                        epoch: Optional[int] = None) -> torch.Tensor:
        """The fused FFD solve (prologue, kernel A, epilogue), counted by
        the implementation that runs: the mesh engine's sharded entry
        when configured (`epoch` its staging stamp; never an armed
        graph, as the JAX package keeps serialized executables off the
        mesh), else an armed graph of the warm-up ladder (solver/aot.py)
        when one matches these statics and input shapes exactly, else
        the ordinary dispatch."""
        common = dict(g_max=self.g_max, nnz_max=nnz_max, word_offsets=offsets,
                      words=words, objective=self.objective)
        if self.mesh_engine is not None:
            with self._dispatch_lock:
                buf = self.mesh_engine.solve_fused(inp, epoch=epoch, **common)
            _count_dispatch("ffd_solve_fused", _impl(inp.req))
            return buf
        with self._dispatch_lock:
            if self._aot is not None:
                hit, buf = self._aot.try_call("ffd_solve_fused", (inp,), common)
                if hit:
                    _count_dispatch("ffd_solve_fused", "aot")
                    return buf
            buf = ffd.ffd_solve_fused(inp, **common)
        _count_dispatch("ffd_solve_fused", _impl(inp.req))
        return buf

    # -- the convex tier and the quality bound --------------------------------
    def _dispatch_convex(self, inp: ffd.SolveInputs, offsets, words) -> Optional[relax.RelaxOutputs]:
        """The LP relaxation for the convex tier, enqueued right behind the
        fused FFD solve; None on the FFD tier and on any dispatch failure
        -- the tick then IS the FFD tick, bit for bit (the dispatch rung)."""
        if self.tier != "convex":
            return None
        try:
            # chaos site: a dispatch fault must cost the tick ONLY the
            # convex candidate
            failpoints.eval("rpc.convex.dispatch")
            statics = dict(iters=relax.DEFAULT_ITERS, word_offsets=offsets, words=words)
            with tracing.span("dispatch_convex"), self._dispatch_lock:
                if self._aot is not None:
                    hit, out = self._aot.try_call("convex_relax", (inp,), statics)
                    if hit:
                        return out
                return relax.convex_relax(inp, **statics)
        except Exception as e:  # noqa: BLE001 -- counted; the FFD rung owns
            # the tick (OperatorCrashed is a BaseException and flies)
            metrics.CONVEX_FALLBACKS.inc(reason="dispatch")
            if self._route_monitor.has_changed("convex_dispatch", type(e).__name__):
                self.log.warning(
                    "convex relaxation dispatch failed; tick stays on FFD",
                    error=f"{type(e).__name__}: {e}"[:200],
                )
            return None

    def _finish_convex(self, pending: _PendingSolve, dense_ffd) -> Tuple[tuple, Optional[float]]:
        """Fetch the relaxation, round it, and judge the never-worse
        differential against the FFD decision. Returns (chosen dense
        tuple, the relaxation's certified lower bound or None). A failed
        fetch keeps the FFD tuple; a rounding exception or None leaves
        `choose` the FFD tuple; the lower bound still tightens the gap
        whenever the fetch succeeded."""
        entry, class_set = pending.entry, pending.class_set
        try:
            with tracing.span("convex_fetch"):
                x, lower, trace = relax.fetch_relax(pending.cx)
        except Exception as e:  # noqa: BLE001 -- counted; the FFD rung
            metrics.CONVEX_FALLBACKS.inc(reason="dispatch")
            if self._route_monitor.has_changed("convex_fetch", type(e).__name__):
                self.log.warning(
                    "convex relaxation fetch failed; tick stays on FFD",
                    error=f"{type(e).__name__}: {e}"[:200],
                )
            return dense_ffd, None
        try:
            with tracing.span("convex_round"):
                dense_cx = rounding.round_solution(x, entry.tensors, class_set, g_max=self.g_max)
        except Exception as e:  # noqa: BLE001 -- counted below; the FFD rung
            # (the convex.rounding chaos site raises through here)
            dense_cx = None
            if self._route_monitor.has_changed("convex_round", type(e).__name__):
                self.log.warning(
                    "convex rounding failed; tick stays on FFD",
                    error=f"{type(e).__name__}: {e}"[:200],
                )
        if dense_cx is None:
            metrics.CONVEX_FALLBACKS.inc(reason="rounding")
        winner, dense, p_ffd, p_cx = convex_tier.choose(dense_ffd, dense_cx, entry.tensors.price)
        iters = relax.iterations_to_convergence(trace)
        metrics.CONVEX_SOLVES.inc(winner=winner)
        metrics.CONVEX_ITERATIONS.set(iters)
        tracing.annotate(convex_winner=winner)
        self.last_convex = {
            "winner": winner, "price_ffd": p_ffd, "price_convex": p_cx,
            "lower": lower, "iterations": iters,
        }
        return dense, lower

    def _dispatch_bound(self, inp: ffd.SolveInputs, placed: np.ndarray, offsets, words,
                        hold: Optional[list] = None, epoch: Optional[int] = None) -> torch.Tensor:
        """The fractional price bound on the device: the mesh engine's
        sharded entry when configured, else an armed graph when one
        matches, else the ordinary dispatch; the [R] totals stay there
        until fetch_bound. The `placed` upload is pinned and non_blocking,
        its buffer kept in `hold` (see ffd._to_device). Uncounted, as in
        the JAX package; the current span records it all the same."""
        placed_t = ffd._to_device(placed, inp.req.device, hold)
        statics = dict(word_offsets=offsets, words=words)
        if self.mesh_engine is not None:
            with self._dispatch_lock:
                totals = self.mesh_engine.price_bound(inp, placed_t, epoch=epoch, **statics)
            _note_dispatch("fractional_price_bound", _impl(inp.req))
            return totals
        with self._dispatch_lock:
            if self._aot is not None:
                hit, totals = self._aot.try_call("fractional_price_bound", (inp, placed_t), statics)
                if hit:
                    _note_dispatch("fractional_price_bound", "aot")
                    return totals
            totals = bound.fractional_price_bound(inp, placed_t, **statics)
        _note_dispatch("fractional_price_bound", _impl(inp.req))
        return totals

    def _begin_quality(self, pending: _PendingSolve, dense) -> Optional[torch.Tensor]:
        """Enqueue the bound for the decision just chosen, before decode,
        so the device computes it while the host decodes. `placed` is the
        take-row sum: the pods the solve placed on new groups (billing
        requested counts would break gap >= 1 when pods go unplaced).
        Observe-only: a failure is counted and the tick goes on. Wire
        ticks stage nothing locally, so they carry no bound (as in
        TPUSolver)."""
        if pending.inp is None:
            return None
        try:
            placed = np.asarray(dense[0]).sum(axis=1).astype(np.float32)
            return self._dispatch_bound(
                pending.inp, placed, pending.entry.offsets, pending.entry.words,
                hold=pending.uploads, epoch=pending.entry.mesh_epoch)
        except Exception as e:  # noqa: BLE001 -- quality must never fail a tick
            metrics.HANDLED_ERRORS.inc(site="solver.quality_dispatch")
            if self._route_monitor.has_changed("quality_dispatch", type(e).__name__):
                self.log.warning(
                    "quality bound dispatch failed; tick goes on without it",
                    error=f"{type(e).__name__}: {e}"[:200],
                )
            return None

    def _finish_quality(self, result: SchedulingResult, totals: Optional[torch.Tensor],
                        lb_convex: Optional[float] = None) -> None:
        """Fetch the bound after decode and publish last_quality. The
        convex tier's certified lower bound often tightens the fractional
        bound but is not pointwise dominant, so the gap's denominator is
        the max of the two, and the tighten ratio is published either
        way. Observe-only: never raises into the tick."""
        try:
            bound_h, r_star = bound.fetch_bound(totals) if totals is not None else (None, None)
            if lb_convex is not None and lb_convex > 0.0:
                if bound_h is not None and bound_h > 0.0:
                    metrics.CONVEX_TIGHTEN.set(lb_convex / bound_h)
                    bound_h = max(bound_h, lb_convex)
                else:
                    bound_h = lb_convex
            self.last_quality = quality.solve_quality(result, bound_h, r_star)
        except Exception as e:  # noqa: BLE001 -- quality must never fail a tick
            metrics.HANDLED_ERRORS.inc(site="solver.quality_finish")
            if self._route_monitor.has_changed("quality_finish", type(e).__name__):
                self.log.warning(
                    "quality bound fetch failed; tick goes on without it",
                    error=f"{type(e).__name__}: {e}"[:200],
                )

    def _split_spread(self, pool, instance_types, classes, zones, spread_seeds,
                      overhead_vec, result: SchedulingResult) -> list:
        """Phase 0: split every zone-spread class into zone-pinned,
        group-sized sub-classes with the oracle's exact per-zone
        distribution (solver/spread.py); counts seed from live pods.
        Unsatisfiable pods land in `result`."""
        entry0 = self._catalog(instance_types)
        catalog0 = entry0.tensors
        pre_set = encode.encode_classes(
            classes, catalog0, pool_taints=list(pool.template.taints),
            c_pad=_bucket(len(classes), _C_PAD_MIN), row_cache=entry0.row_cache,
        )
        compat = encode.compat_matrix(catalog0, pre_set)[: len(classes)]
        if entry0.col_pools is not None:
            # merged multi-pool: the oracle derives a spread pod's zone
            # DOMAINS from its FIRST requirements-compatible pool's catalog
            # only (oracle._zone_choice); restrict each spread class's
            # columns to that pool so the domains agree
            k_real0 = entry0.col_pools.shape[0]
            for c, pc in enumerate(classes):
                if (spread.hard_zone_tsc(pc.pods[0]) is None
                        and spread.soft_zone_tsc(pc.pods[0]) is None):
                    continue
                pi = multipool.first_compat_pool(pc, entry0.pools)
                colmask = np.zeros((compat.shape[1],), dtype=bool)
                if pi >= 0:
                    colmask[:k_real0] = entry0.col_pools == pi
                compat[c] &= colmask
        cap0 = catalog0.cap
        if overhead_vec is not None:
            cap0 = np.maximum(cap0 - overhead_vec[None, :], np.float32(0.0))
        fits_one = np.all(cap0[None, :, :] >= pre_set.req[: len(classes), None, :], axis=-1)
        split = spread.split_zone_spread(
            classes, catalog0, list(zones) or list(catalog0.zones), compat, fits_one,
            seed_counts=spread_seeds, node_overhead=overhead_vec,
        )
        result.unschedulable.update(split.unschedulable)
        return split.classes

    def _encode(self, pool: NodePool, entry: _CatalogEntry, classes, placed_existing: np.ndarray,
                overhead_vec: Optional[np.ndarray] = None):
        """The classes' dense tensors for kernel A: encoded against the
        staged catalog, the merged catalog's open/join masks, price
        envelopes unified, and counts net of the pods the pre-pass placed
        on existing nodes."""
        catalog = entry.tensors
        class_set = encode.encode_classes(
            classes, catalog, pool_taints=list(pool.template.taints),
            c_pad=_bucket(len(classes), _C_PAD_MIN), node_overhead=overhead_vec,
            row_cache=entry.row_cache,
        )
        if entry.col_pools is not None:
            # merged multi-pool: opening is restricted to each class's
            # first feasible pool in weight order (the oracle's
            # _open_group pool iteration); joins stay free across all
            # admitted columns
            with tracing.span("merge_masks", pools=len(entry.pools),
                              columns=int(entry.col_pools.shape[0]), classes=len(classes)):
                compat_h = encode.compat_matrix(catalog, class_set)[: len(classes)]
                cap_h = catalog.cap
                if overhead_vec is not None:
                    cap_h = np.maximum(cap_h - overhead_vec[None, :], np.float32(0.0))
                fits_one_h = np.all(cap_h[None, :, :] >= class_set.req[: len(classes), None, :],
                                    axis=-1)
                admitted_all = [multipool.admitted_pools(pc, entry.pools) for pc in classes]
                class_set.open_allowed, open_pool_idx = multipool.open_allowed_mask(
                    classes, admitted_all, entry.col_pools, compat_h, fits_one_h,
                    class_set.c_pad, catalog.k_pad,
                )
                # per-pool TAINTS gate joins per column (merged groups are
                # single-pool by construction); untainted pools need no mask
                if any(p.template.taints for p in entry.pools):
                    class_set.join_allowed = multipool.join_allowed_mask(
                        classes, entry.pools, entry.col_pools, class_set.c_pad, catalog.k_pad)

            def pool_of(c):
                # envelopes unify under each class's OPENING pool -- the
                # same choice the open mask encodes
                if open_pool_idx[c] < 0:
                    return None
                opening = entry.pools[open_pool_idx[c]]
                return opening.name, opening.requirements()
        else:
            def pool_of(c):
                # single pool: class requirements already carry the pool's
                return pool.name, None
        if self.objective == "price":
            with tracing.span("envelopes"):
                self._unify_envelopes(classes, class_set, pool_of)
        counts = class_set.count.copy()
        counts[: len(classes)] -= placed_existing.astype(counts.dtype)
        class_set.count = counts
        return class_set

    def solve_finish(self, pending: _PendingSolve) -> SchedulingResult:
        """The barrier: ONE fetch of the fused buffer, expand, decode; a
        sparse-budget overflow refetches the dense decision. Around the
        decode, in TPUSolver's order: the convex differential, the bound's
        dispatch, decode, then the bound's fetch and last_quality."""
        if pending.done is not None:
            return pending.done
        # chaos site for the barrier half (latency = a slow claim)
        failpoints.eval("solver.solve_finish")
        entry, class_set = pending.entry, pending.class_set
        cx_lower = None
        if self.client is not None and pending.buf is None:
            # the wire: a pipelined reply to claim or the synchronous
            # ladder (a breaker-open dispatch set pending.buf in process)
            with tracing.span("wire"):
                # the echoed server stages graft under this span
                if self.tier == "convex":
                    dense, cx_lower = self._finish_remote_convex(pending)
                else:
                    dense = self._finish_remote(pending)
        else:
            if (
                self.mesh_engine is not None
                and entry.mesh_epoch is not None
                and entry.mesh_epoch != self.mesh_engine.epoch
            ):
                # topology changed between dispatch and this barrier: the
                # fused buffer was computed on a mesh that lost (or
                # regained) a device. Same fallback rung as a mid-flight
                # catalog change
                return self._stale_topology(self.solve, pending.call_args,
                                            pending.call_kwargs)
            with tracing.span("device") as dev_sp:
                # THE host barrier of the tick (sync_witness SANCTIONED_FETCH)
                host_buf = ffd.fetch_fused(pending.buf)
                # the sparse take's true (class, group) pairs against its budget
                take = dict(take_pairs=int(host_buf[0]), take_budget=pending.nnz_max)
                dev_sp.set(**take)
            dense = ffd.expand_fused(
                host_buf, class_set.c_pad, self.g_max,
                entry.tensors.k_pad, encode.Z_PAD, encode.CT, pending.nnz_max,
            )
            if dense is None:
                # sparse budget overflow: refetch the dense decision
                with tracing.span("device", refetch="dense", **take):
                    if self.mesh_engine is not None:
                        try:
                            out = self.mesh_engine.solve_dense(
                                pending.inp, g_max=self.g_max, word_offsets=entry.offsets,
                                words=entry.words, objective=self.objective,
                                epoch=entry.mesh_epoch,
                            )
                            f = self.mesh_engine.fetch(out, epoch=entry.mesh_epoch)
                        except rpc.StaleSeqnumError as e:
                            # topology changed under the refetch
                            return self._stale_topology(self.solve, pending.call_args,
                                                        pending.call_kwargs, e)
                        dense = (f.take, f.unplaced, int(f.n_open), f.gmask, f.gzone, f.gcap)
                    else:
                        dense = ffd.solve_dense_tuple(
                            pending.inp, g_max=self.g_max, word_offsets=entry.offsets,
                            words=entry.words, objective=self.objective,
                        )
        # convex tier: round and judge before decode, so the decoded
        # groups are the chosen placement (and the bound bills its takes)
        if pending.cx is not None:
            dense, cx_lower = self._finish_convex(pending, dense)
        with tracing.span("bound"):
            qtotals = self._begin_quality(pending, dense)
        with tracing.span("decode"):
            out = self._decode(
                pending.pool, entry, class_set, dense, pending.nodepool_usage,
                result=pending.result, class_offset=pending.placed_existing,
            )
        with tracing.span("quality"):
            self._finish_quality(out, qtotals, lb_convex=cx_lower)
        # every fetch above has waited for the stream: the uploads are done
        pending.uploads = None
        return out

    # -- the wire barrier ------------------------------------------------------
    def _wire_down(self, e: BaseException, what: str) -> None:
        """Account one failed wire ladder: toward opening the breaker and
        in the JAX package's fallback counter, logged once per change of
        exception type."""
        if self.breaker is not None:
            self.breaker.record_failure()
        metrics.SOLVER_PIPELINE_FALLBACKS.inc(reason="rpc-down")
        tracing.annotate(fallback="rpc-down")
        if self._route_monitor.has_changed("wire_down", type(e).__name__):
            self.log.warning(
                f"{what}; solving in process",
                error=f"{type(e).__name__}: {e}"[:200], device=str(self.device),
                breaker=self.breaker.state if self.breaker is not None else "none",
            )

    def _finish_remote(self, pending: _PendingSolve):
        """Claim (or re-run) the wire solve with circuit-breaker
        accounting. When the WHOLE ladder fails the solve re-runs in
        process on the same snapshot (identical decision) and the failure
        counts toward opening the breaker -- per finish, not per rung."""
        try:
            dense = self._finish_remote_wire(pending)
        except (ConnectionError, OSError, RuntimeError) as e:
            self._wire_down(e, "solver wire ladder failed")
            with tracing.span("device", fallback="rpc-down"):
                dense = self._solve_local_dense(pending)
        else:
            if self.breaker is not None:
                self.breaker.record_success()
        return dense

    def _finish_remote_convex(self, pending: _PendingSolve):
        """The convex tier's wire barrier: one synchronous solve_convex op
        (FFD scan, relaxation, rounding and the never-worse differential
        on the sidecar), returning (chosen dense tuple, the relaxation's
        lower bound or None). A sidecar without the feature takes the
        plain wire ladder; a dead wire the in-process dense solve -- an
        FFD tick either way."""
        entry, class_set = pending.entry, pending.class_set
        try:
            if "convex" not in self.client.features():
                metrics.CONVEX_FALLBACKS.inc(reason="wire")
                if self._route_monitor.has_changed("convex_feature", entry.seqnum):
                    self.log.info("sidecar lacks the convex feature; ticks stay on FFD")
                return self._finish_remote(pending), None
            with tracing.span("wire_convex"):
                dense, info = self.client.solve_convex(
                    entry.seqnum, entry.tensors, class_set,
                    g_max=self.g_max, objective=self.objective,
                )
        except (ConnectionError, OSError, RuntimeError) as e:
            metrics.CONVEX_FALLBACKS.inc(reason="wire")
            self._wire_down(e, "solve_convex wire op failed")
            with tracing.span("device", fallback="rpc-down"):
                return self._solve_local_dense(pending), None
        if self.breaker is not None:
            self.breaker.record_success()
        metrics.CONVEX_SOLVES.inc(winner=info["winner"])
        metrics.CONVEX_ITERATIONS.set(int(info["iterations"]))
        if info.get("fallback"):
            metrics.CONVEX_FALLBACKS.inc(reason="rounding")
        tracing.annotate(convex_winner=info["winner"])
        self.last_convex = dict(info)
        lower = float(info.get("lower") or 0.0)
        return dense, (lower if lower > 0.0 else None)

    def _solve_local_dense(self, pending: _PendingSolve):
        """The wire-dead rung's compute: the dense solve on locally staged
        tensors of the SAME snapshot the wire dispatch encoded against."""
        entry = self._local_staged(pending.entry)
        pending.entry = entry
        inp = ffd.make_inputs_staged(entry.staged, pending.class_set, packed_masks=True)
        return ffd.solve_dense_tuple(
            inp, g_max=self.g_max, word_offsets=entry.offsets,
            words=entry.words, objective=self.objective,
        )

    def _finish_remote_wire(self, pending: _PendingSolve):
        """The wire degrade ladder, in order: the pipelined reply; the
        synchronous compact op (reconnects, restages on unknown-seqnum);
        the dense op (old sidecars without solve_compact, and
        sparse-budget overflow)."""
        entry, class_set = pending.entry, pending.class_set
        catalog, seqnum = entry.tensors, entry.seqnum
        dec = None
        if pending.rpc_handle is not None:
            try:
                dec = self.client.finish_solve_compact(pending.rpc_handle)
            except rpc.StaleEpochError:
                # the sidecar lost the class epoch the delta patched; the
                # client dropped its base, so the op below ships full
                metrics.SOLVER_PIPELINE_FALLBACKS.inc(reason="stale-epoch")
                tracing.annotate(fallback="stale-epoch")
            except rpc.StaleSeqnumError:
                # restarted / evicted mid-flight: the synchronous op
                # restages and retries
                metrics.SOLVER_PIPELINE_FALLBACKS.inc(reason="stale-seqnum")
                tracing.annotate(fallback="stale-seqnum")
            except (ConnectionError, OSError):
                metrics.SOLVER_PIPELINE_FALLBACKS.inc(reason="rpc-degraded")
                tracing.annotate(fallback="rpc-degraded")
            except RuntimeError as e:
                if "unknown op" not in str(e):
                    raise
                metrics.SOLVER_PIPELINE_FALLBACKS.inc(reason="rpc-degraded")
                tracing.annotate(fallback="rpc-degraded")
        dense = None
        overflow = False
        if dec is not None:
            dense = ffd.expand_compact(
                dec, class_set.c_pad, self.g_max, catalog.k_pad, encode.Z_PAD, encode.CT)
            overflow = dense is None
        if dense is None and not overflow:
            try:
                dec = self.client.solve_classes_compact(
                    seqnum, catalog, class_set, g_max=self.g_max, objective=self.objective,
                )
                dense = ffd.expand_compact(
                    dec, class_set.c_pad, self.g_max, catalog.k_pad, encode.Z_PAD, encode.CT)
            except RuntimeError as e:
                if "unknown op" not in str(e):
                    raise
                dense = None
        if dense is None:
            # sparse budget overflow / no compact op: dense refetch
            tracing.annotate(wire_path="dense")
            out = self.client.solve_classes(
                seqnum, catalog, class_set, g_max=self.g_max, objective=self.objective)
            dense = (
                np.asarray(out.take), np.asarray(out.unplaced), int(out.n_open),
                np.asarray(out.gmask), np.asarray(out.gzone), np.asarray(out.gcap),
            )
        return dense

    def _repack_operands(self, classes, existing_nodes) -> Tuple[np.ndarray, ...]:
        """Kernel B's operands, on the host, for packing `classes` onto
        `existing_nodes`: one candidate set, nothing excluded, C and N
        padded to buckets; a spread sub-class's pinned zone gates the
        nodes it may use. (headroom, feas, req, member, excl), the
        arguments of disrupt_kernel.repack_from_numpy."""
        C = _bucket(len(classes), _C_PAD_MIN)
        N = _bucket(len(existing_nodes), 16)
        with tracing.span("pack_feasibility", classes=len(classes), nodes=len(existing_nodes)):
            req = np.zeros((C, encode.R), dtype=np.float32)
            member = np.zeros((1, C), dtype=np.int32)
            for i, pc in enumerate(classes):
                req[i] = pc.requests
                member[0, i] = len(pc.pods)
            feas = np.zeros((C, N), dtype=bool)
            feas[: len(classes), : len(existing_nodes)] = disrupt_engine._node_feasibility(
                classes, existing_nodes, class_zone_pins=True)
        with tracing.span("pack_headroom"):
            headroom = np.zeros((N, encode.R), dtype=np.float32)
            for ni, node in enumerate(existing_nodes):
                headroom[ni] = encode.scale_vector(node.remaining().to_vector())
        return headroom, feas, req, member, np.zeros((1, N), dtype=bool)

    def _dispatch_disrupt_repack(self, headroom, feas, req, member, excl):
        """Kernel B through the armed-graph rung (the pre-pass's S=1 floor
        shape is armed by the warm-up ladder), else the ordinary
        dispatch; counted by the implementation that runs."""
        args = (headroom, feas, req, member, excl)
        with self._dispatch_lock:
            if self._aot is not None:
                hit, out = self._aot.try_call("disrupt_repack", args, {})
                if hit:
                    _count_dispatch("disrupt_repack", "aot")
                    return out
            out = disrupt_kernel.disrupt_repack(*args)
        _count_dispatch("disrupt_repack", _impl(headroom))
        return out

    def _pack_existing(self, classes, existing_nodes, result: SchedulingResult) -> np.ndarray:
        """First-fit pods onto live/in-flight nodes with kernel B; fills
        result.existing_assignments and returns per-class placed counts."""
        arrays = self._repack_operands(classes, existing_nodes)
        with tracing.span("pack_device"):
            ops = disrupt_kernel.repack_from_numpy(*arrays, self.device)
            _, takes = self._dispatch_disrupt_repack(*ops)
            takes = takes[0].cpu().numpy()                     # [C, N]
        with tracing.span("pack_assign") as assign_sp:
            placed = np.zeros((len(classes),), dtype=np.int64)
            for c, pc in enumerate(classes):
                cursor = 0
                for ni, node in enumerate(existing_nodes):
                    n = int(takes[c, ni])
                    for p in pc.pods[cursor: cursor + n]:
                        result.existing_assignments[p.metadata.name] = node.name
                    cursor += n
                placed[c] = cursor
            assign_sp.set(placed=int(placed.sum()))
        return placed

    def _decode(
        self,
        pool: NodePool,
        entry: _CatalogEntry,
        class_set,
        dense: Tuple,
        nodepool_usage: Optional[Resources],
        result: SchedulingResult,
        class_offset: np.ndarray,
    ) -> SchedulingResult:
        """Placements -> NewNodeGroups (TPUSolver._decode)."""
        catalog = entry.tensors
        take, unplaced, n_open, gmask, gzone, gcap = dense
        take = np.asarray(take)                        # [C, G]
        unplaced = np.asarray(unplaced)                # [C]
        n_open = int(n_open)
        gmask = np.asarray(gmask)                      # [G, K]
        # cumulative placements per class: offset math in O(1) per (c, g)
        take_cum = np.concatenate(
            [np.zeros((take.shape[0], 1), dtype=take.dtype), np.cumsum(take, axis=1)], axis=1)
        types_by_price, order = entry.types_by_price, entry.order
        captype_names = [wk.CAPACITY_TYPE_RESERVED, wk.CAPACITY_TYPE_SPOT, wk.CAPACITY_TYPE_ON_DEMAND]

        usage = nodepool_usage if nodepool_usage is not None else Resources()
        limited = pool.limits is not None
        take_t = np.ascontiguousarray(take[:, :n_open].T) if n_open else take.T
        gmask_real = gmask[:, : catalog.k_real]
        zone_names = catalog.zones
        n_zones = len(zone_names)
        # per-group requested totals in ONE matmul over the EXACT float64
        # base-unit class vectors, so NewNodeGroup.requested stays bit-equal
        # to Resources arithmetic
        if n_open:
            class_base = class_set.base_req[: take_t.shape[1]].astype(np.float64)
            group_req_vecs = take_t.astype(np.float64) @ class_base
        else:
            group_req_vecs = np.zeros((0, encode.R))
        # merged multi-pool entries attribute each group to the pool of its
        # surviving columns (single-pool by construction), with that pool's
        # base requirements and taints, and emit the ORIGINAL types
        merged = entry.col_pools is not None
        pool_base_reqs = pool.requirements()
        pool_base_memo: Dict[int, Requirements] = {}
        if merged:
            types_by_price = entry.decode_types
        # consecutive groups hosting the same class mix carry identical
        # survivor masks and merged requirements: both memoized on bytes
        survivors_memo: Dict[bytes, List] = {}
        reqs_memo: Dict[Tuple, Requirements] = {}
        taints = list(pool.template.taints)

        # ALL (group, class) placement pairs in one nonzero + two
        # searchsorted calls (gg is sorted)
        gg, cc = np.nonzero(take_t > 0)
        g_starts = np.searchsorted(gg, np.arange(n_open))
        g_ends = np.searchsorted(gg, np.arange(1, n_open + 1))
        pair_take = take_t[gg, cc]
        pair_off = class_offset[cc] + take_cum[cc, gg]

        with gc_paused():
            for g in range(n_open):
                lo, hi = g_starts[g], g_ends[g]
                classes_on_g = cc[lo:hi]
                if classes_on_g.size == 0:
                    continue
                group_pods: List[Pod] = []
                for j in range(lo, hi):
                    pc = class_set.classes[cc[j]]
                    # pods before the offset went to existing nodes or to
                    # earlier groups of this class
                    off = int(pair_off[j])
                    group_pods.extend(pc.pods[off: off + int(pair_take[j])])
                requested = Resources.from_vector(group_req_vecs[g].tolist())
                mask_key = gmask_real[g].tobytes()
                group_types = survivors_memo.get(mask_key)
                if group_types is None:
                    group_types = survivors_memo[mask_key] = (
                        types_by_price[gmask_real[g][order]].tolist())
                if not group_types:
                    for p in group_pods:
                        result.unschedulable[p.metadata.name] = "no surviving instance type"
                    continue
                g_pool = pool
                base = pool_base_reqs
                req_key = (classes_on_g.tobytes(), gzone[g].tobytes(), gcap[g].tobytes())
                if merged:
                    pi = int(entry.col_pools[np.nonzero(gmask_real[g])[0][0]])
                    g_pool = entry.pools[pi]
                    base = pool_base_memo.get(pi)
                    if base is None:
                        base = pool_base_memo[pi] = g_pool.requirements()
                    req_key = req_key + (pi,)
                reqs = reqs_memo.get(req_key)
                if reqs is None:
                    reqs = base.copy()
                    for c in classes_on_g:
                        reqs.add(*class_set.classes[c].requirements)
                    zones = [zone_names[z] for z in np.nonzero(gzone[g][:n_zones])[0]]
                    captypes = [captype_names[i] for i in np.nonzero(gcap[g])[0]]
                    # a full mask is no constraint
                    if zones and len(zones) < n_zones:
                        reqs.add(Requirement(wk.ZONE_LABEL, Operator.IN, zones))
                    if captypes and len(captypes) < len(captype_names):
                        reqs.add(Requirement(wk.CAPACITY_TYPE_LABEL, Operator.IN, captypes))
                    reqs_memo[req_key] = reqs
                # nodepool limits (host-side guard, mirroring the oracle)
                if limited:
                    smallest = min(group_types, key=lambda it: it.capacity.get(res.CPU))
                    if not (usage + smallest.capacity).within(pool.limits):
                        for p in group_pods:
                            result.unschedulable[p.metadata.name] = f"nodepool {pool.name} limits exceeded"
                        continue
                    usage = usage + smallest.capacity
                result.new_groups.append(NewNodeGroup(
                    nodepool=g_pool, requirements=reqs, instance_types=group_types,
                    taints=list(g_pool.template.taints) if merged else taints,
                    pods=group_pods, requested=requested,
                ))
            # unplaced pass: only the classes with leftovers
            take_sums = take[: class_set.c_real].sum(axis=1)
            for c in np.nonzero(unplaced[: class_set.c_real] > 0)[0]:
                n_un = int(unplaced[c])
                pc = class_set.classes[c]
                placed = int(class_offset[c]) + int(take_sums[c])
                for p in pc.pods[placed: placed + n_un]:
                    result.unschedulable[p.metadata.name] = "no instance type fits pod requirements"
        return result
