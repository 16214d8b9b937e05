"""Cold starts on the card: the warm-up ladder and CUDA-graph armed dispatch.

Counterpart of karpenter_tpu/solver/aot.py. The JAX module attacks the
cold tick -- operator restart, a fresh sidecar -- where a trace+compile
storm lands exactly when latency matters. The port compiles nothing per
shape, but its cold tick pays the same kind of bill: nvcc (or a library
load), `cudaFuncSetAttribute`, lazy CUDA module loads, allocator growth,
and every dispatch's host enqueue of a few hundred to a few thousand
small launches. Three layers, each bit-identical to the dispatch it
shadows (AOT changes who prepares a dispatch and when, never what it
computes):

1. **The versioned library store** (solver/kernels/build.py):
   `prepare_cache` roots it at `$KARPENTER_TPU_COMPILE_CACHE`, versioned
   by a torch/CUDA/nvcc/card/flags fingerprint, and sweeps stale
   siblings; `AotManager.load_store` loads every library there at start
   without nvcc (`karpenter_aot_loaded_total`), a rejected one is a
   counted rung (`{reason="deserialize"}`), unlinked and rebuilt.

2. **The warm-up ladder** (`AotManager` + `build_plan`): the dispatch
   space is finite -- the device entries x the class-count buckets of
   `TorchSolver.WARM_C_PADS`, catalog geometry pinning every other shape
   -- so a background ladder prepares all of it, ordered by criticality
   (tier 0: the fused solve and its bound per bucket; tier 2: the convex
   relaxation per bucket when the tier can dispatch it; tier 3: the
   repack at S=C=N=16 and the existing-node pre-pass's S=1 floor shape,
   and the replacement search), duty-cycled (`KARPENTER_TPU_AOT_DUTY`,
   sleeps capped at 30 s) so warm-up never steals the tick. Tasks run
   under `sync_witness.aot_phase()` and are attributed to the per-entry
   AOT columns of obs/jitstats; coverage is published per entry
   (`karpenter_aot_precompiled_fraction`) and the armed state serves on
   `/debug/aot`.

3. **Armed dispatch**: the counterpart of a compiled executable is one
   captured CUDA graph per `exec_key` -- (entry, statics, input shapes and
   dtypes, fingerprint). Capture runs the entry once eagerly on a side
   stream (the library load, the shared-memory ceiling, lazy modules,
   allocator growth), then records it with `capture_error_mode=
   "thread_local"` (the tick thread may allocate meanwhile) into one graph
   memory pool shared by every capture. The graph reads its own static
   input buffers, never a live catalog tensor (an LRU or pressure eviction
   would leave it reading freed memory): `try_call` copies the call's
   inputs into them (device to device), replays, and returns CLONES of the
   static outputs made on the stream (two ticks in flight must not share
   one output), counting `karpenter_aot_dispatches_total{entry}`. On
   `device="cpu"` there are no graphs: an armed entry is the entry's
   original function bound to its statics, so the keys, the coverage, the
   ladder, `describe()` and the rungs run the same way.

Rungs, each counted, each leaving the tick on the ordinary dispatch of
the same kernel (never its plain version): a rejected replay disarms its
key (`{reason="dispatch"}`; the `aot.dispatch` failpoint drills it), a
failed capture skips its task (`{reason="compile"}`), a library the store
cannot take (`{reason="serialize"}`, build.py).

Not here: the JAX module's `_mesh_tasks` (warm calls for the sharded
engine's current and shrunk layouts) waits for the mesh slice (ROADMAP
A11); `describe()` says so. Importing this module imports nothing of
CUDA; graphs are made inside functions.
"""
from __future__ import annotations

import functools
import hashlib
import os
import threading
import time
import weakref
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from karpenter_tpu_torch import failpoints, metrics
from karpenter_tpu_torch.analysis import torch_witness
from karpenter_tpu_torch.logging import get_logger
from karpenter_tpu_torch.solver.kernels import build

log = get_logger("aot")

# operator-facing knobs (the JAX package's)
CACHE_ENV = build.CACHE_ENV                 # store root (versioned under it)
AOT_ENV = "KARPENTER_TPU_AOT"               # "0" disables the AOT layers
DUTY_ENV = "KARPENTER_TPU_AOT_DUTY"         # ladder duty cycle (0..1]

_ARTIFACT_VERSION = 1
# ladder sleeps are capped so one slow capture cannot park the ladder for
# minutes between tasks
_MAX_THROTTLE_SLEEP_S = 30.0
# the mesh tasks' place in /debug/aot until the sharded engine exists
MESH_TASKS = "not ported: the sharded engine's layouts wait for ROADMAP A11"

AOT_PRECOMPILED_FRACTION = metrics.AOT_PRECOMPILED_FRACTION
AOT_DISPATCHES = metrics.AOT_DISPATCHES
AOT_FALLBACKS = metrics.AOT_FALLBACKS
AOT_SERIALIZED = metrics.AOT_SERIALIZED
AOT_LOADED = metrics.AOT_LOADED
AOT_SWEPT_DIRS = metrics.AOT_SWEPT_DIRS

# the store's layout lives with the kernels it holds
fingerprint = build.fingerprint
resolve_root = build.resolve_root
sweep_stale = build.sweep_stale
prepare_cache = build.prepare_cache

# every live manager, for jitstats' cache_size column
_MANAGERS: "weakref.WeakSet[AotManager]" = weakref.WeakSet()


def armed_by_entry() -> Dict[str, int]:
    """Armed dispatches per entry family over every live manager."""
    out: Dict[str, int] = {}
    for mgr in list(_MANAGERS):
        for entry, n in mgr.armed_counts().items():
            out[entry] = out.get(entry, 0) + n
    return out


# -- argument trees ----------------------------------------------------------------


def _flatten(tree: Any) -> Tuple[List[Any], Any]:
    """(leaves, structure) of nested tuples, lists and NamedTuples."""
    if isinstance(tree, (tuple, list)):
        leaves: List[Any] = []
        specs = []
        for x in tree:
            sub, spec = _flatten(x)
            leaves.extend(sub)
            specs.append((len(sub), spec))
        return leaves, (type(tree), specs)
    return [tree], None


def _unflatten(spec: Any, leaves: Sequence[Any]) -> Any:
    if spec is None:
        return leaves[0]
    kind, specs = spec
    parts, off = [], 0
    for n, sub in specs:
        parts.append(_unflatten(sub, leaves[off: off + n]))
        off += n
    if kind is list:
        return parts
    if kind is tuple:
        return tuple(parts)
    return kind(*parts)   # a NamedTuple


def _aval_sig(tree: Any) -> str:
    """Shape/dtype signature of an argument tree: with the entry name and
    statics, it pins exactly one captured graph."""
    parts = []
    for x in _flatten(tree)[0]:
        shape = tuple(getattr(x, "shape", ()))
        dtype = str(getattr(x, "dtype", type(x).__name__))
        parts.append(f"{shape}:{dtype}")
    return ";".join(parts)


def exec_key(entry: str, statics: Dict[str, Any], args: Tuple, fp: str) -> str:
    """The armed-table key: one per (entry, static bucket, input shape and
    dtype signature, store fingerprint). Computed identically at plan
    time and at the dispatch seam, so a hit means the armed graph takes
    exactly these inputs."""
    statics_repr = repr(sorted(statics.items()))
    raw = f"{_ARTIFACT_VERSION}|{fp}|{entry}|{statics_repr}|{_aval_sig(args)}"
    return hashlib.sha256(raw.encode()).hexdigest()[:32]


# -- the armed forms -----------------------------------------------------------------


class GraphExec:
    """One captured CUDA graph over its own static input buffers."""

    def __init__(self, graph, static_in: List[torch.Tensor], out_leaves: List[torch.Tensor],
                 out_spec: Any):
        self.graph = graph
        self.static_in = static_in
        self.out_leaves = out_leaves
        self.out_spec = out_spec

    def __call__(self, *args):
        leaves = _flatten(args)[0]
        if len(leaves) != len(self.static_in):
            raise ValueError(f"graph takes {len(self.static_in)} inputs, got {len(leaves)}")
        for dst, src in zip(self.static_in, leaves):
            if (not isinstance(src, torch.Tensor) or src.shape != dst.shape
                    or src.dtype != dst.dtype or src.device != dst.device):
                raise ValueError(f"input drift: {getattr(src, 'shape', src)} "
                                 f"{getattr(src, 'dtype', '')} vs {tuple(dst.shape)} {dst.dtype}")
        for dst, src in zip(self.static_in, leaves):
            dst.copy_(src, non_blocking=True)
        self.graph.replay()
        # clones on the stream: the static outputs are the next replay's
        return _unflatten(self.out_spec, [t.clone() for t in self.out_leaves])


def capture(fn: Callable, args: Tuple, statics: Dict[str, Any], pool=None) -> GraphExec:
    """Capture `fn(*args, **statics)` (CUDA tensors) as a GraphExec: one
    eager call on a side stream first (library load, shared-memory
    ceiling, lazy modules, allocator growth), then the capture into
    `pool`, with this thread's unsafe calls the only ones refused."""
    leaves, spec = _flatten(args)
    static_in = [t.clone() for t in leaves]
    s_args = _unflatten(spec, static_in)
    device = static_in[0].device
    cur = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device)
    side.wait_stream(cur)
    with torch.cuda.stream(side):
        fn(*s_args, **statics)
    cur.wait_stream(side)
    torch_witness.note_capture(getattr(fn, "__name__", "?"))
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.device(device), torch.cuda.graph(graph, pool=pool,
                                                         capture_error_mode="thread_local"):
            out = fn(*s_args, **statics)
    except BaseException:
        graph.reset()       # a failed capture frees its partial graph now
        raise
    out_leaves, out_spec = _flatten(out)
    return GraphExec(graph, static_in, out_leaves, out_spec)


def _entry_fn(modname: str, fn_name: str):
    """The entry's own function: under the jitstats probes the module
    attribute is a probe, and an armed dispatch is not a probed call."""
    import importlib

    from karpenter_tpu_torch.obs import jitstats

    saved = jitstats.original(modname, fn_name)
    if saved is not None:
        return saved
    return getattr(importlib.import_module(modname), fn_name)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


# -- plan / ladder -------------------------------------------------------------------


class _Task(NamedTuple):
    tier: int            # 0 hot shapes, 2 side entries (convex), 3 rare buckets
    entry: str           # entry family (coverage gauge label)
    label: str           # human-readable, for /debug/aot
    key: Optional[str]   # armed-table key (None for warm-call tasks)
    run: Callable[[], Optional[Any]]   # -> the armed dispatch or None


class AotManager:
    """The armed table, the library store and the warm-up ladder for one
    TorchSolver. `try_call` is the dispatch seam: an armed key serves the
    dispatch; any miss or failure is the ordinary dispatch, bit-identical.

    `exec_dir` is the versioned library store (build.prepare_cache's
    directory), in the JAX exec store's place; `serialize` is kept from
    the JAX surface and reported: a CUDA graph has no portable serialized
    form, so graphs live in memory and only the libraries persist."""

    def __init__(self, solver, exec_dir: Optional[str] = None,
                 serialize: bool = True, duty: float = 0.05,
                 pads: Optional[Sequence[int]] = None):
        self.solver = solver
        self.serialize = serialize
        env_duty = os.environ.get(DUTY_ENV)
        if env_duty:
            try:
                duty = float(env_duty)
            except ValueError:
                pass
        # duty in (0, 1]: fraction of ladder wall time spent preparing;
        # >= 1 disables throttling (a synchronous prep pass)
        self.duty = min(max(duty, 0.005), 1.0)
        self.pads = tuple(pads) if pads is not None else None
        self.fingerprint = ""       # set lazily (it names the card)
        self.exec_dir = exec_dir
        if exec_dir:
            os.makedirs(exec_dir, exist_ok=True)
            build.use_store(exec_dir)
        self._armed: Dict[str, Any] = {}          # key -> GraphExec / closure
        self._armed_entry: Dict[str, str] = {}    # key -> entry family
        self._loaded = 0                          # libraries loaded from the store
        self._planned: Dict[str, int] = {}        # entry -> planned tasks
        self._done: Dict[str, set] = {}           # entry -> labels of finished tasks
        self._load_failures = 0
        self._compile_failures = 0
        self._ladder_runs = 0
        self._ladder_busy = False
        self._lock = threading.Lock()
        # one (copy in, replay, clone out) at a time: the captures share
        # one memory pool, so a replay may write another graph's outputs
        self._replay_lock = threading.Lock()
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._pending = None
        self._thread: Optional[threading.Thread] = None
        self._pool = None
        _MANAGERS.add(self)

    def _fp(self) -> str:
        if not self.fingerprint:
            self.fingerprint = fingerprint()
        return self.fingerprint

    @property
    def device(self) -> torch.device:
        return self.solver.device

    # -- restart path ------------------------------------------------------
    def load_store(self) -> int:
        """Load every kernel library in the store before the first catalog
        stages: the first tick then runs without nvcc. Returns the number
        loaded."""
        if not self.exec_dir:
            return 0
        loaded, failures = build.load_store()
        with self._lock:
            self._loaded += loaded
            self._load_failures += failures
        if loaded or failures:
            log.info("aot library store loaded", loaded=loaded, failures=failures)
        return loaded

    # -- dispatch seam -----------------------------------------------------
    def try_call(self, entry: str, args: Tuple, statics: Dict[str, Any]):
        """(hit, output): dispatch through an armed graph when one matches
        (entry, statics, input shapes) exactly; (False, None) otherwise. A
        rejected call disarms the key and takes the counted dispatch rung
        -- the tick continues on the ordinary dispatch."""
        with self._lock:
            empty = not self._armed
        if empty:
            return False, None
        key = exec_key(entry, statics, args, self._fp())
        with self._lock:
            fn = self._armed.get(key)
        if fn is None:
            return False, None
        try:
            # chaos site: a rejected replay costs the tick only the graph
            failpoints.eval("aot.dispatch")
            with self._replay_lock:
                out = fn(*args)
        except Exception as e:  # noqa: BLE001 -- any rejection (input drift,
            # a refused replay) disarms and falls back to the ordinary dispatch
            AOT_FALLBACKS.inc(reason="dispatch")
            with self._lock:
                self._armed.pop(key, None)
            log.warning("aot graph rejected dispatch; disarmed",
                        entry=entry, error=f"{type(e).__name__}: {e}"[:200])
            return False, None
        AOT_DISPATCHES.inc(entry=entry)
        return True, out

    def armed_counts(self) -> Dict[str, int]:
        with self._lock:
            out: Dict[str, int] = {}
            for key, entry in self._armed_entry.items():
                if key in self._armed:
                    out[entry] = out.get(entry, 0) + 1
            return out

    # -- plan building -----------------------------------------------------
    def _arm(self, task: "_Task", armed: Any) -> None:
        with self._lock:
            self._armed[task.key] = armed
            self._armed_entry[task.key] = task.entry

    def _graph_pool(self):
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        return self._pool

    def _lower_task(self, tier: int, entry: str, modname: str, fn_name: str,
                    args: Tuple, statics: Dict[str, Any], label: str) -> "_Task":
        key = exec_key(entry, statics, args, self._fp())

        def run():
            fn = _entry_fn(modname, fn_name)
            if self.device.type != "cuda":
                return functools.partial(fn, **statics)
            return capture(fn, args, statics, pool=self._graph_pool())

        return _Task(tier=tier, entry=entry, label=label, key=key, run=run)

    def build_plan(self, entry) -> List["_Task"]:
        """The task list for one staged catalog: every device entry x every
        class-count bucket the running config can dispatch, ordered by
        criticality. `entry` is the solver's _CatalogEntry: planning from
        its staged tensors makes every key match the tick's."""
        from karpenter_tpu_torch.solver import encode, ffd

        solver = self.solver
        tensors = entry.tensors
        offsets, words = entry.offsets, entry.words
        pads = self.pads or solver.WARM_C_PADS
        tasks: List[_Task] = []

        def inputs_for(cp: int):
            cs = encode.encode_classes([], tensors, c_pad=cp)
            return ffd.make_inputs_staged(entry.staged, cs, packed_masks=True)

        # tier 0: the production solve + its bound, every class-count
        # bucket -- the hot shapes a restart's first tick dispatches
        for cp in pads:
            inp = inputs_for(cp)
            fstat = dict(
                g_max=solver.g_max, nnz_max=ffd.nnz_budget(cp, solver.g_max),
                word_offsets=offsets, words=words, objective=solver.objective,
            )
            tasks.append(self._lower_task(
                0, "ffd_solve_fused", "karpenter_tpu_torch.solver.ffd",
                "ffd_solve_fused", (inp,), fstat, f"fused c{cp}"))
            placed = torch.zeros((cp,), dtype=torch.float32, device=solver.device)
            tasks.append(self._lower_task(
                0, "fractional_price_bound", "karpenter_tpu_torch.solver.bound",
                "fractional_price_bound", (inp, placed),
                dict(word_offsets=offsets, words=words), f"bound c{cp}"))
        # tier 2: the convex tier's relaxation, when the tier dispatches it
        if solver.tier == "convex":
            from karpenter_tpu_torch.solver.convex import relax

            for cp in pads:
                cstat = dict(iters=relax.DEFAULT_ITERS, word_offsets=offsets, words=words)
                tasks.append(self._lower_task(
                    2, "convex_relax", "karpenter_tpu_torch.solver.convex.relax",
                    "convex_relax", (inputs_for(cp),), cstat, f"convex c{cp}"))
        # tier 3 (rare buckets last): the consolidation kernels
        tasks.extend(self._disrupt_tasks(tensors))
        tasks.sort(key=lambda t: t.tier)
        return tasks

    def _disrupt_tasks(self, tensors) -> List["_Task"]:
        """The repack at its smallest pow2 candidate buckets (S=C=N=16)
        and the replacement search as warm calls (their shapes come from
        candidate counts), and the existing-node pre-pass's floor shape
        (S=1, C and N at their bucket floors) armed: it fires on every
        tick with a few live nodes."""
        from karpenter_tpu_torch.apis import labels as wk
        from karpenter_tpu_torch.solver import encode
        from karpenter_tpu_torch.solver.disrupt import kernel as disrupt_kernel

        solver = self.solver
        dev = solver.device
        R = int(tensors.cap.shape[1])
        K = int(tensors.k_pad)
        Z = int(tensors.tzone.shape[1])
        CT = int(tensors.tcap.shape[1])
        C = N = S = 16

        def run_repack():
            ops = disrupt_kernel.repack_from_numpy(
                np.zeros((N, R), np.float32), np.zeros((C, N), bool),
                np.zeros((C, R), np.float32), np.zeros((S, C), np.int32),
                np.zeros((S, N), bool), dev)
            solver._dispatch_disrupt_repack(*ops)
            _sync(dev)
            return None

        def run_replace():
            od_col = int(encode.CAPTYPE_INDEX[wk.CAPACITY_TYPE_ON_DEMAND])

            def put(a):
                return torch.from_numpy(a).to(dev)

            disrupt_kernel.disrupt_replace(
                put(np.zeros((S, C), np.int32)), put(np.zeros((C, R), np.float32)),
                put(np.zeros((C, K), bool)), put(np.zeros((C, Z), bool)),
                put(np.zeros((C, CT), bool)), put(np.zeros((K, R), np.float32)),
                put(np.zeros((R,), np.float32)),
                put(np.full((K, Z, CT), np.inf, np.float32)), od_col=od_col)
            _sync(dev)
            return None

        Cp = int(encode.bucket(1, 16))
        pack_args = disrupt_kernel.repack_from_numpy(
            np.zeros((N, R), np.float32), np.zeros((Cp, N), bool),
            np.zeros((Cp, R), np.float32), np.zeros((1, Cp), np.int32),
            np.zeros((1, N), bool), dev)
        return [
            _Task(3, "disrupt_repack", f"repack C{C} N{N} S{S}", None, run_repack),
            self._lower_task(3, "disrupt_repack", "karpenter_tpu_torch.solver.disrupt.kernel",
                             "disrupt_repack", pack_args, {}, f"pack-existing C{Cp} N{N} S1"),
            _Task(3, "disrupt_replace", f"replace C{C} S{S}", None, run_replace),
        ]

    # -- ladder ------------------------------------------------------------
    def on_catalog(self, entry) -> None:
        """A new catalog staged: (re)build the plan in the background
        ladder. The latest catalog wins -- a mid-plan re-stage abandons
        the stale remainder at the next task boundary."""
        with self._lock:
            self._pending = entry
            if self._thread is None or not self._thread.is_alive():
                self._thread = threading.Thread(
                    target=self._ladder_loop, daemon=True, name="torchsolver-aot")
                self._thread.start()
        self._wake.set()

    def stop(self, timeout_s: Optional[float] = None) -> None:
        """Stop the ladder at its next task boundary; with `timeout_s`,
        wait that long for a task in flight to end."""
        self._stop.set()
        self._wake.set()
        t = self._thread
        if timeout_s is not None and t is not None:
            t.join(timeout_s)

    def _plan(self, entry) -> List["_Task"]:
        from karpenter_tpu_torch.analysis import sync_witness

        # planning stages the tasks' operands on the device (blocking
        # pageable copies, which synchronize): ladder work, booked apart
        # like the tasks' own, never as a live tick's sync sites
        with sync_witness.aot_phase():
            plan = self.build_plan(entry)
        with self._lock:
            self._planned = {}
            self._done = {}
            for t in plan:
                self._planned[t.entry] = self._planned.get(t.entry, 0) + 1
        self._publish_coverage()
        return plan

    def run_plan(self, entry, throttle: bool = True) -> Dict[str, Any]:
        """Build and execute the plan SYNCHRONOUSLY on the calling thread
        (a prep pass, tests). Returns a summary of what armed."""
        plan = self._plan(entry)
        armed = 0
        for task in plan:
            if self._run_task(task, throttle=throttle):
                armed += 1
        with self._lock:
            self._ladder_runs += 1
        return {"tasks": len(plan), "compiled": armed}

    def _ladder_loop(self) -> None:
        while not self._stop.is_set():
            self._wake.wait()
            if self._stop.is_set():
                return
            self._wake.clear()
            with self._lock:
                entry = self._pending
                self._pending = None
                self._ladder_busy = entry is not None
            if entry is None:
                continue
            try:
                for task in self._plan(entry):
                    if self._stop.is_set():
                        return
                    with self._lock:
                        stale = self._pending is not None
                    if stale:
                        break   # newer catalog: abandon, re-plan
                    self._run_task(task, throttle=True)
                with self._lock:
                    self._ladder_runs += 1
            except Exception as e:  # noqa: BLE001 -- the ladder is
                # best-effort: a plan failure costs coverage, never a tick
                AOT_FALLBACKS.inc(reason="compile")
                log.warning("aot ladder pass failed", error=f"{type(e).__name__}: {e}"[:200])
            finally:
                with self._lock:
                    self._ladder_busy = False

    def _run_task(self, task: "_Task", throttle: bool) -> bool:
        """One ladder step under the sync witness's aot phase and the
        solver's dispatch lock: capture (or warm-call), attribute to the
        per-entry AOT columns, arm, publish coverage, then yield the
        duty-cycle sleep. A key already armed (an identical-geometry
        catalog re-staged) is not captured again: the graph copies its
        inputs, so it serves any catalog of that geometry."""
        from karpenter_tpu_torch.analysis import sync_witness
        from karpenter_tpu_torch.obs import jitstats

        if task.key is not None:
            with self._lock:
                armed = task.key in self._armed
                if armed:
                    self._done.setdefault(task.entry, set()).add(task.label)
            if armed:
                self._publish_coverage()
                return True
        t0 = time.perf_counter()
        ok = False
        try:
            with sync_witness.aot_phase(), self.solver._dispatch_lock:
                prepared = task.run()
            ok = True
        except Exception as e:  # noqa: BLE001 -- one failed bucket is a
            # counted skip; everything else still arms
            prepared = None
            AOT_FALLBACKS.inc(reason="compile")
            with self._lock:
                self._compile_failures += 1
            log.warning("aot capture failed", task=task.label,
                        error=f"{type(e).__name__}: {e}"[:200])
        secs = time.perf_counter() - t0
        jitstats.note_aot(task.entry, secs)
        if prepared is not None and task.key is not None:
            self._arm(task, prepared)
        if ok:
            with self._lock:
                self._done.setdefault(task.entry, set()).add(task.label)
            self._publish_coverage()
        if throttle and self.duty < 1.0:
            time.sleep(min(_MAX_THROTTLE_SLEEP_S, secs * (1.0 - self.duty) / self.duty))
        return ok and prepared is not None

    def _publish_coverage(self) -> None:
        with self._lock:
            planned = dict(self._planned)
            done = {e: len(labels) for e, labels in self._done.items()}
        for entry, n in planned.items():
            AOT_PRECOMPILED_FRACTION.set(
                min(1.0, done.get(entry, 0) / n) if n else 0.0, entry=entry)

    def drain(self, timeout_s: float = 300.0) -> bool:
        """Wait for the background ladder to go idle."""
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            with self._lock:
                idle = self._pending is None and not self._ladder_busy
            if idle:
                return True
            time.sleep(0.02)
        return False

    # -- observability -----------------------------------------------------
    def describe(self) -> Dict[str, Any]:
        """The /debug/aot document: what is armed, what the plan covers,
        where the store lives, and every ladder counter."""
        armed_by_entry = self.armed_counts()
        with self._lock:
            planned = dict(self._planned)
            done = {e: len(labels) for e, labels in self._done.items()}
            doc = {
                "fingerprint": self._fp() if self.fingerprint else "",
                "exec_dir": self.exec_dir or None,
                "serialize": self.serialize,
                "duty": self.duty,
                "armed": len(self._armed),
                "loaded": self._loaded,
                "load_failures": self._load_failures,
                "compile_failures": self._compile_failures,
                "ladder_runs": self._ladder_runs,
                "ladder_busy": self._ladder_busy,
                "device": str(self.device),
                "armed_form": "cuda graph" if self.device.type == "cuda" else "plain closure",
                "mesh_tasks": MESH_TASKS,
            }
        entries = sorted(set(planned) | set(armed_by_entry))
        doc["entries"] = {
            e: {
                "planned": planned.get(e, 0),
                "done": done.get(e, 0),
                "armed": armed_by_entry.get(e, 0),
                "fraction": round(done.get(e, 0) / planned[e], 4) if planned.get(e) else None,
            }
            for e in entries
        }
        if self.exec_dir:
            doc["store"] = build.store_stats(self.exec_dir)
        return doc
