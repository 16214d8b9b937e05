"""Metrics registry: Prometheus-shaped counters/gauges/histograms.

Copy of karpenter_tpu/metrics.py: the same `Counter`, `Gauge`,
`Histogram`, `Registry` and text exposition, with only the families the
port's modules reach: the solver's, the wire's (transport, delta
shipping, the sidecar's staging LRUs, the breaker), and the operator's
(its controllers, the kwok batchers, the journal and fencing, overload
control, the replay and the shrinker), and the cold-start layer's (the
versioned kernel-library store and the warm-up ladder of solver/aot.py,
the per-entry table of obs/jitstats.py). Each family keeps the JAX
package's name, type and label names (tests/test_torch_obs.py holds every
family here against the JAX registry), so one dashboard and one runbook
serve both packages. No external client library.

The port has no Pallas -> XLA pin, so it has no
``karpenter_solver_kernel_fallbacks_total``: a wrapper given a CUDA
tensor launches its kernel or raises. ``SOLVER_KERNEL_DISPATCHES`` says
which implementation ran: ``cuda`` when the kernel launched, ``plain``
when its plain torch version ran (tensors on the CPU), ``aot`` when a
CUDA graph the warm-up ladder captured replayed it (solver/aot.py).
"""
from __future__ import annotations

import math
import threading
from typing import Dict, Iterable, List, Tuple

_DEFAULT_BUCKETS = (0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0)


class _Metric:
    def __init__(self, name: str, help: str, label_names: Tuple[str, ...]):
        self.name = name
        self.help = help
        self.label_names = label_names
        self._lock = threading.Lock()


class Counter(_Metric):
    def __init__(self, name, help, label_names=()):
        super().__init__(name, help, tuple(label_names))
        self._values: Dict[tuple, float] = {}

    def inc(self, amount: float = 1.0, **labels) -> None:
        key = tuple(labels.get(l, "") for l in self.label_names)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def value(self, **labels) -> float:
        key = tuple(labels.get(l, "") for l in self.label_names)
        return self._values.get(key, 0.0)

    def collect(self):
        # snapshot under the lock: a scrape may run on another thread
        # while the solver mutates concurrently
        with self._lock:
            items = list(self._values.items())
        for key, v in items:
            yield key, v, "counter"


class Gauge(_Metric):
    def __init__(self, name, help, label_names=()):
        super().__init__(name, help, tuple(label_names))
        self._values: Dict[tuple, float] = {}

    def set(self, value: float, **labels) -> None:
        key = tuple(labels.get(l, "") for l in self.label_names)
        with self._lock:
            self._values[key] = float(value)

    def value(self, **labels) -> float:
        key = tuple(labels.get(l, "") for l in self.label_names)
        return self._values.get(key, 0.0)

    def remove(self, **labels) -> None:
        """Delete a label series entirely (DeletePartialMatch in the
        reference's prometheus usage) -- churn-heavy controllers must
        remove series for gone objects, not zero them, or cardinality
        grows without bound."""
        key = tuple(labels.get(l, "") for l in self.label_names)
        with self._lock:
            self._values.pop(key, None)

    def collect(self):
        with self._lock:
            items = list(self._values.items())
        for key, v in items:
            yield key, v, "gauge"


class Histogram(_Metric):
    def __init__(self, name, help, label_names=(), buckets: Iterable[float] = _DEFAULT_BUCKETS):
        super().__init__(name, help, tuple(label_names))
        self.buckets = tuple(sorted(buckets))
        self._counts: Dict[tuple, List[int]] = {}
        self._sums: Dict[tuple, float] = {}
        self._totals: Dict[tuple, int] = {}
        self._samples: Dict[tuple, List[float]] = {}

    def observe(self, value: float, **labels) -> None:
        key = tuple(labels.get(l, "") for l in self.label_names)
        with self._lock:
            counts = self._counts.setdefault(key, [0] * len(self.buckets))
            for i, b in enumerate(self.buckets):
                if value <= b:
                    counts[i] += 1
            self._sums[key] = self._sums.get(key, 0.0) + value
            self._totals[key] = self._totals.get(key, 0) + 1
            samples = self._samples.setdefault(key, [])
            samples.append(value)
            if len(samples) > 10_000:
                del samples[: len(samples) // 2]

    def percentile(self, q: float, **labels) -> float:
        key = tuple(labels.get(l, "") for l in self.label_names)
        # snapshot under the metric lock: observe() appends to and HALVES
        # this list from controller threads while a scrape-side caller
        # computes percentiles -- the same scrape-vs-mutate hazard the
        # collect()/expose() snapshots guard against (sorting the live
        # list could read a mid-halving state and misreport the tail)
        with self._lock:
            samples = list(self._samples.get(key, ()))
        if not samples:
            return math.nan
        samples.sort()
        idx = min(len(samples) - 1, max(0, math.ceil(q / 100.0 * len(samples)) - 1))
        return samples[idx]

    def collect(self):
        with self._lock:
            items = list(self._totals.items())
        for key, total in items:
            yield key, total, "histogram"


class Registry:
    def __init__(self):
        self._metrics: Dict[str, _Metric] = {}
        self._lock = threading.Lock()

    def counter(self, name: str, help: str = "", labels=()) -> Counter:
        return self._register(name, lambda: Counter(name, help, labels))

    def gauge(self, name: str, help: str = "", labels=()) -> Gauge:
        return self._register(name, lambda: Gauge(name, help, labels))

    def histogram(self, name: str, help: str = "", labels=(), buckets=_DEFAULT_BUCKETS) -> Histogram:
        return self._register(name, lambda: Histogram(name, help, labels, buckets))

    def _register(self, name, factory):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = factory()
            return m

    def expose(self) -> str:
        """Prometheus text exposition, the registry map snapshotted under
        the registry lock."""
        out = []
        with self._lock:
            metrics_snapshot = sorted(self._metrics.items())
        for name, m in metrics_snapshot:
            out.append(f"# HELP {name} {m.help}")
            if isinstance(m, Histogram):
                out.append(f"# TYPE {name} histogram")
                # snapshot all three maps under the metric lock
                with m._lock:
                    totals = list(m._totals.items())
                    counts = {k: list(v) for k, v in m._counts.items()}
                    sums = dict(m._sums)
                for key, total in totals:
                    lbl = _labels_str(m.label_names, key)
                    cum = 0
                    for i, b in enumerate(m.buckets):
                        cum = counts[key][i]
                        le = _labels_str(m.label_names + ("le",), key + (_canonical_float(b),))
                        out.append(f"{name}_bucket{le} {cum}")
                    inf = _labels_str(m.label_names + ("le",), key + ("+Inf",))
                    out.append(f"{name}_bucket{inf} {total}")
                    out.append(f"{name}_sum{lbl} {sums[key]}")
                    out.append(f"{name}_count{lbl} {total}")
            else:
                kind = "counter" if isinstance(m, Counter) else "gauge"
                out.append(f"# TYPE {name} {kind}")
                for key, v, _ in m.collect():
                    out.append(f"{name}{_labels_str(m.label_names, key)} {v}")
        return "\n".join(out) + "\n"


def _canonical_float(b) -> str:
    """Canonical exposition float for `le` bucket bounds (%g-style)."""
    return f"{float(b):g}"


def _escape_label_value(v: str) -> str:
    """Prometheus text-exposition escaping for label values (backslash,
    double quote, newline)."""
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _labels_str(names, values) -> str:
    if not names:
        return ""
    inner = ",".join(
        f'{n}="{_escape_label_value(str(v))}"' for n, v in zip(names, values)
    )
    return "{" + inner + "}"


# process-global registry
REGISTRY = Registry()

# device consolidation engine (solver/disrupt/engine.py): both routes
# record these; DISRUPTION_DEVICE_SETS below is counted by the disruption
# controller (controllers/disruption.py), as in the JAX package
DISRUPTION_DEVICE_DISPATCHES = REGISTRY.counter(
    "karpenter_disruption_device_dispatches_total",
    "Batched consolidation evaluations by dispatch route (wire = the "
    "solve_disrupt op on the solver sidecar; local = the same kernels in "
    "process -- also the breaker-open / wire-dead fallback route)",
    labels=("path",),  # wire | local
)
DISRUPTION_DEVICE_FALLBACKS = REGISTRY.counter(
    "karpenter_disruption_device_fallbacks_total",
    "Consolidation evaluations that fell off the wire route to the "
    "in-process kernels, by reason (decisions stay bit-identical; "
    "rpc-down failures also count toward the shared circuit breaker)",
    labels=("reason",),  # rpc-down | breaker-open | feature-missing
)
DISRUPTION_DEVICE_SWEEP_SECONDS = REGISTRY.histogram(
    "karpenter_disruption_device_sweep_seconds",
    "Wall time of one batched candidate-set evaluation (encode + "
    "dispatch + verdict assembly, every set in one device pass)",
)
# the wire solve's mid-flight fallbacks (solver/service.py)
SOLVER_PIPELINE_FALLBACKS = REGISTRY.counter(
    "karpenter_scheduler_pipeline_fallbacks_total",
    "Pipelined solves that fell back to the synchronous path mid-flight",
    labels=("reason",),  # catalog-changed | stale-seqnum | stale-epoch | rpc-degraded | rpc-down
)
# solver-wire circuit breaker (solver/breaker.py)
BREAKER_STATE = REGISTRY.gauge(
    "karpenter_scheduler_breaker_state",
    "Solver wire circuit-breaker state (1 on the active state's series)",
    labels=("state",),  # closed | open | half-open
)
BREAKER_TRANSITIONS = REGISTRY.counter(
    "karpenter_scheduler_breaker_transitions_total",
    "Solver wire circuit-breaker state transitions", labels=("to",),
)
BREAKER_SHORT_CIRCUITS = REGISTRY.counter(
    "karpenter_scheduler_breaker_short_circuits_total",
    "Solves that skipped the solver wire because the breaker was open "
    "(served by the in-process host backend with no connect stall)",
)
BREAKER_PROBES = REGISTRY.counter(
    "karpenter_scheduler_breaker_probes_total",
    "Half-open sidecar probes by outcome", labels=("outcome",),  # success | failure
)
# tracing (karpenter_tpu_torch/tracing.py)
TRACE_SPANS = REGISTRY.counter(
    "karpenter_tracing_spans_total",
    "Completed trace spans by span name", labels=("name",),
)
TRACE_SLOW_TICKS = REGISTRY.counter(
    "karpenter_tracing_slow_ticks_total",
    "Root span trees retained by the slow-tick flight recorder",
)
# failpoint framework (karpenter_tpu_torch/failpoints.py)
FAILPOINT_FIRES = REGISTRY.counter(
    "karpenter_failpoints_fired_total",
    "Fault injections fired by armed failpoints", labels=("site", "action"),
)
# an observe-only handler that absorbs an error counts it here instead
# of staying invisible (the quality bound's rungs, hbm accounting)
HANDLED_ERRORS = REGISTRY.counter(
    "karpenter_handled_errors_total",
    "Errors deliberately absorbed by a must-never-fail handler, by "
    "handler site (the errflow/broad-swallow lint contract: silence "
    "must be observable)",
    labels=("site",),
)
# the incremental delta-solve engine: the grouper
# (solver/encode.IncrementalGrouper) and delta class shipping over the
# wire (solver/rpc.py solve_delta)
DELTA_SOLVES = REGISTRY.counter(
    "karpenter_scheduler_delta_solves_total",
    "Wire solves by class-tensor shipping mode (delta = dirty rows only "
    "against a staged class epoch; full = whole tensor set establishing a "
    "new epoch; bypass = delta path not applicable)",
    labels=("mode",),  # delta | full | bypass
)
DELTA_ROWS_SHIPPED = REGISTRY.counter(
    "karpenter_scheduler_delta_rows_shipped_total",
    "Dirty class-tensor rows shipped by delta solves (full solves ship "
    "every row and are not counted here)",
)
DELTA_EPOCH_RESTAGES = REGISTRY.counter(
    "karpenter_scheduler_delta_epoch_restages_total",
    "Delta solves that fell back to a full class-tensor restage because "
    "the sidecar no longer knew the base class epoch (restart or eviction)",
)
DELTA_PAYLOAD_BYTES = REGISTRY.histogram(
    "karpenter_scheduler_delta_payload_bytes",
    "Class-tensor payload bytes shipped per wire solve, by shipping mode",
    labels=("mode",),  # delta | full | bypass
    buckets=(1024, 4096, 16384, 65536, 262144, 1048576, 4194304),
)
SOLVER_STAGED_EVICTIONS = REGISTRY.counter(
    "karpenter_solver_staged_evictions_total",
    "Sidecar staging-LRU evictions by kind (catalog seqnums, class-tensor "
    "epochs); an eviction costs the next referencing solve a full restage",
    labels=("kind",),  # catalog | class_epoch
)
DELTA_DIRTY_FRACTION = REGISTRY.histogram(
    "karpenter_scheduler_delta_dirty_fraction",
    "Fraction of pod classes dirty (appeared, vanished, or changed count) "
    "since the previous scheduling tick's grouping",
    buckets=(0.01, 0.02, 0.05, 0.1, 0.2, 0.3, 0.5, 0.75, 1.0),
)
# device memory attribution and pressure eviction (obs/hbm.py; the
# karpenter_device_hbm_* gauges register there)
SOLVER_STAGED_BYTES = REGISTRY.gauge(
    "karpenter_solver_staged_bytes",
    "Staged tensor bytes by owner: catalog = encoded+device-staged "
    "catalog LRU entries; class_epoch = the sidecar's class-tensor epoch "
    "store; class_masks = the last solve's open/join allowed-mask rows "
    "(packed or full-width; see karpenter_solver_packed_mask_bytes); "
    "solve_temporaries = the last solve's input tensors. The HBM "
    "attribution half of karpenter_device_hbm_bytes_in_use",
    labels=("kind",),  # catalog | class_masks | solve_temporaries
)
SOLVER_PACKED_MASK_BYTES = REGISTRY.gauge(
    "karpenter_solver_packed_mask_bytes",
    "Bytes of the last solve's open/join allowed-mask tensors: packed = "
    "the form actually staged (uint32 words when packed_masks is on, "
    "bool rows otherwise); full_equiv = what the full-width bool [C,K] "
    "form would cost. packed/full_equiv is the measured mask reduction "
    "(>=8x when packed, k_pad being a multiple of 128)",
    labels=("form",),  # packed | full_equiv
)
SOLVER_KERNEL_DISPATCHES = REGISTRY.counter(
    "karpenter_solver_kernel_dispatches_total",
    "Hot-path kernel dispatches by entry and implementation actually "
    "run: cuda = the hand-written CUDA kernel (csrc/), plain = its plain "
    "torch version (tensors on the CPU), aot = an armed dispatch of the "
    "warm-up ladder (a CUDA graph replay on the card). A solver on the card "
    "counts cuda or aot only: a wrapper given a CUDA tensor launches its "
    "kernel or raises",
    labels=("entry", "impl"),  # ffd_solve_fused | disrupt_repack x cuda | plain | aot
)
SOLVER_STAGED_PRESSURE_EVICTIONS = REGISTRY.counter(
    "karpenter_solver_staged_pressure_evictions_total",
    "Staging-LRU entries evicted because device HBM headroom dropped "
    "below the evict threshold ($KARPENTER_TPU_HBM_EVICT_HEADROOM, "
    "default 0.10) -- memory pressure shrinking the LRUs to their floor "
    "ahead of their fixed capacity",
    labels=("kind",),  # catalog | class_epoch
)
# wire transport v2 (solver/rpc.py zero-copy framing, solver/shm.py ring)
WIRE_BYTES = REGISTRY.counter(
    "karpenter_wire_bytes_total",
    "Solver wire bytes moved by the framing layer, by direction and "
    "transport (shm = the shared-memory ring of the colocated sidecar; "
    "tcp = the socket transport, TCP or UNIX-domain)",
    labels=("direction", "transport"),  # sent | received x shm | tcp
)
WIRE_PAYLOAD_COPIES = REGISTRY.counter(
    "karpenter_wire_payload_copies_total",
    "Intermediate payload copies made by the wire framing beyond the "
    "transport read/write itself (encode = send-side buffer copies before "
    "the scatter-gather send; decode = receive-side copies past the "
    "direct-into-tensor read, e.g. the epoch store's copy-on-first-write). "
    "Zero on the warm delta path by construction -- test-asserted",
    labels=("side",),  # encode | decode
)
WIRE_TRANSPORT = REGISTRY.gauge(
    "karpenter_wire_transport_in_use",
    "Active solver wire transport for this client (1 on the active "
    "transport's series; shm degrades to tcp on attach/corruption failures)",
    labels=("transport",),  # shm | tcp
)
WIRE_SHM_RING_FULL = REGISTRY.counter(
    "karpenter_wire_shm_ring_full_total",
    "Shared-memory ring send stalls: a frame waited for the reader to "
    "free ring space (backpressure events, not errors; a sustained rate "
    "means the segment is undersized -- see docs/operations.md)",
)
WIRE_SHM_SEND_TIMEOUTS = REGISTRY.counter(
    "karpenter_wire_shm_send_timeouts_total",
    "Shared-memory ring sends abandoned because the peer reader never "
    "freed ring space within the send deadline (a wedged reader; "
    "surfaces as a ConnectionError feeding the shm->tcp degrade ladder)",
)
# the convex tier (solver/convex/): LP relaxation + rounding
CONVEX_SOLVES = REGISTRY.counter(
    "karpenter_convex_solves_total",
    "Scheduling ticks that ran the convex tier, by differential winner "
    "(convex = the rounded LP placement strictly beat FFD on fleet "
    "price without leaving more pods behind; ffd = the incumbent kept "
    "the tick -- a loss, a tie, or a rounding fallback)",
    labels=("winner",),  # convex | ffd
)
CONVEX_FALLBACKS = REGISTRY.counter(
    "karpenter_convex_fallbacks_total",
    "Convex-tier ticks that landed on the FFD rung before the "
    "differential could judge a candidate, by reason (rounding = "
    "deterministic rounding returned no valid placement; dispatch = "
    "the relaxation dispatch/fetch failed; wire = the sidecar lacked "
    "the convex feature or the solve_convex op errored). The tick's "
    "DECISION is the pure-FFD one, bit-identical",
    labels=("reason",),  # rounding | dispatch
)
CONVEX_ITERATIONS = REGISTRY.gauge(
    "karpenter_convex_iterations",
    "Projected-subgradient iterations the last convex solve needed to "
    "converge (first iteration within rtol of the final objective; the "
    "schedule always RUNS the full static budget -- this reports how "
    "much of it the objective needed)",
)
CONVEX_TIGHTEN = REGISTRY.gauge(
    "karpenter_convex_bound_tighten_ratio",
    "Convex lower bound over the per-class fractional bound "
    "(solver/bound.py) for the last convex solve. > 1.0 means the "
    "coupled relaxation tightened the optimality-gap denominator; "
    "< 1.0 means the fixed-iteration certificate came out looser "
    "than the closed-form bound on this instance (the gap always "
    "uses the MAX of the two, so it never loosens either way)",
)


# -- the controllers' families (controllers/, operator/, kwok/, batcher/,
# journal.py, fencing.py, overload.py, sim/): copied from the JAX
# package's metrics.py in its order, names, help and labels unchanged
# well-known metrics (names mirror the reference's metric families)
SCHEDULING_DURATION = REGISTRY.histogram(
    "karpenter_scheduler_scheduling_duration_seconds",
    "Duration of one scheduling simulation",
)
BATCH_SIZE = REGISTRY.histogram(
    "karpenter_cloud_batcher_batch_size", "Items per coalesced cloud call", labels=("api",),
    buckets=(1, 2, 5, 10, 25, 50, 100, 250, 500, 1000),
)
BATCH_WINDOW = REGISTRY.histogram(
    "karpenter_cloud_batcher_batch_time_seconds", "Batch window duration", labels=("api",),
)
INTERRUPTION_RECEIVED = REGISTRY.counter(
    "karpenter_interruption_received_messages_total", "Interruption messages by kind", labels=("kind",),
)
INTERRUPTION_DELETED = REGISTRY.counter(
    "karpenter_interruption_deleted_messages_total", "Interruption messages deleted",
)
NODECLAIMS_CREATED = REGISTRY.counter(
    "karpenter_nodeclaims_created_total", "NodeClaims created", labels=("nodepool",),
)
NODECLAIMS_TERMINATED = REGISTRY.counter(
    "karpenter_nodeclaims_terminated_total", "NodeClaims terminated", labels=("nodepool", "reason"),
)
INSTANCE_TYPE_COUNT = REGISTRY.gauge(
    "karpenter_cloudprovider_instance_type_offering_available",
    "Catalog size by nodeclass", labels=("nodeclass",),
)
IGNORED_PODS = REGISTRY.gauge("karpenter_ignored_pod_count", "Pods the scheduler cannot place")
DISRUPTION_DECISIONS = REGISTRY.counter(
    "karpenter_voluntary_disruption_decisions_total",
    "Disruption decisions by reason", labels=("reason",),
)
DISRUPTION_EVAL_DURATION = REGISTRY.histogram(
    "karpenter_voluntary_disruption_decision_evaluation_duration_seconds",
    "Duration of one disruption evaluation pass",
)
# device-resident consolidation engine (solver/disrupt/)
DISRUPTION_DEVICE_SETS = REGISTRY.counter(
    "karpenter_disruption_device_sets_total",
    "Consolidation candidate sets judged by the batched device evaluator, "
    "by enumeration kind (singleton = one node; prefix = the k cheapest-"
    "to-disrupt nodes together; pair = an underutilized pair outside the "
    "prefix order)",
    labels=("kind",),  # singleton | prefix | pair
)
DISRUPTION_DEVICE_BOUNDED_SWEEPS = REGISTRY.counter(
    "karpenter_disruption_device_bounded_sweeps_total",
    "Brownout rung-1 disruption sweeps that ran the bounded singleton-"
    "only device path instead of standing down entirely (the pre-device "
    "rung-1 behavior, still taken when no device evaluator is wired)",
)
GARBAGE_COLLECTED = REGISTRY.counter(
    "karpenter_garbage_collected_instances_total",
    "Orphaned cloud instances terminated by garbage collection",
)
PODS_BOUND = REGISTRY.counter(
    "karpenter_pods_bound_total", "Pods bound to nodes by the kwok binder",
)
SOLVER_PIPELINE_TICKS = REGISTRY.counter(
    "karpenter_scheduler_pipeline_ticks_total",
    "Scheduling decisions by execution mode of the provisioner tick",
    labels=("mode",),  # pipelined | synchronous
)
NODES_READY = REGISTRY.gauge(
    "karpenter_nodes_ready_count", "Ready nodes in the cluster",
)
PIPELINE_OVERLAP = REGISTRY.histogram(
    "karpenter_scheduler_pipeline_overlap_fraction",
    "Fraction of a pipelined solve's device+wire round trip hidden under "
    "the controller sweep (1.0 = fully overlapped)",
    buckets=(0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9, 0.95, 1.0),
)
# crash-consistency layer: write-ahead intent journal (karpenter_tpu/
# journal.py), restart recovery sweep (controllers/recovery.py), and
# leadership fencing (karpenter_tpu/fencing.py)
JOURNAL_WRITES = REGISTRY.counter(
    "karpenter_journal_writes_total",
    "Intent-journal records by operation and lifecycle event (begin = "
    "durable write-ahead record created; committed/adopted/... = resolved "
    "with that outcome)",
    labels=("op", "event"),  # op: launch | terminate
)
JOURNAL_OPEN = REGISTRY.gauge(
    "karpenter_journal_open_intents",
    "Open (unresolved) provisioning intents on the coordination bus; "
    "nonzero at steady state means launches/terminations are in flight, "
    "nonzero after a restart is the recovery sweep's work list",
)
RECOVERY_SWEEP_DURATION = REGISTRY.histogram(
    "karpenter_recovery_sweep_duration_seconds",
    "Duration of one restart recovery sweep (runs on every election win)",
)
RECOVERY_SWEEP_INTENTS = REGISTRY.counter(
    "karpenter_recovery_sweep_intents_total",
    "Open intents replayed by the recovery sweep, by outcome (adopted = "
    "launched instance reflected into its uncommitted claim; "
    "terminated_half_launch = instance without a live claim terminated "
    "immediately; resumed_termination = interrupted terminate re-issued; "
    "orphan_terminated = terminate intent without a claim finished; "
    "already_committed / dropped = no cloud work needed)",
    labels=("outcome",),
)
FENCING_REJECTED = REGISTRY.counter(
    "karpenter_fencing_rejected_total",
    "Cloud mutations refused at the cloud seam because the issuer's "
    "fencing epoch trailed the lease's (a deposed leader failing closed)",
    labels=("op",),  # create_fleet | terminate_instances | create_tags
)
# overload control (karpenter_tpu/overload.py): tick deadline budgets,
# priority-aware shedding, the brownout ladder, the stuck-tick watchdog
OVERLOAD_SHED = REGISTRY.counter(
    "karpenter_overload_shed_total",
    "Pending pods deferred to a later tick by bounded admission (the "
    "overload tentpole): admission-cap = the explicit per-tick intake "
    "bound; deadline = the tick-deadline budget could not afford the "
    "whole pending set; launch-bound = whole decision groups past the "
    "launch fan-out bound. Deferred pods stay pending and re-admit in "
    "priority/age order -- nothing is lost, only delayed",
    labels=("reason",),  # admission-cap | deadline | launch-bound
)
OVERLOAD_DEFERRED = REGISTRY.gauge(
    "karpenter_overload_deferred_pods",
    "Pending pods the LAST provisioner tick deferred past its admission "
    "bound (0 = the whole pending set was admitted)",
)
OVERLOAD_BROWNOUT_LEVEL = REGISTRY.gauge(
    "karpenter_overload_brownout_level",
    "Brownout ladder level (0 normal, 1 disruption sweeps shed, 2 + "
    "trace sampling shed, 3 + delta-epoch staging shed); recovers "
    "hysteretically -- see docs/operations.md overload runbook",
)
OVERLOAD_BROWNOUT_TRANSITIONS = REGISTRY.counter(
    "karpenter_overload_brownout_transitions_total",
    "Brownout ladder transitions by destination level name",
    labels=("to",),  # normal | shed-disruption | shed-tracing | shed-delta
)
OVERLOAD_SKIPPED_SWEEPS = REGISTRY.counter(
    "karpenter_overload_skipped_sweeps_total",
    "Optional controller sweeps stood down by the brownout ladder",
    labels=("stage",),  # disruption
)
OVERLOAD_WATCHDOG = REGISTRY.counter(
    "karpenter_overload_watchdog_escalations_total",
    "Stuck-tick watchdog escalations by ladder stage (cancel = solver "
    "wire closed under the wedged tick; breaker-open = breaker forced "
    "open; crash = OperatorCrashed async-raised so the restart recovery "
    "sweep takes over)",
    labels=("stage",),  # cancel | breaker-open | crash
)
OVERLOAD_TICK_OVERRUN = REGISTRY.histogram(
    "karpenter_overload_tick_overrun_ratio",
    "Tick duration over the configured tick deadline (1.0 = exactly on "
    "budget; the brownout ladder's EWMA input)",
    buckets=(0.1, 0.25, 0.5, 0.75, 1.0, 1.5, 2.0, 3.0, 5.0, 10.0),
)
# bounded interruption intake (controllers/interruption.py)
INTERRUPTION_DEFERRED = REGISTRY.counter(
    "karpenter_interruption_deferred_total",
    "Interruption sweeps whose per-sweep intake bound left messages for "
    "the next sweep, counted when that sweep finds messages waiting "
    "(bounded batch growth under an interruption storm; a bound landing "
    "exactly on the last queued message counts nothing unless fresh "
    "messages arrive in the gap)",
)
# scenario simulation & trace replay (karpenter_tpu/sim/)
SIM_EVENTS = REGISTRY.counter(
    "karpenter_sim_replay_events_total",
    "Trace events applied by the replay engine, by event kind", labels=("ev",),
)
SIM_TICKS = REGISTRY.counter(
    "karpenter_sim_replay_ticks_total",
    "Operator sweeps driven by the replay engine, by backend", labels=("backend",),
)
SIM_DIVERGENCES = REGISTRY.counter(
    "karpenter_sim_divergences_total",
    "Differential-replay divergences (placements/digest mismatches or "
    "invariant violations)", labels=("kind",),
)
SIM_SHRINK_ROUNDS = REGISTRY.counter(
    "karpenter_sim_shrink_rounds_total",
    "Delta-debugging reduction attempts run by the trace shrinker",
)

# the cold-start layer (solver/aot.py): the warm-up ladder's armed
# dispatches and its degrade rungs, the versioned kernel-library store
# (solver/kernels/build.py). The JAX package's names, help texts and labels
AOT_PRECOMPILED_FRACTION = REGISTRY.gauge(
    "karpenter_aot_precompiled_fraction",
    "Fraction of the enumerated AOT plan compiled and armed, per jit "
    "entry family (1.0 = every planned static/shape bucket of this "
    "entry is compile-free); /debug/aot carries the full breakdown",
    labels=("entry",),
)
AOT_DISPATCHES = REGISTRY.counter(
    "karpenter_aot_dispatches_total",
    "Solve dispatches served by an armed AOT executable instead of the "
    "jit path (bit-identical by the AOT differential; the cold-start "
    "latency win is measured by the bench coldstart stage)",
    labels=("entry",),
)
AOT_FALLBACKS = REGISTRY.counter(
    "karpenter_aot_fallbacks_total",
    "AOT degrade-ladder rungs taken, by reason: deserialize (corrupt/"
    "stale artifact -> JIT), dispatch (armed executable rejected the "
    "call -> disarmed + JIT), compile (a ladder task failed -> skipped), "
    "serialize (artifact write failed -> in-memory only). Every rung "
    "leaves the tick on the proven jit path",
    labels=("reason",),
)
AOT_SERIALIZED = REGISTRY.counter(
    "karpenter_aot_serialized_total",
    "Compiled executables serialized into the exec store, per entry -- "
    "what a restarted operator can load instead of recompiling",
    labels=("entry",),
)
AOT_LOADED = REGISTRY.counter(
    "karpenter_aot_loaded_total",
    "Serialized executables deserialized and armed at startup, per "
    "entry (the restart path's compile-free budget)",
    labels=("entry",),
)
AOT_SWEPT_DIRS = REGISTRY.counter(
    "karpenter_aot_swept_dirs_total",
    "Stale fingerprint-versioned cache directories removed at server "
    "start (a jaxlib/backend/topology change invalidates executables "
    "wholesale -- the shm stale-segment sweep, for compile artifacts)",
)
# the per-entry table (obs/jitstats.py): dispatches and host enqueue time
# per registered device entry; "compiles" are kernel-library loads and
# builds attributed to the calling thread's dispatch; the ladder's own
# captures count apart (the aot columns)
JIT_DISPATCHES = REGISTRY.counter(
    "karpenter_jit_entry_dispatches_total",
    "Calls into each registered jit entry point (JIT_ENTRY_FUNCTIONS), "
    "per entry -- the denominator of every per-entry cost claim",
    labels=("entry",),
)
JIT_DISPATCH_SECS = REGISTRY.counter(
    "karpenter_jit_entry_dispatch_seconds_total",
    "Cumulative wall seconds inside each jit entry call: trace+lower on "
    "a cache miss, argument staging + async launch on a hit (device "
    "execution overlaps and is NOT in here -- capture it with "
    "/debug/profile)",
    labels=("entry",),
)
JIT_COMPILES = REGISTRY.counter(
    "karpenter_jit_entry_compiles_total",
    "Jit traces attributed to each entry (compile-counter delta across "
    "one dispatch; populated while the jax witness's compile listener "
    "is installed)",
    labels=("entry",),
)
JIT_COMPILE_SECS = REGISTRY.counter(
    "karpenter_jit_entry_compile_seconds_total",
    "Cumulative jaxpr-trace seconds attributed to each entry (the "
    "retrace stall cost; backend-compile time comes on top when the "
    "persistent compilation cache misses)",
    labels=("entry",),
)
JIT_AOT_COMPILES = REGISTRY.counter(
    "karpenter_jit_entry_aot_compiles_total",
    "Warmup-ladder AOT precompiles per jit entry family (solver/aot.py; "
    "kept apart from karpenter_jit_entry_compiles_total so background "
    "precompilation never reads as hot-path compile cost)",
    labels=("entry",),
)
JIT_AOT_COMPILE_SECS = REGISTRY.counter(
    "karpenter_jit_entry_aot_compile_seconds_total",
    "Cumulative wall seconds the AOT warmup ladder spent precompiling "
    "each entry family (lower+compile, off the tick thread)",
    labels=("entry",),
)
COMPILE_CACHE_HITS = REGISTRY.counter(
    "karpenter_compile_cache_hits_total",
    "Persistent XLA compilation-cache hits (the backend binary came "
    "from disk; only the trace/lower phases ran)",
)
COMPILE_CACHE_MISSES = REGISTRY.counter(
    "karpenter_compile_cache_misses_total",
    "Persistent XLA compilation-cache misses (a full backend compile "
    "ran and its artifact was written). The CI cache-persistence drill "
    "asserts this stays 0 in a second process over a warm cache",
)
COMPILE_CACHE_BYTES = REGISTRY.gauge(
    "karpenter_compile_cache_bytes",
    "On-disk size of the persistent compile cache's versioned directory "
    "(XLA entries + serialized AOT executables), for the cache-sizing "
    "runbook in docs/operations.md",
)
