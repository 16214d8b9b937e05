"""Metrics registry: Prometheus-shaped counters/gauges/histograms.

Copy of karpenter_tpu/metrics.py: the same `Counter`, `Gauge`,
`Histogram`, `Registry` and text exposition, with only the families the
port's modules reach. Each family keeps the JAX package's name, type and
label names (tests/test_torch_obs.py holds every family here against the
JAX registry), so one dashboard and one runbook serve both packages. No
external client library.

The port has no Pallas -> XLA pin, so it has no
``karpenter_solver_kernel_fallbacks_total``: a wrapper given a CUDA
tensor launches its kernel or raises. ``SOLVER_KERNEL_DISPATCHES`` says
which implementation ran: ``cuda`` when the kernel launched, ``plain``
when its plain torch version ran (tensors on the CPU).
"""
from __future__ import annotations

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

    def observe(self, value: float, **labels) -> None:
        key = tuple(labels.get(l, "") for l in self.label_names)
        with self._lock:
            counts = self._counts.setdefault(key, [0] * len(self.buckets))
            for i, b in enumerate(self.buckets):
                if value <= b:
                    counts[i] += 1
            self._sums[key] = self._sums.get(key, 0.0) + value
            self._totals[key] = self._totals.get(key, 0) + 1

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

# device consolidation engine (solver/disrupt/engine.py): its local route
# records these two; the JAX package's _SETS (counted by the disruption
# controller) and _FALLBACKS (the wire route) wait for the port's
# controllers and sidecar
DISRUPTION_DEVICE_DISPATCHES = REGISTRY.counter(
    "karpenter_disruption_device_dispatches_total",
    "Batched consolidation evaluations by dispatch route (wire = the "
    "solve_disrupt op on the solver sidecar; local = the same kernels in "
    "process -- also the breaker-open / wire-dead fallback route)",
    labels=("path",),  # wire | local
)
DISRUPTION_DEVICE_SWEEP_SECONDS = REGISTRY.histogram(
    "karpenter_disruption_device_sweep_seconds",
    "Wall time of one batched candidate-set evaluation (encode + "
    "dispatch + verdict assembly, every set in one device pass)",
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
# the incremental grouper (solver/encode.IncrementalGrouper)
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
    "torch version (tensors on the CPU). A solver on the card counts cuda "
    "only: a wrapper given a CUDA tensor launches its kernel or raises",
    labels=("entry", "impl"),  # ffd_solve_fused | disrupt_repack x cuda | plain
)
SOLVER_STAGED_PRESSURE_EVICTIONS = REGISTRY.counter(
    "karpenter_solver_staged_pressure_evictions_total",
    "Staging-LRU entries evicted because device HBM headroom dropped "
    "below the evict threshold ($KARPENTER_TPU_HBM_EVICT_HEADROOM, "
    "default 0.10) -- memory pressure shrinking the LRUs to their floor "
    "ahead of their fixed capacity",
    labels=("kind",),  # catalog
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
