"""Tick tracing: span trees and the slow-tick flight recorder.

Copy of karpenter_tpu/tracing.py: ``Span``, ``Tracer`` (with the
thread-local current span and tail-biased sampling),
``trace``/``span``/``annotate``, the slow-tick
``FlightRecorder``, and the wire half -- ``WireTrace`` (the sidecar's
per-request stage recorder, echoed in the reply header) and the
tracer's ``inject``/``graft`` (the client ships its trace context and
grafts the echoed server stages under its ``wire`` span), the brownout
throttle (``set_throttled``), the launch fan-out's ``attach`` and the
``/debug/traces`` dump (``dump_json``).

TorchSolver, the incremental grouper and DisruptEngine open spans at the
JAX package's call sites and under its names -- ``spread``,
``pack_existing``, ``encode``, ``dispatch_device``, ``dispatch_convex``,
``device``, ``convex_fetch``, ``convex_round``, ``decode`` -- so a tick's
tree reads the same in both packages and the flight recorder
(obs/flight.py) keys the same stages. The port opens more spans than the
JAX package, all named in ``PORT_SPANS`` (none of them a flight-record
stage): the tick's host stages the JAX tree leaves inside a parent or
outside every span, and the consolidation engine's stages. Take them out
of a port tree, lifting each one's children into its parent in place,
and it is the JAX tree.

One clock with the device trace: while a ``torch.profiler`` capture
records, every span a tracer starts also opens a profiler range named
``karpenter::<span name>`` (``RANGE_PREFIX``), closed when the span
finishes, so the capture holds the program's stages on its own clock,
nested as the tree is. Grafted remote spans (the sidecar's clock) are
not mirrored.

Zero-cost-when-disabled: ``span()``/``trace()`` return a shared no-op
singleton after one attribute check; nothing allocates, nothing locks.
The clock is injectable for tests.
"""
from __future__ import annotations

import itertools
import json
import random
import sys
import threading
import time
import uuid
from collections import deque
from contextlib import contextmanager
from typing import Any, Dict, List, Optional

# the port's own spans, which the JAX tree lacks: the provisioning tick's
# host stages, then the consolidation engine's (solver/disrupt/engine.py)
PORT_SPANS = (
    "group", "route", "prepare", "merge_masks", "join_masks", "envelopes",
    "pack_feasibility", "pack_headroom", "pack_device", "pack_assign",
    "bound", "quality",
    "encode_sets", "pool_contexts", "repack", "replace", "assemble",
)
RANGE_PREFIX = "karpenter::"


def _profiler_range(name: str):
    """The profiler range mirroring span `name`, opened, while a
    torch.profiler capture records; else None. No capture can record
    in a process that has not imported torch."""
    torch = sys.modules.get("torch")
    if torch is None or not torch.autograd._profiler_enabled():
        return None
    rf = torch.autograd.profiler.record_function(RANGE_PREFIX + name)
    rf.__enter__()
    return rf


class Span:
    """One timed operation in a trace tree. Use as a context manager; the
    tree is linked at start (parent.children), timed at exit. Attributes
    set via `set(**attrs)` become JSON fields in dumps."""

    __slots__ = (
        "name", "trace_id", "span_id", "parent_id", "start", "end",
        "attributes", "children", "sampled", "_tracer", "_prev", "_range",
    )

    def __init__(self, name: str, trace_id: str, span_id: str,
                 parent_id: Optional[str], start: float, tracer: "Tracer",
                 sampled: bool = True):
        self.name = name
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.start = start
        self.end: Optional[float] = None
        self.attributes: Dict[str, Any] = {}
        self.children: List[Span] = []
        # sampled-out trees still BUILD (so the flight recorder can catch
        # a slow tick regardless of the sample rate) but do not feed the
        # per-span metrics volume -- see Tracer.trace()
        self.sampled = sampled
        self._tracer = tracer
        self._prev: Optional[Span] = None
        self._range = None          # the open profiler range, if a capture records

    def set(self, **attrs) -> "Span":
        self.attributes.update(attrs)
        return self

    @property
    def duration_s(self) -> float:
        return ((self.end if self.end is not None else self._tracer._clock())
                - self.start)

    def __enter__(self) -> "Span":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc is not None:
            self.attributes["error"] = f"{type(exc).__name__}: {exc}"[:200]
        self._tracer._finish(self)

    def to_dict(self, t0: Optional[float] = None) -> dict:
        """JSON-ready tree, times in ms relative to the root's start."""
        if t0 is None:
            t0 = self.start
        end = self.end if self.end is not None else self.start
        return {
            "name": self.name,
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "start_ms": round((self.start - t0) * 1e3, 3),
            "duration_ms": round((end - self.start) * 1e3, 3),
            "attributes": self.attributes,
            "children": [c.to_dict(t0) for c in self.children],
        }


class _NoopSpan:
    """Shared do-nothing span: the disabled/unsampled path allocates
    nothing and every method is a constant-time no-op."""

    __slots__ = ()
    name = ""
    attributes: Dict[str, Any] = {}
    duration_s = 0.0

    def set(self, **attrs) -> "_NoopSpan":
        return self

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        return None

    def to_dict(self, t0=None) -> dict:
        return {}


NOOP = _NoopSpan()


class FlightRecorder:
    """Ring buffer of the last `capacity` complete span trees whose root
    exceeded `slow_ms` -- plus ALWAYS the worst-ever tree, threshold or
    not. Trees are serialized to dicts at record time so a concurrent
    dump (the /debug/traces handler thread) never reads a mutating tree."""

    def __init__(self, capacity: int = 32, slow_ms: float = 1000.0):
        self.capacity = capacity
        self.slow_ms = slow_ms
        self._lock = threading.Lock()
        self._slow: deque = deque(maxlen=capacity)
        self._worst: Optional[dict] = None
        self._worst_ms = -1.0

    def record(self, root: Span) -> None:
        dur_ms = root.duration_s * 1e3
        slow = dur_ms >= self.slow_ms
        if not slow and dur_ms <= self._worst_ms:
            return  # fast tick, not a new worst: nothing to serialize
        doc = root.to_dict()
        with self._lock:
            if dur_ms > self._worst_ms:
                self._worst, self._worst_ms = doc, dur_ms
            if slow:
                self._slow.append(doc)
                from karpenter_tpu_torch import metrics

                metrics.TRACE_SLOW_TICKS.inc()

    def dump(self) -> dict:
        with self._lock:
            return {
                "threshold_ms": self.slow_ms,
                "capacity": self.capacity,
                "worst": self._worst,
                "slow": list(self._slow),
            }

    def clear(self) -> None:
        with self._lock:
            self._slow.clear()
            self._worst, self._worst_ms = None, -1.0


class Tracer:
    """Process-wide tracer (the module-level TRACER is the analogue of
    metrics.REGISTRY). `trace()` starts a root (sampling decided here);
    `span()` attaches a child to the thread-local current span and is a
    no-op when no trace is active -- so library code can instrument
    unconditionally and only pays when a root sampled in."""

    def __init__(self, enabled: bool = False, sample: float = 1.0,
                 clock=time.monotonic, rng=random.random,
                 slow_ms: float = 1000.0, capacity: int = 32):
        self.enabled = enabled
        self.sample = sample
        # brownout throttle (karpenter_tpu_torch/overload.py ladder rung 2):
        # while throttled the sample rate reads 0 but the CONFIGURED rate
        # is remembered for the hysteretic recovery
        self._throttled = False
        self._base_sample = sample
        self._clock = clock
        self._rng = rng
        self.recorder = FlightRecorder(capacity=capacity, slow_ms=slow_ms)
        self._local = threading.local()
        # per-process random prefix: span ids must not collide across the
        # controller and sidecar processes when grafted into one tree
        self._id_prefix = uuid.uuid4().hex[:8]
        self._ids = itertools.count(1)

    # -- configuration -------------------------------------------------------
    def configure(self, enabled: Optional[bool] = None,
                  sample: Optional[float] = None,
                  slow_ms: Optional[float] = None,
                  capacity: Optional[int] = None,
                  clock=None, rng=None) -> "Tracer":
        if enabled is not None:
            self.enabled = enabled
        if sample is not None:
            if self._throttled:
                # the configured rate updates UNDER the throttle: it is
                # what set_throttled(False) will restore
                self._base_sample = sample
            else:
                self.sample = sample
        if slow_ms is not None:
            self.recorder.slow_ms = slow_ms
        if capacity is not None:
            self.recorder.capacity = capacity
            with self.recorder._lock:
                self.recorder._slow = deque(
                    self.recorder._slow, maxlen=capacity
                )
        if clock is not None:
            self._clock = clock
        if rng is not None:
            self._rng = rng
        return self

    def set_throttled(self, throttled: bool) -> None:
        """Brownout ladder rung 2 (karpenter_tpu_torch/overload.py): stop the
        per-span metrics volume without forgetting the configured
        sample rate. Throttled tracing still BUILDS trees -- the flight
        recorder must keep catching the slow ticks that caused the
        brownout; only the sampled-in volume stops."""
        if throttled == self._throttled:
            return
        self._throttled = throttled
        if throttled:
            self._base_sample, self.sample = self.sample, 0.0
        else:
            self.sample = self._base_sample

    def reset(self) -> None:
        """Drop the recorder's state (tests, bench segments)."""
        self.recorder.clear()
        self._local.cur = None

    # -- span creation -------------------------------------------------------
    def current(self) -> Optional[Span]:
        return getattr(self._local, "cur", None)

    def trace(self, name: str, force: bool = False, **attrs):
        """Start a ROOT span (or a child, when a trace is already active
        on this thread). Sampling is TAIL-BIASED: with tracing enabled
        the tree always builds (measured ~0.1 ms per full tick tree, so a
        slow tick is NEVER invisible to the flight recorder -- head-based
        sampling would miss 1-sample of them), and the sample rate gates
        only the per-span metrics volume. Disabled tracing returns
        the no-op singleton and costs one attribute check."""
        cur = getattr(self._local, "cur", None)
        if cur is not None:
            return self._start(name, cur, attrs)
        if not (force or self.enabled):
            return NOOP
        return self._start(
            name, None, attrs, sampled=force or self._rng() < self.sample
        )

    def span(self, name: str, **attrs):
        """A child of the thread-local current span; no-op outside any
        active trace (the zero-cost-when-disabled path: one getattr)."""
        cur = getattr(self._local, "cur", None)
        if cur is None:
            return NOOP
        return self._start(name, cur, attrs)

    @contextmanager
    def attach(self, parent):
        """Adopt `parent` as the current span on THIS thread (fan-out
        workers inherit the dispatching thread's context: the launch
        pool's cloud calls and their batcher spans land under the tick's
        `launch` span). Safe concurrently: children appends are GIL-atomic
        and the parent outlives the workers (the fan-out joins before the
        parent span exits). No-op for None/no-op parents."""
        if parent is None or isinstance(parent, _NoopSpan):
            yield
            return
        prev = getattr(self._local, "cur", None)
        self._local.cur = parent
        try:
            yield
        finally:
            self._local.cur = prev

    def annotate(self, **attrs) -> None:
        """Set attributes on the current span, if any (used by fallback
        ladders to stamp the reason on the span already covering them)."""
        cur = getattr(self._local, "cur", None)
        if cur is not None:
            cur.attributes.update(attrs)

    def _start(self, name: str, parent: Optional[Span], attrs: dict,
               sampled: Optional[bool] = None) -> Span:
        sid = f"{self._id_prefix}-{next(self._ids):x}"
        if parent is None:
            trace_id, parent_id = sid, None
        else:
            trace_id, parent_id = parent.trace_id, parent.span_id
        sp = Span(
            name, trace_id, sid, parent_id, self._clock(), self,
            sampled=parent.sampled if sampled is None else sampled,
        )
        if attrs:
            sp.attributes.update(attrs)
        if parent is not None:
            parent.children.append(sp)
        sp._prev = parent
        sp._range = _profiler_range(name)
        self._local.cur = sp
        return sp

    def _finish(self, sp: Span) -> None:
        sp.end = self._clock()
        if sp._range is not None:
            sp._range.__exit__(None, None, None)
            sp._range = None
        self._local.cur = sp._prev
        if sp.sampled:
            from karpenter_tpu_torch import metrics

            metrics.TRACE_SPANS.inc(name=sp.name)
        # the recorder sees EVERY root, sampled or not: its own slow/worst
        # thresholds decide retention, so a slow tick cannot hide behind
        # an unlucky sample draw
        if sp.parent_id is None:
            self.recorder.record(sp)

    # -- wire propagation ----------------------------------------------------
    def inject(self) -> Optional[dict]:
        """The trace context to ship in an RPC request header, or None
        when no trace is active (the server then skips stage timing and
        the reply carries no echo)."""
        cur = getattr(self._local, "cur", None)
        if cur is None:
            return None
        return {"trace_id": cur.trace_id, "span_id": cur.span_id}

    def graft(self, header: dict) -> None:
        """Attach a reply header's echoed server-side stage spans under
        the current span. Server times are relative to its own op start;
        they are anchored at the current span's start (the clocks are not
        shared -- the raw server-relative offsets stay in the attributes).
        When the echoed trace context names a DIFFERENT trace than the
        current one -- a pipelined reply claimed a tick after its dispatch
        -- the grafted spans carry `origin_trace_id`/`origin_span_id` as
        the explicit link, so neither tick ends up with an orphaned
        half-trace."""
        spans = header.get("spans")
        cur = getattr(self._local, "cur", None)
        if not spans or cur is None:
            return
        ctx = header.get("trace") or {}
        link = {}
        if ctx.get("trace_id") and ctx["trace_id"] != cur.trace_id:
            link["origin_trace_id"] = ctx["trace_id"]
            if ctx.get("span_id"):
                link["origin_span_id"] = ctx["span_id"]
        for s in spans:
            try:
                name = str(s["name"])
                start_ms = float(s.get("start_ms", 0.0))
                dur_ms = float(s.get("dur_ms", 0.0))
            except (KeyError, TypeError, ValueError):
                continue  # a malformed echo must never break the solve
            sid = f"{self._id_prefix}-{next(self._ids):x}"
            sp = Span(name, cur.trace_id, sid, cur.span_id,
                      cur.start + start_ms / 1e3, self)
            sp.end = sp.start + dur_ms / 1e3
            sp.attributes = {
                "remote": True,
                "server_start_ms": start_ms,
                "server_dur_ms": dur_ms,
                **link,
            }
            extra = s.get("attrs")
            if isinstance(extra, dict):
                sp.attributes.update(extra)
            sp.sampled = cur.sampled
            cur.children.append(sp)
            if cur.sampled:
                # grafted remote stages count exactly like locally finished
                # spans in the per-name span counter
                from karpenter_tpu_torch import metrics

                metrics.TRACE_SPANS.inc(name=name)


class WireTrace:
    """Server-side (sidecar) per-request stage recorder. Built from the
    request header's trace context; `stage()` times a named server stage;
    `echo()` is splatted into the OK reply header so the client can graft
    the stages under its wire span. With no context (untraced request)
    every method is a no-op and the reply carries nothing."""

    __slots__ = ("ctx", "spans", "_clock", "_t0")

    def __init__(self, ctx: Optional[dict], clock=time.monotonic):
        self.ctx = ctx if isinstance(ctx, dict) else None
        self.spans: List[dict] = []
        self._clock = clock
        self._t0 = clock() if self.ctx is not None else 0.0

    @contextmanager
    def stage(self, name: str, **attrs):
        if self.ctx is None:
            yield
            return
        t0 = self._clock()
        try:
            yield
        finally:
            rec = {
                "name": name,
                "start_ms": round((t0 - self._t0) * 1e3, 3),
                "dur_ms": round((self._clock() - t0) * 1e3, 3),
            }
            if attrs:
                rec["attrs"] = attrs
            self.spans.append(rec)

    def echo(self) -> dict:
        if self.ctx is None:
            return {}
        return {"trace": self.ctx, "spans": self.spans}


# process-global tracer. Disabled until the operator (Options.tracing,
# default on with sampling), bench, or a test configures it -- library
# imports must not start sampling on their own.
TRACER = Tracer()


def trace(name: str, force: bool = False, **attrs):
    return TRACER.trace(name, force=force, **attrs)


def span(name: str, **attrs):
    return TRACER.span(name, **attrs)


def annotate(**attrs) -> None:
    TRACER.annotate(**attrs)


def dump_json(indent: Optional[int] = None) -> str:
    """The flight recorder as a JSON document (shared by /debug/traces
    and --trace-dump)."""
    return json.dumps(TRACER.recorder.dump(), indent=indent, default=repr)
