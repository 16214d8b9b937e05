"""Generic request batcher.

Rebuilds pkg/batcher/batcher.go:61-190: N concurrent single-item requests
coalesce into one backend call after an idle window (35 ms) or a max window
(1 s), capped at a max batch size, with hash-bucketing so only compatible
requests share a batch (DefaultHasher batcher.go:117-124) and per-item
result demultiplexing. The same window-accumulate-solve pattern feeds the
TPU solver: the provisioner's batching window IS this component (SURVEY.md
section 2.4).

Implementation is thread-based (callers block on a Future) but fully
clock-injectable and also usable in a synchronous step-driven mode
(`flush()`), which the deterministic kwok rig uses.

Copy of karpenter_tpu/batcher/batcher.py, imports rewritten to the port's.
"""
from __future__ import annotations

import threading
from concurrent.futures import Future
from concurrent.futures import TimeoutError as FutureTimeoutError
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Callable, Dict, Generic, Hashable, List, Optional, Sequence, Tuple, TypeVar

from karpenter_tpu_torch.cache.ttl import Clock

T = TypeVar("T")  # request item
U = TypeVar("U")  # per-item result


@dataclass
class BatchOptions:
    idle_seconds: float = 0.035     # reference: createfleet.go:36-46
    max_seconds: float = 1.0
    max_items: int = 1_000
    max_workers: int = 100


@dataclass
class _Bucket(Generic[T, U]):
    items: List[T] = field(default_factory=list)
    futures: List[Future] = field(default_factory=list)
    first_at: float = 0.0
    last_at: float = 0.0


class Batcher(Generic[T, U]):
    """exec_batch receives [T] and returns [U] aligned by index (or raises:
    the error fans out to every waiter in the batch)."""

    def __init__(
        self,
        exec_batch: Callable[[Sequence[T]], Sequence[U]],
        options: Optional[BatchOptions] = None,
        hasher: Optional[Callable[[T], Hashable]] = None,
        clock: Optional[Clock] = None,
        background: bool = False,
        name: str = "",
    ):
        self.name = name
        self.exec_batch = exec_batch
        self.options = options or BatchOptions()
        self.hasher = hasher or (lambda item: 0)
        self.clock = clock or Clock()
        self._lock = threading.Lock()
        self._buckets: Dict[Hashable, _Bucket] = {}
        self.batches_executed = 0
        self.items_executed = 0
        self.batch_sizes: List[int] = []  # metrics (pkg/batcher/metrics.go)
        self._background = background
        self._stop = threading.Event()
        self._window_expected = 0
        self._window_arrived = 0
        if background:
            self._thread = threading.Thread(target=self._run, daemon=True)
            self._thread.start()

    # -- submission ---------------------------------------------------------
    def add(self, item: T) -> Future:
        fut: Future = Future()
        now = self.clock.now()
        ready = None
        flush_all = False
        with self._lock:
            key = self.hasher(item)
            bucket = self._buckets.get(key)
            if bucket is None:
                bucket = self._buckets[key] = _Bucket(first_at=now)
            bucket.items.append(item)
            bucket.futures.append(fut)
            bucket.last_at = now
            if self._window_expected > 0:
                self._window_arrived += 1
                if self._window_arrived >= self._window_expected:
                    self._window_expected = 0
                    self._window_arrived = 0
                    flush_all = True
            if len(bucket.items) >= self.options.max_items:
                ready = self._buckets.pop(key)
        if ready is not None:
            self._execute(ready)
        if flush_all:
            self.flush(force=True)
        return fut

    @contextmanager
    def window(self, expected: int):
        """Rendezvous batching for foreground callers: treat the next
        `expected` add()s as one batching window -- the last arrival
        flushes, so concurrent identical requests merge deterministically
        instead of racing each caller's own force-flush. This is the 35 ms
        idle window collapsed to an exact count, usable because the caller
        (the provisioner's launch fan-out) knows its own parallelism; a
        straggler that never arrives is covered by the idle timeout in
        call(). Overlapping windows compose additively (the rendezvous
        fires when the combined expectation is met); exit subtracts only
        this window's share so a concurrent window is not clobbered."""
        with self._lock:
            self._window_expected += expected
        try:
            yield
        finally:
            flush_now = False
            with self._lock:
                self._window_expected = max(0, self._window_expected - expected)
                if self._window_expected == 0:
                    self._window_arrived = 0
                    flush_now = True
                else:
                    # a concurrent window remains open: surrender this
                    # window's arrival credit so its items cannot fire the
                    # survivor's rendezvous early (splitting its batch).
                    # Under-counting only delays the flush, and the idle
                    # timeout in call() caps that delay.
                    self._window_arrived = max(0, self._window_arrived - expected)
            if flush_now:
                self.flush(force=True)

    def call(self, item: T) -> U:
        """Submit and block (synchronous callers); in step-driven mode the
        caller must flush from another thread or use add()+flush()."""
        fut = self.add(item)
        if self._background:
            return fut.result()
        while not fut.done():
            with self._lock:
                windowed = self._window_expected > 0
            if not windowed:
                self.flush(force=True)
                break
            try:
                return fut.result(timeout=self.options.idle_seconds)
            except (TimeoutError, FutureTimeoutError):
                # BOTH spellings: Future.result raises
                # concurrent.futures.TimeoutError, which is only an alias
                # of the builtin TimeoutError from Python 3.11 -- on 3.10
                # the bare except missed it and the straggler timeout
                # escaped the rendezvous loop, killing the whole launch
                # fan-out instead of force-flushing the window
                self.flush(force=True)
        return fut.result()

    # -- window management --------------------------------------------------
    def _due(self, bucket: _Bucket, now: float, force: bool) -> bool:
        if force:
            return True
        if now - bucket.last_at >= self.options.idle_seconds:
            return True
        if now - bucket.first_at >= self.options.max_seconds:
            return True
        return False

    def flush(self, force: bool = False) -> int:
        """Execute all due buckets; returns number of batches run."""
        now = self.clock.now()
        due: List[_Bucket] = []
        with self._lock:
            for key in list(self._buckets):
                if self._due(self._buckets[key], now, force):
                    due.append(self._buckets.pop(key))
        for bucket in due:
            self._execute(bucket)
        return len(due)

    def _execute(self, bucket: _Bucket) -> None:
        from karpenter_tpu_torch import metrics, tracing

        self.batches_executed += 1
        self.items_executed += len(bucket.items)
        self.batch_sizes.append(len(bucket.items))
        window_s = max(0.0, bucket.last_at - bucket.first_at)
        metrics.BATCH_SIZE.observe(len(bucket.items), api=self.name)
        metrics.BATCH_WINDOW.observe(window_s, api=self.name)
        # the coalescing window itself is already over by the time the
        # batch executes; the span times the merged backend call and
        # carries the window it coalesced as an attribute
        with tracing.span(
            "batch", api=self.name, items=len(bucket.items),
            window_ms=round(window_s * 1e3, 3),
        ):
            try:
                # chaos site: an injected error fans out to every waiter in
                # the batch (the same path a backend failure takes); latency
                # models a slow cloud call holding the merged batch
                from karpenter_tpu_torch import failpoints

                failpoints.eval("batcher.exec")
                results = self.exec_batch(bucket.items)
                if len(results) != len(bucket.items):
                    raise RuntimeError(
                        f"batch executor returned {len(results)} results for {len(bucket.items)} items"
                    )
                for fut, res in zip(bucket.futures, results):
                    fut.set_result(res)
            except Exception as e:  # noqa: BLE001 -- error fans out to waiters
                for fut in bucket.futures:
                    fut.set_exception(e)

    def _run(self) -> None:
        while not self._stop.wait(self.options.idle_seconds / 2):
            self.flush()

    def stop(self) -> None:
        self._stop.set()
        self.flush(force=True)
