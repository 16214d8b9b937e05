"""On-demand ``torch.profiler`` capture bracketing production ticks.

Copy of karpenter_tpu/obs/profiler.py on ``torch.profiler.profile`` in
place of ``jax.profiler``: ``request(ticks)`` arms a capture of the next
N ticks, and the caller brackets every tick with ``on_tick_start`` /
``on_tick_end`` (the port's Operator brackets every sweep; chip_smoke.py
and the tests bracket the solves they drive alone). Both are a
lock-protected int check when nothing is armed. Brownout rung 2
(``set_throttled``) defers an armed capture, as in the JAX module.

A capture records the host (CPU) and, on a card, the device (CUDA)
activity -- every kernel the process launches, the hand-written ones
loaded through ctypes included -- and exports one Chrome trace per
capture to ``$KARPENTER_TPU_PROFILE_DIR/capture-<n>/trace.json``
(default directory ``profiles/``), readable in chrome://tracing or
Perfetto.
"""
from __future__ import annotations

import os
import threading
from typing import Any, Dict, Optional

from karpenter_tpu_torch import metrics
from karpenter_tpu_torch.logging import get_logger

PROFILE_DIR_ENV = "KARPENTER_TPU_PROFILE_DIR"
PROFILE_DIR_DEFAULT = "profiles"
MAX_TICKS_PER_CAPTURE = 1000
TRACE_FILE = "trace.json"

PROFILER_CAPTURES = metrics.REGISTRY.counter(
    "karpenter_profiler_captures_total",
    "Completed on-demand torch.profiler captures by outcome (ok = trace "
    "written; error = start/stop raised and the capture was abandoned)",
    labels=("outcome",),
)
PROFILER_ARMED = metrics.REGISTRY.gauge(
    "karpenter_profiler_armed_ticks",
    "Production ticks still to be captured by the armed torch.profiler "
    "request (0 = idle)",
)


class ProfilerCapture:
    """Arms and drives one capture at a time. State transitions happen
    under the lock; the profiler's own start/stop/export run outside it
    (they do real work and must not serialize against a concurrent
    ``describe``)."""

    log = get_logger("profiler")

    def __init__(self):
        self._lock = threading.Lock()
        self._armed = 0          # ticks still to capture (0 = idle)
        self._active = False     # a profile is live
        self._throttled = False  # brownout rung 2: defer, keep armed
        self._out_dir: Optional[str] = None
        self._capture_seq = 0
        self._prof = None
        self.captures = 0
        self.errors = 0
        self.last_trace_dir: Optional[str] = None

    # -- arming ----------------------------------------------------------------
    def request(self, ticks: int, out_dir: Optional[str] = None) -> Dict[str, Any]:
        """Arm a capture of the next `ticks` ticks; returns the state
        document. A request while a capture is armed/active REPLACES the
        remaining tick count but never the live trace directory."""
        ticks = max(1, min(int(ticks), MAX_TICKS_PER_CAPTURE))
        with self._lock:
            self._armed = ticks
            if not self._active:
                self._capture_seq += 1
                base = out_dir or os.environ.get(PROFILE_DIR_ENV) or PROFILE_DIR_DEFAULT
                self._out_dir = os.path.join(base, f"capture-{self._capture_seq}")
        PROFILER_ARMED.set(float(ticks))
        self.log.info("profiler capture armed", ticks=ticks, dir=self._out_dir)
        return self.describe()

    def set_throttled(self, throttled: bool) -> None:
        """Brownout ladder rung 2 (karpenter_tpu_torch/overload.py): while
        throttled, an armed capture waits and a live one stops at the
        current tick boundary -- same edge semantics as the tracer's
        sample throttle."""
        with self._lock:
            self._throttled = throttled

    # -- tick bracketing (Operator.tick) -------------------------------------
    def on_tick_start(self) -> None:
        with self._lock:
            if self._armed <= 0 or self._active or self._throttled:
                return
            out_dir = self._out_dir
            self._active = True
        try:
            import torch
            from torch.profiler import ProfilerActivity, profile

            activities = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(ProfilerActivity.CUDA)
            os.makedirs(out_dir, exist_ok=True)  # type: ignore[arg-type]
            prof = profile(activities=activities)
            prof.start()
            self._prof = prof
        except Exception as e:  # noqa: BLE001 -- profiling must never fail a tick
            with self._lock:
                self._active = False
                self._armed = 0
            self.errors += 1
            PROFILER_ARMED.set(0.0)
            PROFILER_CAPTURES.inc(outcome="error")
            self.log.warning("profiler start failed", error=str(e)[:200])

    def on_tick_end(self) -> None:
        with self._lock:
            if not self._active:
                return
            self._armed -= 1
            finish = self._armed <= 0 or self._throttled
            if not finish:
                PROFILER_ARMED.set(float(self._armed))
                return
            self._active = False
            out_dir = self._out_dir
        prof, self._prof = self._prof, None
        try:
            prof.stop()
            prof.export_chrome_trace(os.path.join(out_dir, TRACE_FILE))
            self.captures += 1
            self.last_trace_dir = out_dir
            PROFILER_CAPTURES.inc(outcome="ok")
            self.log.info("profiler capture written", dir=out_dir)
        except Exception as e:  # noqa: BLE001
            self.errors += 1
            PROFILER_CAPTURES.inc(outcome="error")
            self.log.warning("profiler stop failed", error=str(e)[:200])
        PROFILER_ARMED.set(float(max(0, self._armed)))

    def describe(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "armed_ticks": self._armed,
                "active": self._active,
                "out_dir": self._out_dir,
                "captures": self.captures,
                "errors": self.errors,
                "last_trace_dir": self.last_trace_dir,
            }

    def reset(self) -> None:
        with self._lock:
            self._armed = 0
            self._active = False
            self._out_dir = None
        self.captures = 0
        self.errors = 0
        self.last_trace_dir = None
        PROFILER_ARMED.set(0.0)


# process-wide capture handle (the same policy shape as tracing.TRACER)
PROFILER = ProfilerCapture()
