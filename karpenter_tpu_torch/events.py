"""Event recorder.

The reference emits k8s Events through an events.Recorder for every notable
lifecycle action (pkg/cloudprovider/events/events.go,
pkg/controllers/interruption/events/events.go). This in-memory recorder
keeps the same shape: typed events attached to objects, deduplicated within
a window, queryable by tests.

Copy of karpenter_tpu/events.py, imports rewritten to the port's.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import List, Optional

from karpenter_tpu_torch.cache.ttl import Clock

NORMAL = "Normal"
WARNING = "Warning"


@dataclass
class Event:
    kind: str            # object kind
    name: str            # object name
    type: str            # Normal | Warning
    reason: str
    message: str
    timestamp: float = 0.0
    count: int = 1


class Recorder:
    # retained-event cap: the recorder is an in-memory ring, not a durable
    # sink (the reference's Events go to the apiserver with its own GC);
    # pruning drops the OLDEST half so recent history stays queryable
    MAX_EVENTS = 4096

    def __init__(self, clock: Optional[Clock] = None, dedupe_window: float = 60.0):
        self.clock = clock or Clock()
        self.dedupe_window = dedupe_window
        self._lock = threading.Lock()
        self.events: List[Event] = []
        # dedupe index keyed by identity, not a tail scan: a tick that
        # publishes >window-size distinct events must still coalesce each
        # of them with its own previous occurrence next tick
        self._recent: dict = {}

    def publish(self, obj, reason: str, message: str = "", type: str = NORMAL) -> None:
        event_type = type
        kind = getattr(obj, "KIND", "Object")
        name = getattr(obj, "name", str(obj))
        now = self.clock.now()
        key = (kind, name, reason, message)
        with self._lock:
            e = self._recent.get(key)
            if e is not None and now - e.timestamp < self.dedupe_window:
                # identical events coalesce; a CHANGED message under the
                # same reason (e.g. an unschedulable pod's cause moving
                # from a missing claim to no-capacity) keys differently
                # and records fresh -- suppressing it would hide the new
                # cause for the whole window
                e.count += 1
                return
            e = Event(kind=kind, name=name, type=event_type, reason=reason, message=message, timestamp=now)
            self.events.append(e)
            self._recent[key] = e
            if len(self.events) > self.MAX_EVENTS:
                self.events = self.events[self.MAX_EVENTS // 2:]
                kept = set(map(id, self.events))
                self._recent = {k: v for k, v in self._recent.items() if id(v) in kept}

    def for_object(self, obj) -> List[Event]:
        name = getattr(obj, "name", str(obj))
        return [e for e in self.events if e.name == name]

    def with_reason(self, reason: str) -> List[Event]:
        return [e for e in self.events if e.reason == reason]
