"""TTL cache with injectable clock.

Equivalent role to the patrickmn/go-cache instances the reference threads
through every provider (constructed in pkg/operator/operator.go:126-186).
Clock injection mirrors the reference's clock.Clock so tests can step time.

Copy of karpenter_tpu/cache/ttl.py, imports rewritten to the port's.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, Iterator, Optional, Tuple


class Clock:
    """Real clock; tests substitute FakeClock."""

    def now(self) -> float:
        return time.time()


class FakeClock(Clock):
    def __init__(self, start: float = 0.0):
        self._t = start

    def now(self) -> float:
        return self._t

    def step(self, seconds: float) -> None:
        self._t += seconds

    def set(self, t: float) -> None:
        self._t = t


class TTLCache:
    def __init__(self, default_ttl: float, clock: Optional[Clock] = None):
        self._ttl = default_ttl
        self._clock = clock or Clock()
        self._lock = threading.Lock()
        self._d: Dict[Any, Tuple[Any, float]] = {}  # key -> (value, expires_at)

    def set(self, key: Any, value: Any, ttl: Optional[float] = None) -> None:
        exp = self._clock.now() + (self._ttl if ttl is None else ttl)
        with self._lock:
            self._d[key] = (value, exp)

    def get(self, key: Any) -> Tuple[Any, bool]:
        with self._lock:
            entry = self._d.get(key)
            if entry is None:
                return None, False
            value, exp = entry
            if self._clock.now() >= exp:
                del self._d[key]
                return None, False
            return value, True

    def get_or_compute(self, key: Any, fn: Callable[[], Any], ttl: Optional[float] = None) -> Any:
        value, ok = self.get(key)
        if ok:
            return value
        value = fn()
        self.set(key, value, ttl)
        return value

    def delete(self, key: Any) -> None:
        with self._lock:
            self._d.pop(key, None)

    def flush(self) -> None:
        with self._lock:
            self._d.clear()

    def items(self) -> Iterator[Tuple[Any, Any]]:
        now = self._clock.now()
        with self._lock:
            return iter([(k, v) for k, (v, exp) in self._d.items() if now < exp])

    def __len__(self) -> int:
        now = self._clock.now()
        with self._lock:
            return sum(1 for _, exp in self._d.values() if now < exp)
