"""Capacity-reservation provider.

Rebuilds pkg/providers/capacityreservation/provider.go:34-125 + types.go:
discovery of on-demand capacity reservations plus *in-memory availability
bookkeeping* between cloud refreshes -- MarkLaunched / MarkTerminated /
MarkUnavailable adjust the usable count immediately so back-to-back launches
don't oversubscribe a reservation while the describe cache is stale.

Copy of karpenter_tpu/providers/capacityreservation/provider.py, imports rewritten to the port's.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional

from karpenter_tpu_torch.cache import CAPACITY_RESERVATION_TTL, TTLCache
from karpenter_tpu_torch.cache.ttl import Clock
from karpenter_tpu_torch.cloud.api import ComputeAPI
from karpenter_tpu_torch.cloud.types import CapacityReservationInfo


class CapacityReservationProvider:
    def __init__(self, compute_api: ComputeAPI, clock: Optional[Clock] = None):
        self.compute_api = compute_api
        self.clock = clock or Clock()
        self._cache = TTLCache(CAPACITY_RESERVATION_TTL, clock)
        self._lock = threading.Lock()
        # reservation id -> delta vs the last describe (negative = consumed)
        self._deltas: Dict[str, int] = {}
        self._unavailable: Dict[str, float] = {}  # id -> marked-at
        # rotates catalog cache keys: reserved offering availability changes
        # with every launch/termination and must never be served stale
        # (reference: offering.go:161-168 injects reserved offerings fresh)
        self.seq_num = 0

    def list(self) -> List[CapacityReservationInfo]:
        def fetch():
            with self._lock:
                # fresh counts supersede in-memory adjustments AND transient
                # exhaustion marks ("zero it until refresh")
                self._deltas.clear()
                self._unavailable.clear()
            return self.compute_api.describe_capacity_reservations()

        return self._cache.get_or_compute("all", fetch)

    def available_count(self, reservation_id: str, described_count: int) -> int:
        with self._lock:
            if reservation_id in self._unavailable:
                return 0
            return max(0, described_count + self._deltas.get(reservation_id, 0))

    def mark_launched(self, reservation_id: str) -> None:
        with self._lock:
            self._deltas[reservation_id] = self._deltas.get(reservation_id, 0) - 1
            self.seq_num += 1

    def mark_terminated(self, reservation_id: str) -> None:
        with self._lock:
            self._deltas[reservation_id] = self._deltas.get(reservation_id, 0) + 1
            self.seq_num += 1

    def mark_unavailable(self, reservation_id: str) -> None:
        """Launch said the reservation is exhausted: zero it until refresh."""
        with self._lock:
            self._unavailable[reservation_id] = self.clock.now()
            self.seq_num += 1

    def flush(self) -> None:
        self._cache.flush()
        with self._lock:
            self._deltas.clear()
            self._unavailable.clear()
            self.seq_num += 1
