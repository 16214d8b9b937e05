"""UnavailableOfferings: the insufficient-capacity (ICE) negative cache.

Rebuilt from the reference's pkg/cache/unavailableofferings.go:33-107: three
TTL'd sub-caches -- per (instance-type, zone, capacity-type) offering, per
capacity-type, and per (zone, capacity-type) -- plus a monotonically
increasing SeqNum folded into catalog cache keys so every ICE change
invalidates cached instance-type lists
(reference: pkg/providers/instancetype/offering/offering.go:200-206).

Copy of karpenter_tpu/cache/unavailable_offerings.py, imports rewritten to the port's.
"""
from __future__ import annotations

import threading
from typing import Optional

from karpenter_tpu_torch.cache.ttl import Clock, TTLCache

DEFAULT_ICE_TTL = 3 * 60.0


class UnavailableOfferings:
    def __init__(self, clock: Optional[Clock] = None, ttl: float = DEFAULT_ICE_TTL):
        self._offerings = TTLCache(ttl, clock)
        self._capacity_types = TTLCache(ttl, clock)
        self._zonal = TTLCache(ttl, clock)
        self._lock = threading.Lock()
        self._seq = 0

    @property
    def seq_num(self) -> int:
        """Monotonic change counter, read under the SAME lock the marks
        bump it under: catalog cache keys fold this in, and a key must
        never pair a seqnum with a cache view from a different moment."""
        with self._lock:
            return self._seq

    # -- marking ------------------------------------------------------------
    # mark-and-bump is ATOMIC (one lock acquisition around both): with the
    # old two-step (unlocked set, then locked bump) a concurrent reader
    # could observe the bumped seqnum paired with the pre-mark cache view
    # -- computing a FRESH catalog key over STALE availability, which the
    # key would then cache until the next unrelated bump.
    def mark_unavailable(self, instance_type: str, zone: str, capacity_type: str, reason: str = "") -> None:
        with self._lock:
            self._offerings.set((instance_type, zone, capacity_type), reason or True)
            self._seq += 1

    def mark_capacity_type_unavailable(self, capacity_type: str) -> None:
        with self._lock:
            self._capacity_types.set(capacity_type, True)
            self._seq += 1

    def mark_az_unavailable(self, zone: str, capacity_type: str) -> None:
        with self._lock:
            self._zonal.set((zone, capacity_type), True)
            self._seq += 1

    # -- queries ------------------------------------------------------------
    def is_unavailable(self, instance_type: str, zone: str, capacity_type: str) -> bool:
        if self._capacity_types.get(capacity_type)[1]:
            return True
        if self._zonal.get((zone, capacity_type))[1]:
            return True
        return self._offerings.get((instance_type, zone, capacity_type))[1]

    def flush(self) -> None:
        with self._lock:
            self._offerings.flush()
            self._capacity_types.flush()
            self._zonal.flush()
            self._seq += 1
