"""Subnet provider.

Rebuilds pkg/providers/subnet/subnet.go: selector-term discovery, zonal
subnet choice for launch preferring the most free IPs
(ZonalSubnetsForLaunch :135-182), and in-flight IP bookkeeping so rapid
launches don't oversubscribe a subnet before the cloud reports usage
(UpdateInflightIPs :184-240).

Copy of karpenter_tpu/providers/subnet/provider.py, imports rewritten to the port's.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional

from karpenter_tpu_torch.apis.nodeclass import TPUNodeClass
from karpenter_tpu_torch.cache import SUBNETS_TTL, TTLCache
from karpenter_tpu_torch.cache.ttl import Clock
from karpenter_tpu_torch.cloud.api import ComputeAPI
from karpenter_tpu_torch.cloud.types import SubnetInfo


class SubnetProvider:
    def __init__(self, compute_api: ComputeAPI, clock: Optional[Clock] = None):
        self.compute_api = compute_api
        self._cache = TTLCache(SUBNETS_TTL, clock)
        self._lock = threading.Lock()
        self._inflight: Dict[str, int] = {}  # subnet id -> ips consumed in-flight

    def list(self, nodeclass: TPUNodeClass) -> List[SubnetInfo]:
        key = tuple(
            (tuple(sorted(t.tags.items())), t.id, t.name) for t in nodeclass.subnet_selector_terms
        )

        def fetch():
            all_subnets = self.compute_api.describe_subnets()
            return [
                s
                for s in all_subnets
                if any(t.matches(id=s.id, name=s.tags.get("Name", ""), tags=s.tags) for t in nodeclass.subnet_selector_terms)
            ]

        return self._cache.get_or_compute(key, fetch)

    def zonal_subnets_for_launch(self, nodeclass: TPUNodeClass, zones: Optional[set] = None) -> Dict[str, SubnetInfo]:
        """One subnet per zone, preferring most free IPs (minus in-flight)."""
        out: Dict[str, SubnetInfo] = {}
        with self._lock:
            for s in self.list(nodeclass):
                if zones is not None and s.zone not in zones:
                    continue
                effective = s.available_ip_count - self._inflight.get(s.id, 0)
                if effective <= 0:
                    continue
                cur = out.get(s.zone)
                if cur is None or effective > (cur.available_ip_count - self._inflight.get(cur.id, 0)):
                    out[s.zone] = s
        return out

    def mark_inflight(self, subnet_id: str, count: int = 1) -> None:
        with self._lock:
            self._inflight[subnet_id] = self._inflight.get(subnet_id, 0) + count

    def sync_inflight(self) -> None:
        """Fresh describe supersedes in-flight estimates."""
        with self._lock:
            self._inflight.clear()
        self._cache.flush()
