"""Instance-type catalog provider.

Rebuilds pkg/providers/instancetype/instancetype.go:

- raw catalog polled from the compute API on a 12h cadence
  (UpdateInstanceTypes :239-277, UpdateInstanceTypeOfferings :279-328,
  driven by the providers/instancetype controller)
- List(nodeclass) returns resolved InstanceTypes, memoized under a composite
  cache key of every upstream seqnum + the nodeclass spec hash
  (cacheKey :225-237) -- the load-bearing cache-invalidation economy: any
  ICE marking, price refresh, catalog poll, or nodeclass change rotates the
  key, and nothing else does
- discovered-capacity feedback: actual node memory observed at registration
  overrides the computed estimate (UpdateInstanceTypeCapacityFromNode
  :330-355), fixing the VM-overhead guess per (instance type, image)

Copy of karpenter_tpu/providers/instancetype/provider.py, imports rewritten to the port's.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence

from karpenter_tpu_torch.apis import labels as wk
from karpenter_tpu_torch.apis.nodeclass import TPUNodeClass
from karpenter_tpu_torch.cache import INSTANCE_TYPES_AND_OFFERINGS_TTL, TTLCache
from karpenter_tpu_torch.cache.ttl import Clock
from karpenter_tpu_torch.cache.unavailable_offerings import UnavailableOfferings
from karpenter_tpu_torch.cloud.api import ComputeAPI
from karpenter_tpu_torch.cloud.types import InstanceTypeInfo
from karpenter_tpu_torch.providers.instancetype.offerings import OfferingsBuilder
from karpenter_tpu_torch.providers.instancetype.types import InstanceType, Resolver
from karpenter_tpu_torch.scheduling import Resources
from karpenter_tpu_torch.scheduling import resources as res


class InstanceTypeProvider:
    def __init__(
        self,
        compute_api: ComputeAPI,
        resolver: Resolver,
        offerings: OfferingsBuilder,
        unavailable: UnavailableOfferings,
        clock: Optional[Clock] = None,
    ):
        self.compute_api = compute_api
        self.resolver = resolver
        self.offerings = offerings
        self.unavailable = unavailable
        self._lock = threading.Lock()
        self._infos: List[InstanceTypeInfo] = []
        self._zonal_offerings: Dict[str, List[str]] = {}
        self.instance_types_seq = 0
        self.offerings_seq = 0
        self._cache = TTLCache(INSTANCE_TYPES_AND_OFFERINGS_TTL, clock)
        # (instance_type, image_id) -> observed memory bytes
        self._discovered_memory: Dict[tuple, float] = {}
        self._discovered_seq = 0

    # -- refresh loop (12h controller cadence) ------------------------------
    def update_instance_types(self) -> None:
        infos = self.compute_api.describe_instance_types()
        with self._lock:
            if [i.name for i in infos] != [i.name for i in self._infos]:
                self.instance_types_seq += 1
            self._infos = infos

    def update_instance_type_offerings(self) -> None:
        zonal = self.compute_api.describe_instance_type_offerings()
        with self._lock:
            if zonal != self._zonal_offerings:
                self.offerings_seq += 1
            self._zonal_offerings = zonal

    def update_capacity_from_node(self, instance_type: str, image_id: str, memory_bytes: float) -> None:
        key = (instance_type, image_id)
        with self._lock:
            if self._discovered_memory.get(key) != memory_bytes:
                self._discovered_memory[key] = memory_bytes
                self._discovered_seq += 1

    # -- the catalog read (hot path input) ----------------------------------
    def _cache_key(self, nodeclass: TPUNodeClass) -> tuple:
        k = nodeclass.kubelet
        kubelet_key = (
            k.max_pods,
            k.pods_per_core,
            tuple(sorted(k.kube_reserved.items())),
            tuple(sorted(k.system_reserved.items())),
            tuple(sorted(k.eviction_hard.items())),
            tuple(sorted(k.eviction_soft.items())),
        )
        return (
            nodeclass.name,
            nodeclass.static_hash(),
            nodeclass.uid,
            tuple(sorted(s.zone for s in nodeclass.status_subnets)),
            tuple(sorted(i.id for i in nodeclass.status_images)),
            tuple(sorted((cr.id, cr.available_count) for cr in nodeclass.status_capacity_reservations)),
            self.instance_types_seq,
            self.offerings_seq,
            self.unavailable.seq_num,
            self.offerings.pricing.seq_num,
            getattr(self.offerings.capacity_reservations, "seq_num", 0),
            self._discovered_seq,
            kubelet_key,
        )

    def list(self, nodeclass: TPUNodeClass) -> List[InstanceType]:
        if not self._infos:
            self.update_instance_types()
            self.update_instance_type_offerings()
        key = self._cache_key(nodeclass)
        cached, ok = self._cache.get(key)
        if ok:
            return cached
        # Offerings exist only in zones with a resolved subnet: a nodeclass
        # whose subnet discovery is pending/empty yields no launchable
        # offerings (and thus no instance types), never all-zones.
        allowed_zones = {s.zone for s in nodeclass.status_subnets}
        with self._lock:
            infos = list(self._infos)
            zonal = dict(self._zonal_offerings)

        def offerings_for(info: InstanceTypeInfo):
            zones = zonal.get(info.name)
            if zones is not None:
                info_zones = tuple(z for z in info.zones if z in zones)
            else:
                info_zones = info.zones
            scoped = info if info_zones == info.zones else _with_zones(info, info_zones)
            return self.offerings.build(scoped, nodeclass, allowed_zones=allowed_zones)

        items = self.resolver.resolve(infos, nodeclass, offerings_for)
        # apply discovered true capacity
        for it in items:
            for img in nodeclass.status_images:
                mem = self._discovered_memory.get((it.name, img.id))
                if mem is not None:
                    it.capacity = Resources.from_base_units(
                        {**{k: v for k, v in it.capacity.items()}, res.MEMORY: mem}
                    )
                    it._alloc_cache = None  # capacity changed: drop the memo
                    break
        self._cache.set(key, items)
        from karpenter_tpu_torch import metrics

        metrics.INSTANCE_TYPE_COUNT.set(
            sum(1 for it in items if it.available_offerings()), nodeclass=nodeclass.name
        )
        return items


def _with_zones(info: InstanceTypeInfo, zones) -> InstanceTypeInfo:
    import dataclasses

    return dataclasses.replace(info, zones=tuple(zones))
