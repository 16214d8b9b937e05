"""Parameter-store provider: TTL-cached parameter resolution.

Rebuilds pkg/providers/ssm/provider.go:1-63: get-parameter with a long TTL
cache (image alias resolution is the hot consumer), plus the invalidation
contract the ssm/invalidation controller drives
(pkg/controllers/providers/ssm/invalidation/controller.go:55-89): drop
cached entries whose resolved value no longer exists upstream so new
launches re-resolve fresh values.

Copy of karpenter_tpu/providers/params/provider.py, imports rewritten to the port's.
"""
from __future__ import annotations

from typing import Any, Iterable, List, Optional, Tuple

from karpenter_tpu_torch.cache import SSM_CACHE_TTL, TTLCache
from karpenter_tpu_torch.cache.ttl import Clock
from karpenter_tpu_torch.cloud.api import ParamStoreAPI


class ParamStoreProvider:
    def __init__(self, params_api: ParamStoreAPI, clock: Optional[Clock] = None, ttl: float = SSM_CACHE_TTL):
        self.params_api = params_api
        self._cache = TTLCache(ttl, clock)

    def get(self, name: str) -> Optional[str]:
        """Resolve a parameter through the cache. Misses (None) are cached
        too -- the reference caches the NotFound result so a bad alias does
        not hammer the API every reconcile."""
        return self._cache.get_or_compute(name, lambda: self.params_api.get_parameter(name))

    def items(self) -> Iterable[Tuple[Any, Any]]:
        return self._cache.items()

    def delete(self, name: str) -> None:
        self._cache.delete(name)

    def flush(self) -> None:
        self._cache.flush()

    def invalidate_missing(self, live_values, keys=None) -> int:
        """Drop entries whose cached value is not in the live set; returns
        the number dropped (the ssm-invalidation controller's contract).
        `keys` scopes the sweep: the param store is shared by consumers
        whose values are not image ids, and an unscoped sweep would evict
        their entries on every reconcile."""
        stale = 0
        for key, value in list(self._cache.items()):
            if keys is not None and key not in keys:
                continue
            if value is not None and value not in live_values:
                self._cache.delete(key)
                stale += 1
        return stale
