"""Security-group discovery by selector terms
(reference: pkg/providers/securitygroup/securitygroup.go:1-139).

Copy of karpenter_tpu/providers/securitygroup/provider.py, imports rewritten to the port's.
"""
from __future__ import annotations

from typing import List, Optional

from karpenter_tpu_torch.apis.nodeclass import TPUNodeClass
from karpenter_tpu_torch.cache import SECURITY_GROUPS_TTL, TTLCache
from karpenter_tpu_torch.cache.ttl import Clock
from karpenter_tpu_torch.cloud.api import ComputeAPI
from karpenter_tpu_torch.cloud.types import SecurityGroupInfo


class SecurityGroupProvider:
    def __init__(self, compute_api: ComputeAPI, clock: Optional[Clock] = None):
        self.compute_api = compute_api
        self._cache = TTLCache(SECURITY_GROUPS_TTL, clock)

    def list(self, nodeclass: TPUNodeClass) -> List[SecurityGroupInfo]:
        key = tuple(
            (tuple(sorted(t.tags.items())), t.id, t.name) for t in nodeclass.security_group_selector_terms
        )

        def fetch():
            groups = self.compute_api.describe_security_groups()
            return [
                g
                for g in groups
                if any(t.matches(id=g.id, name=g.name, tags=g.tags) for t in nodeclass.security_group_selector_terms)
            ]

        return self._cache.get_or_compute(key, fetch)
