"""Cluster-version provider.

Rebuilds pkg/providers/version/version.go:47-147: discover the control
plane's Kubernetes version (TTL-cached), validate it against the supported
window, and expose it to consumers (bootstrap rendering, image aliases).
Outside the window the provider still returns the discovered version --
the reference logs/flags rather than failing provisioning -- but records
the validation message for the operator's status surface.

Copy of karpenter_tpu/providers/version/provider.py, imports rewritten to the port's.
"""
from __future__ import annotations

import re
from typing import Optional, Tuple

from karpenter_tpu_torch.cache.ttl import Clock, TTLCache
from karpenter_tpu_torch.cloud.api import ClusterAPI

VERSION_CACHE_TTL = 15 * 60.0   # reference polls the control plane on a cadence
MIN_SUPPORTED = (1, 26)
MAX_SUPPORTED = (1, 33)

_VERSION_RE = re.compile(r"^v?(\d+)\.(\d+)")


def parse_version(v: str) -> Optional[Tuple[int, int]]:
    m = _VERSION_RE.match(v.strip())
    if not m:
        return None
    return int(m.group(1)), int(m.group(2))


class VersionProvider:
    def __init__(self, cluster_api: ClusterAPI, clock: Optional[Clock] = None):
        self.cluster_api = cluster_api
        self._cache = TTLCache(VERSION_CACHE_TTL, clock)
        self.validation_message: str = ""

    def get(self) -> str:
        """The cluster's '<major>.<minor>' version, cached."""
        return self._cache.get_or_compute("version", self._discover)

    def _discover(self) -> str:
        raw = self.cluster_api.cluster_version()
        parsed = parse_version(raw)
        if parsed is None:
            self.validation_message = f"unparseable cluster version {raw!r}"
            return raw
        if parsed < MIN_SUPPORTED:
            self.validation_message = (
                f"cluster version {raw} below minimum supported {MIN_SUPPORTED[0]}.{MIN_SUPPORTED[1]}"
            )
        elif parsed > MAX_SUPPORTED:
            self.validation_message = (
                f"cluster version {raw} above maximum validated {MAX_SUPPORTED[0]}.{MAX_SUPPORTED[1]}"
            )
        else:
            self.validation_message = ""
        return f"{parsed[0]}.{parsed[1]}"

    def supported(self) -> bool:
        self.get()
        return self.validation_message == ""

    def invalidate(self) -> None:
        self._cache.delete("version")
