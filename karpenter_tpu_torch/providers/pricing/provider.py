"""Pricing provider.

Rebuilds pkg/providers/pricing/pricing.go:43-101: an on-demand price map from
the pricing API and a zonal spot price map from spot price history, refreshed
periodically (12h cadence driven by the pricing controller), with **static
fallback tables** compiled into the build (the reference ships
zz_generated.pricing_*.go; ours come from the deterministic catalog pipeline
in gen_catalog.py) so prices exist before the first API refresh and after
restarts.

Copy of karpenter_tpu/providers/pricing/provider.py, imports rewritten to the port's.
"""
from __future__ import annotations

import threading
from typing import Dict, Optional, Tuple

from karpenter_tpu_torch.cloud.api import ComputeAPI, PricingAPI
from karpenter_tpu_torch.providers.instancetype import gen_catalog


def static_on_demand_table() -> Dict[str, float]:
    return {it.name: gen_catalog.on_demand_price(it) for it in gen_catalog.generate_instance_types()}


def static_spot_table() -> Dict[Tuple[str, str], float]:
    out = {}
    for it in gen_catalog.generate_instance_types():
        if "spot" in it.supported_usage_classes:
            for z in it.zones:
                out[(it.name, z)] = gen_catalog.spot_price(it, z)
    return out


class PricingProvider:
    def __init__(self, pricing_api: Optional[PricingAPI], compute_api: Optional[ComputeAPI], region: str):
        self._pricing_api = pricing_api
        self._compute_api = compute_api
        self.region = region
        self._lock = threading.Lock()
        self._od: Dict[str, float] = static_on_demand_table()
        self._spot: Dict[Tuple[str, str], float] = static_spot_table()
        self.seq_num = 0

    # -- queries (hot path; lock-free reads of replaced dicts) --------------
    def on_demand_price(self, instance_type: str) -> Tuple[float, bool]:
        p = self._od.get(instance_type)
        return (p, True) if p is not None else (0.0, False)

    def spot_price(self, instance_type: str, zone: str) -> Tuple[float, bool]:
        p = self._spot.get((instance_type, zone))
        return (p, True) if p is not None else (0.0, False)

    def on_demand_types(self):
        return list(self._od)

    def spot_keys(self):
        return list(self._spot)

    # -- refresh (pricing controller, 12h cadence) --------------------------
    def update_on_demand_pricing(self) -> None:
        if self._pricing_api is None:
            return
        fresh = self._pricing_api.on_demand_prices()
        if not fresh:
            return
        with self._lock:
            merged = dict(self._od)
            merged.update(fresh)
            self._od = merged
            self.seq_num += 1

    def snapshot_hash(self) -> str:
        """Content hash of both price tables: the refresh controller logs
        'pricing updated' only when this changes (seq_num bumps on every
        refresh regardless of content, so it cannot drive the dedup)."""
        import hashlib

        with self._lock:
            h = hashlib.blake2b(digest_size=8)
            for k in sorted(self._od):
                h.update(f"{k}={self._od[k]};".encode())
            for k in sorted(self._spot):
                h.update(f"{k}={self._spot[k]};".encode())
        return h.hexdigest()

    def update_spot_pricing(self) -> None:
        if self._compute_api is None:
            return
        fresh = self._compute_api.spot_price_history()
        if not fresh:
            return
        with self._lock:
            merged = dict(self._spot)
            merged.update(fresh)
            self._spot = merged
            self.seq_num += 1
