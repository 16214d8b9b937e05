"""Offering construction.

Rebuilds pkg/providers/instancetype/offering/offering.go:68-187:

- spot/on-demand offerings priced from the pricing provider and marked
  unavailable when the ICE cache or the zone/usage-class data says so;
  cacheable (keyed by seqnums upstream)
- reserved offerings injected *fresh on every call* because reservation
  available-counts change with every launch/termination
  (offering.go:161-168: cached state would go stale immediately); reserved
  price uses the reference's ordering trick: on-demand price / 10^7, so any
  reserved offering always sorts cheaper than any spot/od offering while
  preserving relative order between reservations of different types.

Copy of karpenter_tpu/providers/instancetype/offerings.py, imports rewritten to the port's.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

from karpenter_tpu_torch.apis import labels as wk
from karpenter_tpu_torch.apis.nodeclass import TPUNodeClass
from karpenter_tpu_torch.cache.unavailable_offerings import UnavailableOfferings
from karpenter_tpu_torch.cloud.types import InstanceTypeInfo
from karpenter_tpu_torch.providers.instancetype.types import Offering
from karpenter_tpu_torch.providers.pricing.provider import PricingProvider

RESERVED_PRICE_DIVISOR = 1e7


class OfferingsBuilder:
    def __init__(
        self,
        pricing: PricingProvider,
        unavailable: UnavailableOfferings,
        zone_ids: Dict[str, str],
        capacity_reservations=None,  # CapacityReservationProvider, optional
    ):
        self.pricing = pricing
        self.unavailable = unavailable
        self.zone_ids = zone_ids
        self.capacity_reservations = capacity_reservations

    def build(
        self,
        info: InstanceTypeInfo,
        nodeclass: TPUNodeClass,
        allowed_zones: Optional[Sequence[str]] = None,
    ) -> List[Offering]:
        """All offerings for one instance type, respecting the nodeclass's
        resolved subnets (zones) and reservation selectors."""
        zones = [z for z in info.zones if allowed_zones is None or z in allowed_zones]
        out: List[Offering] = []
        for zone in zones:
            zone_id = self.zone_ids.get(zone, zone)
            if "on-demand" in info.supported_usage_classes:
                price, ok = self.pricing.on_demand_price(info.name)
                if ok:
                    out.append(
                        Offering(
                            capacity_type=wk.CAPACITY_TYPE_ON_DEMAND,
                            zone=zone,
                            zone_id=zone_id,
                            price=price,
                            available=not self.unavailable.is_unavailable(
                                info.name, zone, wk.CAPACITY_TYPE_ON_DEMAND
                            ),
                        )
                    )
            if "spot" in info.supported_usage_classes:
                price, ok = self.pricing.spot_price(info.name, zone)
                if ok:
                    out.append(
                        Offering(
                            capacity_type=wk.CAPACITY_TYPE_SPOT,
                            zone=zone,
                            zone_id=zone_id,
                            price=price,
                            available=not self.unavailable.is_unavailable(
                                info.name, zone, wk.CAPACITY_TYPE_SPOT
                            ),
                        )
                    )
        # reserved: fresh per call, from the nodeclass's resolved reservations.
        # A reservation only yields an offering if the type is actually offered
        # in its zone AND a subnet resolves there (reference checks
        # itZones.Has(reservation.AvailabilityZone), offering.go:180) --
        # otherwise the price-floor trick would pin the scheduler on an
        # unlaunchable offering.
        for cr in nodeclass.status_capacity_reservations:
            if cr.instance_type != info.name or cr.state != "active":
                continue
            if cr.zone not in info.zones:
                continue
            if allowed_zones is not None and cr.zone not in allowed_zones:
                continue
            od_price, ok = self.pricing.on_demand_price(info.name)
            price = (od_price if ok else 1.0) / RESERVED_PRICE_DIVISOR
            count = cr.available_count
            if self.capacity_reservations is not None:
                count = self.capacity_reservations.available_count(cr.id, cr.available_count)
            out.append(
                Offering(
                    capacity_type=wk.CAPACITY_TYPE_RESERVED,
                    zone=cr.zone,
                    zone_id=self.zone_ids.get(cr.zone, cr.zone),
                    price=price,
                    available=count > 0
                    and not self.unavailable.is_unavailable(info.name, cr.zone, wk.CAPACITY_TYPE_RESERVED),
                    reservation_id=cr.id,
                    reservation_capacity=count,
                )
            )
        return out
