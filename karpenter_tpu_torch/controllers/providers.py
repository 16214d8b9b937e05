"""Provider-refresh controllers.

Rebuilds the periodic refresh reconcilers of pkg/controllers/providers/:
- instancetype: 12h catalog + offerings refresh (controller.go:43-59)
- instancetype/capacity: learn true node memory from registered nodes
  (capacity/controller.go:1-133)
- pricing: 12h on-demand + spot refresh (pricing/controller.go:43-59)
- version: periodic cluster-version discovery (version/controller.go)
- ssm invalidation: drop image-alias cache entries when images churn
  (ssm/invalidation/controller.go:55-89)
- capacityreservation/expiration + capacitytype: expire capacity blocks and
  flip reserved claims to on-demand when their reservation lapses
  (capacityreservation/*.go)

Copy of karpenter_tpu/controllers/providers.py, imports rewritten to the port's.
"""
from __future__ import annotations

from typing import Optional

from karpenter_tpu_torch.apis import NodeClaim, Node, TPUNodeClass, labels as wk
from karpenter_tpu_torch.cache.ttl import Clock
from karpenter_tpu_torch.kwok.cluster import Cluster
from karpenter_tpu_torch.logging import ChangeMonitor, get_logger

REFRESH_INTERVAL = 12 * 3600.0


class _Periodic:
    def __init__(self, clock: Clock, interval: float = REFRESH_INTERVAL):
        self.clock = clock
        self.interval = interval
        self._last: Optional[float] = None

    def due(self) -> bool:
        now = self.clock.now()
        if self._last is None or now - self._last >= self.interval:
            self._last = now
            return True
        return False


class InstanceTypeRefreshController(_Periodic):
    log = get_logger("providers.instancetype")

    def __init__(self, provider, clock: Clock, interval: float = REFRESH_INTERVAL):
        super().__init__(clock, interval)
        self.provider = provider
        self.monitor = ChangeMonitor()  # per-instance dedup state

    def reconcile(self) -> bool:
        if not self.due():
            return False
        self.provider.update_instance_types()
        self.provider.update_instance_type_offerings()
        # log only when the catalog actually changed (reference dedupes the
        # same message with a ChangeMonitor, instancetype.go:267-271); the
        # provider's seq counters bump only on observed change
        seq = (self.provider.instance_types_seq, self.provider.offerings_seq)
        if self.monitor.has_changed("catalog", seq):
            self.log.info(
                "instance types updated",
                instance_types_seq=seq[0], offerings_seq=seq[1],
            )
        return True


class PricingRefreshController(_Periodic):
    log = get_logger("providers.pricing")

    def __init__(self, pricing, clock: Clock, interval: float = REFRESH_INTERVAL):
        super().__init__(clock, interval)
        self.pricing = pricing
        self.monitor = ChangeMonitor()  # per-instance dedup state

    def reconcile(self) -> bool:
        if not self.due():
            return False
        self.pricing.update_on_demand_pricing()
        self.pricing.update_spot_pricing()
        snapshot = self.pricing.snapshot_hash()
        if self.monitor.has_changed("pricing", snapshot):
            self.log.info("pricing updated", snapshot=snapshot)
        return True


class DiscoveredCapacityController:
    """Learns actual (instance type, image) memory from registered nodes
    into the catalog provider's discovered-capacity cache."""

    def __init__(self, cluster: Cluster, instance_types):
        self.cluster = cluster
        self.instance_types = instance_types

    def reconcile_all(self) -> int:
        from karpenter_tpu_torch.scheduling import resources as res

        updated = 0
        for node in self.cluster.list(Node):
            if not node.ready:
                continue
            claim = self.cluster.nodeclaim_for_node(node)
            if claim is None or not claim.image_id:
                continue
            itype = node.instance_type
            mem = node.capacity.get(res.MEMORY)
            if itype and mem:
                self.instance_types.update_capacity_from_node(itype, claim.image_id, mem)
                updated += 1
        return updated


class VersionController(_Periodic):
    """Periodic cluster-version refresh through the version provider
    (reference: providers/version/controller.go drives version.Provider)."""

    def __init__(self, version_provider, clock: Clock, interval: float = 5 * 60.0):
        super().__init__(clock, interval)
        self.version_provider = version_provider

    @property
    def version(self) -> str:
        return self.version_provider.get()

    def reconcile(self) -> bool:
        if not self.due():
            return False
        self.version_provider.invalidate()
        self.version_provider.get()
        return True


class ImageCacheInvalidationController:
    """Drops the param-store (image alias) cache when resolved images no
    longer exist upstream, so new launches pick fresh images."""

    def __init__(self, images, compute_api):
        self.images = images
        self.compute_api = compute_api

    def reconcile(self) -> int:
        live = {i.id for i in self.compute_api.describe_images()}
        return self.images.invalidate_missing(live)


class CapacityTypeController:
    """Flips claims on expired/vanished reservations to on-demand accounting
    (reference: capacityreservation/capacitytype/controller.go:1-157).
    Expiry is judged directly against the cloud's reservation list -- by the
    time this runs, the nodeclass controller may already have scrubbed the
    lapsed entry from status, so status cannot be the source of truth."""

    def __init__(self, cluster: Cluster, reservations):
        self.cluster = cluster
        self.reservations = reservations  # CapacityReservationProvider (cached)

    def reconcile_all(self) -> int:
        now = self.cluster.clock.now()
        flipped = 0
        claims_with_reservation = [
            (claim, claim.metadata.labels.get(wk.LABEL_CAPACITY_RESERVATION_ID))
            for claim in self.cluster.list(NodeClaim)
        ]
        if not any(rid for _, rid in claims_with_reservation):
            return 0  # no reserved claims: skip the cloud read entirely
        live = {
            cr.id
            for cr in self.reservations.list()
            if cr.state == "active" and (cr.end_time is None or cr.end_time > now)
        }
        for claim, rid in claims_with_reservation:
            if rid and rid not in live:
                claim.metadata.labels[wk.CAPACITY_TYPE_LABEL] = wk.CAPACITY_TYPE_ON_DEMAND
                del claim.metadata.labels[wk.LABEL_CAPACITY_RESERVATION_ID]
                node = self.cluster.node_for_nodeclaim(claim)
                if node is not None:
                    node.metadata.labels[wk.CAPACITY_TYPE_LABEL] = wk.CAPACITY_TYPE_ON_DEMAND
                    node.metadata.labels.pop(wk.LABEL_CAPACITY_RESERVATION_ID, None)
                    self.cluster.update(node)
                self.cluster.update(claim)
                flipped += 1
        return flipped


# expiration lead: start draining capacity-block claims this long before the
# reservation's hard end so pods reschedule while capacity still exists
# (reference: capacityreservation/expiration/controller.go)
CAPACITY_BLOCK_EXPIRATION_LEAD = 10 * 60.0


class CapacityReservationExpirationController:
    """Initiates graceful NodeClaim deletion for capacity-BLOCK claims whose
    reservation is about to end (reference:
    capacityreservation/expiration/controller.go:1-135). Capacity blocks
    hard-reclaim their instances at end time, so waiting for the
    capacitytype flip (which handles default ODCRs) would strand pods; this
    controller drains ahead of the cliff instead."""

    def __init__(self, cluster: Cluster, reservations, lead: float = CAPACITY_BLOCK_EXPIRATION_LEAD):
        self.cluster = cluster
        self.reservations = reservations
        self.lead = lead

    def reconcile_all(self) -> int:
        now = self.cluster.clock.now()
        expiring_blocks = {
            cr.id: cr.end_time
            for cr in self.reservations.list()
            if cr.reservation_type == "capacity-block" and cr.end_time is not None
        }
        if not expiring_blocks:
            return 0
        expired = 0
        for claim in self.cluster.list(NodeClaim):
            if claim.deleting:
                continue
            rid = claim.metadata.labels.get(wk.LABEL_CAPACITY_RESERVATION_ID)
            end = expiring_blocks.get(rid)
            if end is not None and now >= end - self.lead:
                # cordon-and-drain via the termination flow
                self.cluster.delete(NodeClaim, claim.metadata.name)
                expired += 1
        return expired
