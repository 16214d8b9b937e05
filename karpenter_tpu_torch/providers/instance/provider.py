"""Instance provider: launch / read / delete cloud instances.

Rebuilds pkg/providers/instance/instance.go:

- Create (:117-151): filter chain -> truncate to 60 -> ensure launch
  templates -> fleet call with overrides = available offerings x zonal
  subnets (:392-439), priced priorities for capacity-optimized-prioritized
- capacity-type decision reserved > spot > on-demand (:504-518)
- fleet error parsing into the ICE cache (:441-484)
- retry-once when the fleet call reports a stale launch template (:124-128)
- List by cluster tags for GC resync (:174-204)

Copy of karpenter_tpu/providers/instance/provider.py, imports rewritten to the port's.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

from karpenter_tpu_torch.apis import NodeClaim, labels as wk
from karpenter_tpu_torch.apis.nodeclass import TPUNodeClass
from karpenter_tpu_torch.cache.unavailable_offerings import UnavailableOfferings
from karpenter_tpu_torch.cloud.api import ComputeAPI
from karpenter_tpu_torch.cloud.types import CloudInstance, FleetOverride, FleetRequest
from karpenter_tpu_torch.errors import InsufficientCapacityError, NotFoundError, is_unfulfillable_capacity
from karpenter_tpu_torch.providers.instancetype.types import InstanceType
from karpenter_tpu_torch.providers.instance import filters
from karpenter_tpu_torch.providers.launchtemplate import LaunchTemplateProvider
from karpenter_tpu_torch.providers.subnet import SubnetProvider
from karpenter_tpu_torch.scheduling import Requirements

MAX_INSTANCE_TYPES = 60  # reference: instance.go:60

CLUSTER_TAG = "karpenter.tpu/cluster"
NODECLAIM_TAG = "karpenter.sh/nodeclaim"
NODEPOOL_TAG = wk.NODEPOOL_LABEL
# journal idempotency token, threaded from the claim (stamped by
# IntentJournal.begin_launch via this annotation) into the fleet call's
# client token -- an annotation rather than a create() parameter so the
# CloudProvider.create signature stays the reference's. ONE key shared
# with the instance tag (apis/objects.INTENT_TOKEN_KEY).
from karpenter_tpu_torch.apis.objects import INTENT_TOKEN_KEY as INTENT_TOKEN_ANNOTATION  # noqa: E402


class InstanceProvider:
    def __init__(
        self,
        compute_api: ComputeAPI,
        subnets: SubnetProvider,
        launch_templates: LaunchTemplateProvider,
        unavailable: UnavailableOfferings,
        capacity_reservations=None,
        cluster_name: str = "kwok-cluster",
        batchers=None,
        fence=None,
    ):
        self.compute_api = compute_api
        self.subnets = subnets
        self.launch_templates = launch_templates
        self.unavailable = unavailable
        self.capacity_reservations = capacity_reservations
        self.cluster_name = cluster_name
        # optional CloudBatchers (batcher/cloud.py): the reference always
        # routes fleet/describe/terminate through the window batcher
        # (instance.go uses ec2Batcher unconditionally); tests may pass None
        # to talk to the API directly
        self.batchers = batchers
        # optional fencing.Fence: every MUTATING cloud call below checks it
        # immediately before the wire, so a deposed leader's in-flight
        # fan-out fails closed (StaleFencingEpochError) instead of
        # split-braining against the new leader. None = unfenced (tests,
        # single-replica deployments without election).
        self.fence = fence

    @staticmethod
    def _cloud_seam(fn, *args):
        """Every batched cloud call crosses here: a failure OUTSIDE the
        CloudError taxonomy (a batcher executor fault fanning to its
        waiters, an emulator bug) is wrapped so callers' existing
        CloudError handling applies instead of the raw exception killing a
        whole controller sweep. KeyError passes through untouched -- it is
        the stale-launch-template signal _launch's retry contract needs."""
        from karpenter_tpu_torch.errors import CloudError

        try:
            return fn(*args)
        except (CloudError, KeyError):
            raise
        except Exception as e:  # noqa: BLE001
            raise CloudError(f"{type(e).__name__}: {e}") from e

    def _create_fleet(self, request: FleetRequest):
        if self.fence is not None:
            self.fence.check("create_fleet")
        if self.batchers is not None:
            return self._cloud_seam(self.batchers.create_fleet.call, request)
        return self.compute_api.create_fleet(request)

    def launch_window(self, expected: int):
        """Batching-window rendezvous for a fan-out of `expected` concurrent
        create() calls (no-op without batchers)."""
        from contextlib import nullcontext

        if self.batchers is None:
            return nullcontext()
        return self.batchers.create_fleet.batcher.window(expected)

    def _describe(self, ids: Sequence[str]):
        if self.batchers is not None:
            return self._cloud_seam(self.batchers.describe_instances.call, ids)
        return self.compute_api.describe_instances(ids)

    def _terminate(self, ids: Sequence[str]):
        if self.fence is not None:
            self.fence.check("terminate_instances")
        if self.batchers is not None:
            return self._cloud_seam(self.batchers.terminate_instances.call, ids)
        return self.compute_api.terminate_instances(ids)

    # -- create -------------------------------------------------------------
    def create(
        self,
        nodeclass: TPUNodeClass,
        claim: NodeClaim,
        instance_types: Sequence[InstanceType],
    ) -> CloudInstance:
        reqs = claim.requirements
        candidates = filters.apply_chain(instance_types, reqs, claim.resources_requested)
        if not candidates:
            raise InsufficientCapacityError("all requested instance types were unavailable")
        capacity_type = self._capacity_type(candidates, reqs)
        candidates = self._truncate(candidates, capacity_type, claim)
        return self._launch(nodeclass, claim, candidates, capacity_type)

    def _capacity_type(self, items: Sequence[InstanceType], reqs: Requirements) -> str:
        """reserved > spot > on-demand among permitted+available (:504-518),
        with the spot-flexibility floor: a spot launch with fewer than 5
        candidate types falls back to on-demand when permitted (:58)."""
        req = reqs.get(wk.CAPACITY_TYPE_LABEL)
        for ct in (wk.CAPACITY_TYPE_RESERVED, wk.CAPACITY_TYPE_SPOT, wk.CAPACITY_TYPE_ON_DEMAND):
            if req is not None and not req.matches(ct):
                continue
            if not any(o.capacity_type == ct for it in items for o in it.available_offerings()):
                continue
            if ct == wk.CAPACITY_TYPE_SPOT and not filters.spot_viable(items, reqs):
                od_permitted = req is None or req.matches(wk.CAPACITY_TYPE_ON_DEMAND)
                od_available = any(
                    o.capacity_type == wk.CAPACITY_TYPE_ON_DEMAND
                    for it in items
                    for o in it.available_offerings()
                )
                if od_permitted and od_available:
                    continue  # fall through to on-demand
            return ct
        return wk.CAPACITY_TYPE_ON_DEMAND

    def _truncate(self, items: Sequence[InstanceType], capacity_type: str, claim=None) -> List[InstanceType]:
        """Cheapest-first truncation to 60 (reference sorts by price then
        truncates, :242-270), preserving any minValues flexibility the
        claim's requirements demand."""

        def price(it: InstanceType) -> float:
            ps = [o.price for o in it.available_offerings() if o.capacity_type == capacity_type]
            return min(ps) if ps else float("inf")

        by_price = sorted(items, key=price)
        if claim is not None:
            from karpenter_tpu_torch.scheduling import Requirements
            from karpenter_tpu_torch.scheduling.requirements import truncate_preserving_min_values

            reqs = Requirements(claim.requirements)
            return truncate_preserving_min_values(reqs, by_price, MAX_INSTANCE_TYPES)
        return by_price[:MAX_INSTANCE_TYPES]

    def _overrides(
        self,
        claim: NodeClaim,
        items: Sequence[InstanceType],
        capacity_type: str,
        zonal_subnets: Dict[str, object],
        image_id_for,
    ) -> List[FleetOverride]:
        """Cross product of available offerings x zonal subnets (:392-439),
        priority = price (prioritized allocation strategies use it)."""
        out: List[FleetOverride] = []
        reqs = claim.requirements
        for it in items:
            for o in it.available_offerings():
                if o.capacity_type != capacity_type:
                    continue
                if not reqs.compatible(o.requirements()):
                    continue
                subnet = zonal_subnets.get(o.zone)
                if subnet is None:
                    continue
                out.append(
                    FleetOverride(
                        instance_type=it.name,
                        subnet_id=subnet.id,
                        zone=o.zone,
                        priority=o.price,
                        image_id=image_id_for(it),
                        capacity_reservation_id=o.reservation_id,
                    )
                )
        return out

    def _launch(
        self,
        nodeclass: TPUNodeClass,
        claim: NodeClaim,
        items: Sequence[InstanceType],
        capacity_type: str,
        retried: bool = False,
    ) -> CloudInstance:
        reqs = claim.requirements
        zone_req = reqs.get(wk.ZONE_LABEL)
        zones = set(zone_req.values) if zone_req is not None and not zone_req.complement else None
        zonal_subnets = self.subnets.zonal_subnets_for_launch(nodeclass, zones)
        if not zonal_subnets:
            raise InsufficientCapacityError("no subnet with free addresses in permitted zones")

        reservation_id = None
        if capacity_type == wk.CAPACITY_TYPE_RESERVED:
            rids = [o.reservation_id for it in items for o in it.available_offerings() if o.reservation_id]
            reservation_id = rids[0] if rids else None
        labels = {**claim.metadata.labels, **claim.requirements.labels()}
        groups = self.launch_templates.ensure_all(
            nodeclass, list(items), labels, claim.taints, capacity_reservation_id=reservation_id
        )
        if not groups:
            raise InsufficientCapacityError("no image matches any candidate instance type")

        by_type: Dict[str, str] = {}
        template_of: Dict[str, str] = {}
        for g in groups:
            for it in g.instance_types:
                by_type[it.name] = g.image.id
                template_of[it.name] = g.template_name

        # types with no image group are unlaunchable: they must not produce
        # overrides (an override without a template would crash below)
        launchable = [it for it in items if it.name in template_of]
        overrides = self._overrides(claim, launchable, capacity_type, zonal_subnets, lambda it: by_type[it.name])
        if not overrides:
            raise InsufficientCapacityError("no launchable offering x subnet combination")

        # fleet per launch template group: pick the group of the cheapest override
        overrides.sort(key=lambda o: o.priority)
        lead_template = template_of[overrides[0].instance_type]
        group_overrides = [o for o in overrides if template_of[o.instance_type] == lead_template]
        # journal idempotency token (annotation stamped by begin_launch):
        # rides the fleet call as a client token, OUTSIDE the batcher's
        # merge hash, so a crash-replayed launch returns the instance the
        # first attempt minted instead of a double
        token = claim.metadata.annotations.get(INTENT_TOKEN_ANNOTATION)
        request = FleetRequest(
            launch_template_name=lead_template,
            capacity_type=capacity_type,
            overrides=group_overrides,
            target_capacity=1,
            client_tokens=(token,) if token else (),
            # ownership tags only -- per-claim tags (nodeclaim name, Name)
            # are stamped post-registration by the tagging controller, which
            # keeps identical launches byte-identical so the fleet batcher
            # can merge them (reference: tagging/controller.go + the
            # whole-input DefaultHasher in batcher.go:117-124)
            tags={
                CLUSTER_TAG: self.cluster_name,
                NODEPOOL_TAG: claim.metadata.labels.get(wk.NODEPOOL_LABEL, ""),
                wk.LABEL_NODECLASS: nodeclass.name,
            },
        )
        # chaos site: error(InsufficientCapacityError) here is an ICE storm
        # (every launch refused until the failpoint's budget drains); the
        # provisioner marks the claim's pods unschedulable and re-simulates
        # around it next tick -- the chaos soak asserts convergence after
        from karpenter_tpu_torch import failpoints

        failpoints.eval("instance.launch")
        try:
            result = self._create_fleet(request)
        except KeyError as e:
            # stale launch-template cache: invalidate THIS launch's template
            # names (incl. reservation-scoped ones) and retry once (:124-128)
            if retried:
                raise NotFoundError(str(e))
            for g in groups:
                self.launch_templates.invalidate(g.template_name)
            return self._launch(nodeclass, claim, items, capacity_type, retried=True)
        self._update_unavailable(result.errors, capacity_type, reservation_id)
        if not result.instances:
            raise InsufficientCapacityError(
                "; ".join(e.message for e in result.errors) or "fleet returned no instances"
            )
        inst = result.instances[0]
        self.subnets.mark_inflight(inst.subnet_id)
        if inst.capacity_reservation_id and self.capacity_reservations is not None:
            self.capacity_reservations.mark_launched(inst.capacity_reservation_id)
        return inst

    def _update_unavailable(self, fleet_errors, capacity_type: str, reservation_id=None) -> None:
        for e in fleet_errors:
            if is_unfulfillable_capacity(e.code) and e.instance_type and e.zone:
                self.unavailable.mark_unavailable(
                    e.instance_type, e.zone, e.capacity_type or capacity_type, reason=e.code
                )
            if e.code == "ReservationCapacityExceeded" and reservation_id and self.capacity_reservations is not None:
                self.capacity_reservations.mark_unavailable(reservation_id)

    # -- read / delete ------------------------------------------------------
    def get(self, instance_id: str) -> CloudInstance:
        found = self._describe([instance_id])
        if not found:
            raise NotFoundError(f"instance {instance_id} not found")
        return found[0]

    def list(self) -> List[CloudInstance]:
        """All instances owned by this cluster (GC resync tag filter)."""
        return self.compute_api.describe_instances(tag_filter={CLUSTER_TAG: self.cluster_name})

    def by_token(self, token: str) -> Optional[CloudInstance]:
        """The live instance an intent token launched, if any (the recovery
        sweep's correlation read; the cloud stamps the token tag at
        launch)."""
        for inst in self.compute_api.describe_instances(
            tag_filter={CLUSTER_TAG: self.cluster_name, INTENT_TOKEN_ANNOTATION: token}
        ):
            if inst.state not in ("terminated", "shutting-down"):
                return inst
        return None

    def delete(self, instance_id: str) -> None:
        inst = self._describe([instance_id])
        if not inst:
            raise NotFoundError(f"instance {instance_id} not found")
        if inst[0].state in ("shutting-down", "terminated"):
            return  # already going away (:206-224)
        self._terminate([instance_id])
        if inst[0].capacity_reservation_id and self.capacity_reservations is not None:
            self.capacity_reservations.mark_terminated(inst[0].capacity_reservation_id)

    def create_tags(self, instance_id: str, tags: Dict[str, str]) -> None:
        if self.fence is not None:
            self.fence.check("create_tags")
        try:
            self.compute_api.create_tags(instance_id, tags)
        except KeyError:
            raise NotFoundError(f"instance {instance_id} not found")
