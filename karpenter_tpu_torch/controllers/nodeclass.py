"""TPUNodeClass status reconciler.

Rebuilds the reconciler chain of pkg/controllers/nodeclass/controller.go:
97-163: Image -> CapacityReservation -> Subnet -> SecurityGroup ->
InstanceProfile -> Validation -> Readiness, each resolving cloud state into
status and setting its condition; the finalizer tears down owned instance
profiles and launch templates (:165-201). The hash sub-controller stamps
drift annotations (pkg/controllers/nodeclass/hash/controller.go).

Copy of karpenter_tpu/controllers/nodeclass.py, imports rewritten to the port's.
"""
from __future__ import annotations

from typing import List, Optional

from karpenter_tpu_torch.apis import TPUNodeClass
from karpenter_tpu_torch.apis.nodeclass import (
    COND_CAPACITY_RESERVATIONS_READY,
    COND_IMAGES_READY,
    COND_INSTANCE_PROFILE_READY,
    COND_READY,
    COND_SECURITY_GROUPS_READY,
    COND_SUBNETS_READY,
    COND_VALIDATION_SUCCEEDED,
    HASH_ANNOTATION,
    HASH_VERSION,
    HASH_VERSION_ANNOTATION,
    CapacityReservationStatus,
    ImageStatus,
    NODECLASS_CONDITIONS,
    SecurityGroupStatus,
    SubnetStatus,
)
from karpenter_tpu_torch.cloud.api import ComputeAPI, IdentityAPI
from karpenter_tpu_torch.kwok.cluster import Cluster
from karpenter_tpu_torch.providers.image import ImageProvider
from karpenter_tpu_torch.providers.securitygroup import SecurityGroupProvider
from karpenter_tpu_torch.providers.subnet import SubnetProvider
from karpenter_tpu_torch.logging import ChangeMonitor, get_logger

TERMINATION_FINALIZER = "karpenter.tpu/termination"


class NodeClassController:
    log = get_logger("nodeclass")

    def __init__(
        self,
        cluster: Cluster,
        compute_api: ComputeAPI,
        identity_api: IdentityAPI,
        subnets: SubnetProvider,
        security_groups: SecurityGroupProvider,
        images: ImageProvider,
        launch_templates=None,
        clock=None,
        capacity_reservations=None,
        instance_profiles=None,
        cluster_name: str = "",
    ):
        from karpenter_tpu_torch.providers.instanceprofile import InstanceProfileProvider

        from karpenter_tpu_torch.cache.ttl import TTLCache

        # validation results are cloud-state dependent (profile existence),
        # so the cache is TTL'd like the reference's (validation.go): a
        # fixed spec re-validates every 10 minutes, picking up cloud-side
        # fixes without a spec edit or restart
        self._validation_cache = TTLCache(default_ttl=10 * 60.0, clock=clock)
        self.monitor = ChangeMonitor()  # per-instance: dedup state must not
        # leak across operators (tests, in-process restarts)
        self.cluster = cluster
        self.compute_api = compute_api
        self.identity_api = identity_api
        self.subnets = subnets
        self.security_groups = security_groups
        self.images = images
        self.launch_templates = launch_templates
        self.clock = clock
        self.capacity_reservations = capacity_reservations
        if instance_profiles is None:
            # managed-profile names embed the cluster name so two clusters
            # can never collide on (and finalize-delete) each other's
            # profiles -- a default provider without one would be a trap
            if not cluster_name:
                raise ValueError(
                    "NodeClassController needs either an InstanceProfileProvider "
                    "or a cluster_name to build one"
                )
            instance_profiles = InstanceProfileProvider(identity_api, cluster_name)
        self.instance_profiles = instance_profiles

    def reconcile_all(self) -> None:
        for nc in self.cluster.list(TPUNodeClass):
            self.reconcile(nc)

    def reconcile(self, nc: TPUNodeClass) -> None:
        if nc.deleting:
            self._finalize(nc)
            return
        if TERMINATION_FINALIZER not in nc.metadata.finalizers:
            nc.metadata.finalizers.append(TERMINATION_FINALIZER)
        self._reconcile_hash(nc)
        self._reconcile_images(nc)
        self._reconcile_capacity_reservations(nc)
        self._reconcile_subnets(nc)
        self._reconcile_security_groups(nc)
        self._reconcile_instance_profile(nc)
        self._reconcile_validation(nc)
        nc.status_conditions.compute_root(NODECLASS_CONDITIONS)
        ready = nc.status_conditions.is_true(nc.status_conditions.READY)
        # readiness transitions log once per flip (ChangeMonitor dedup)
        if self.monitor.has_changed(("ready", nc.metadata.name), ready):
            self.log.info("nodeclass readiness", nodeclass=nc.metadata.name, ready=ready)
        self.cluster.update(nc)

    # -- chain stages -------------------------------------------------------
    def _reconcile_hash(self, nc: TPUNodeClass) -> None:
        nc.metadata.annotations[HASH_ANNOTATION] = nc.static_hash()
        nc.metadata.annotations[HASH_VERSION_ANNOTATION] = HASH_VERSION

    def _reconcile_images(self, nc: TPUNodeClass) -> None:
        resolved = self.images.resolve(nc)
        if not resolved:
            nc.status_images = []
            nc.status_conditions.set_false(COND_IMAGES_READY, "ImagesNotFound", "no images matched selector terms")
            return
        nc.status_images = [
            ImageStatus(id=r.id, name=r.name, requirements=list(r.requirements)) for r in resolved
        ]
        nc.status_conditions.set_true(COND_IMAGES_READY)

    def _reconcile_capacity_reservations(self, nc: TPUNodeClass) -> None:
        if not nc.capacity_reservation_selector_terms:
            nc.status_capacity_reservations = []
            nc.status_conditions.set_true(COND_CAPACITY_RESERVATIONS_READY)
            return
        now = self.cluster.clock.now()
        out: List[CapacityReservationStatus] = []
        # read through the reservation provider when wired: its refresh
        # clears the in-memory launch/terminate deltas in the same motion,
        # so described counts and deltas never double-count
        if self.capacity_reservations is not None:
            reservations = self.capacity_reservations.list()
        else:
            reservations = self.compute_api.describe_capacity_reservations()
        for cr in reservations:
            if cr.end_time is not None and cr.end_time <= now:
                continue
            if not any(t.matches(id=cr.id, tags=cr.tags) for t in nc.capacity_reservation_selector_terms):
                continue
            out.append(
                CapacityReservationStatus(
                    id=cr.id,
                    instance_type=cr.instance_type,
                    zone=cr.zone,
                    owner_id=cr.owner_id,
                    reservation_type=cr.reservation_type,
                    state=cr.state,
                    end_time=cr.end_time,
                    available_count=cr.available_count,
                )
            )
        nc.status_capacity_reservations = out
        nc.status_conditions.set_true(COND_CAPACITY_RESERVATIONS_READY)

    def _reconcile_subnets(self, nc: TPUNodeClass) -> None:
        subnets = self.subnets.list(nc)
        if not subnets:
            nc.status_subnets = []
            nc.status_conditions.set_false(COND_SUBNETS_READY, "SubnetsNotFound", "no subnets matched selector terms")
            return
        nc.status_subnets = [SubnetStatus(s.id, s.zone, s.zone_id) for s in subnets]
        nc.status_conditions.set_true(COND_SUBNETS_READY)

    def _reconcile_security_groups(self, nc: TPUNodeClass) -> None:
        groups = self.security_groups.list(nc)
        if not groups:
            nc.status_security_groups = []
            nc.status_conditions.set_false(
                COND_SECURITY_GROUPS_READY, "SecurityGroupsNotFound", "no security groups matched selector terms"
            )
            return
        nc.status_security_groups = [SecurityGroupStatus(g.id, g.name) for g in groups]
        nc.status_conditions.set_true(COND_SECURITY_GROUPS_READY)

    def _reconcile_instance_profile(self, nc: TPUNodeClass) -> None:
        if nc.instance_profile:
            # user-supplied profile: reference it, never manage it
            nc.status_instance_profile = nc.instance_profile
            nc.status_conditions.set_true(COND_INSTANCE_PROFILE_READY)
            return
        nc.status_instance_profile = self.instance_profiles.ensure(nc.name, nc.role)
        nc.status_conditions.set_true(COND_INSTANCE_PROFILE_READY)

    def _reconcile_validation(self, nc: TPUNodeClass) -> None:
        """Launchability dry-run (reference: nodeclass/validation.go does
        cached dry-run authorization/launch checks, keyed by the nodeclass
        hash so they don't re-run every reconcile). Static spec invariants
        belong to admission (apis/validation.py); this stage owns the
        checks that need the CLOUD or the render pipeline:
          - userdata must render for the image family (bad user TOML would
            otherwise only fail at launch time)
          - a USER-specified instance profile must actually exist (the
            managed path creates its own)"""
        cache_key = nc.static_hash()
        hit, fresh = self._validation_cache.get(nc.metadata.name)
        if fresh and hit[0] == cache_key:
            ok, message = hit[1], hit[2]
            self._set_validation_condition(nc, ok, message)
            return
        problems = []
        from karpenter_tpu_torch.providers.launchtemplate import bootstrap

        try:
            bootstrap.render(
                nc.image_family,
                cluster_name="validation",
                endpoint="https://validation.invalid",
                ca_bundle="validation",
                nodeclass=nc,
                labels={},
                taints=[],
                max_pods=None,
            )
        except ValueError as e:
            problems.append(f"userdata does not render: {e}")
        if nc.instance_profile:
            if self.identity_api.get_instance_profile(nc.instance_profile) is None:
                problems.append(f"instance profile {nc.instance_profile!r} not found")
        message = "; ".join(problems)
        self._validation_cache.set(nc.metadata.name, (cache_key, not problems, message))
        self._set_validation_condition(nc, not problems, message)

    @staticmethod
    def _set_validation_condition(nc: TPUNodeClass, ok: bool, message: str) -> None:
        if ok:
            nc.status_conditions.set_true(COND_VALIDATION_SUCCEEDED)
        else:
            nc.status_conditions.set_false(COND_VALIDATION_SUCCEEDED, "ValidationFailed", message)

    # -- finalizer ----------------------------------------------------------
    def _finalize(self, nc: TPUNodeClass) -> None:
        from karpenter_tpu_torch.apis import NodeClaim

        blocking = [
            c
            for c in self.cluster.list(NodeClaim)
            if c.node_class_ref.name == nc.name and not c.deleting
        ]
        if blocking:
            return  # nodeclaims must drain first (reference blocks deletion)
        if self.launch_templates is not None:
            self.launch_templates.delete_all(nc)
        if not nc.instance_profile:  # only delete profiles we created
            self.instance_profiles.delete(nc.name)
        # a recreated nodeclass of the same name must re-validate
        self._validation_cache.delete(nc.metadata.name)
        self.cluster.remove_finalizer(nc, TERMINATION_FINALIZER)
