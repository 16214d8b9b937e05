"""Persistent-volume scheduling vocabulary: StorageClass, PVC, resolution.

The reference schedules around storage twice (core scheduling volume
machinery, exercised end-to-end by the reference's `test/suites/storage`):

1. **Volume topology**: a pod whose claim is bound to a zonal volume can
   only run in that zone. The core translates bound-PV topology into node
   affinity on the scheduling simulation's view of the pod.
2. **Attach limits**: each instance type can attach a bounded number of
   data volumes; the scheduler counts a pod's claims against that budget
   so storage-heavy pods fan out across nodes.

The TPU-native rendering keeps BOTH as transformations into vocabulary
the batched solver already speaks, so the device kernel, the oracle, the
existing-capacity repack, and the binder all enforce them with no new
special cases:

- topology   -> a zone entry merged into the effective pod's nodeSelector
               (the same lowering the reference core applies);
- attach use -> requests on the `attachable-volumes` resource axis
               (scheduling/resources.ATTACHABLE_VOLUMES), bounded by the
               per-type attach limit in InstanceType capacity
               (providers/instancetype/types.volume_attach_limit).

`effective_pods()` is the single entry point: the provisioner and the
disruption simulations call it on their pod lists; pods without claims
pass through UNTOUCHED (identity, not copies -- the 50k-pod hot path pays
nothing), and pods with claims are replaced by scheduling copies carrying
the resolved requests/selector. Copies share spec objects per (template,
resolution) so the grouping machinery folds replicas into one class.

Binding-mode semantics (mirroring the PV controller):
- `WaitForFirstConsumer` claims bind when their first pod binds: the
  binder / node lifecycle stamps `bound_zone` from the chosen node, and
  until then the claim imposes no topology.
- `Immediate` claims are bound by the volume provisioner out of band;
  an unbound Immediate claim blocks the pod (it has no topology yet but
  k8s would not admit the pod until binding -- the reference treats the
  pod as unschedulable), reported per-pod as unschedulable.

Copy of karpenter_tpu/apis/storage.py, imports rewritten to the port's.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Mapping, Optional, Sequence, Tuple

from karpenter_tpu_torch.apis import labels as wk
from karpenter_tpu_torch.apis.objects import APIObject
from karpenter_tpu_torch.scheduling import Resources, resources as res

BINDING_WAIT_FOR_FIRST_CONSUMER = "WaitForFirstConsumer"
BINDING_IMMEDIATE = "Immediate"


class StorageClass(APIObject):
    KIND = "StorageClass"

    def __init__(
        self,
        name: str,
        binding_mode: str = BINDING_WAIT_FOR_FIRST_CONSUMER,
        provisioner: str = "csi.storage.dev/disk",
    ):
        super().__init__(name=name)
        self.binding_mode = binding_mode
        self.provisioner = provisioner


class PersistentVolumeClaim(APIObject):
    KIND = "PersistentVolumeClaim"

    def __init__(
        self,
        name: str,
        namespace: str = "default",
        storage_class_name: str = "",
        capacity: Optional[Resources] = None,
        bound_zone: Optional[str] = None,
        volume_name: str = "",
        access_modes: Sequence[str] = ("ReadWriteOnce",),
        storage_request: str = "1Gi",
    ):
        super().__init__(name=name)
        self.metadata.namespace = namespace
        self.storage_class_name = storage_class_name
        self.capacity = capacity or Resources()
        # zone of the bound PV; None until the claim binds. Stamped by the
        # binder on first consumer (WaitForFirstConsumer) or by whatever
        # provisions the volume (Immediate).
        self.bound_zone = bound_zone
        self.volume_name = volume_name
        # spec fields the scheduler never reads but a real apiserver
        # requires / forbids changing (kube adapter round-trips them)
        self.access_modes = tuple(access_modes)
        self.storage_request = storage_request

    @property
    def bound(self) -> bool:
        return self.bound_zone is not None or bool(self.volume_name)


class CSINode(APIObject):
    """Per-node CSI driver registry: where real clusters publish volume
    attach limits (spec.drivers[].allocatable.count). The kube adapter
    overlays these onto Node.allocatable's attachable-volumes axis; the
    kwok rig does not need them (its nodes inherit the axis from instance
    type capacity)."""

    KIND = "CSINode"

    def __init__(self, name: str, drivers: Sequence[Tuple[str, Optional[int]]] = ()):
        super().__init__(name=name)
        # (driver name, allocatable count or None when the driver reports
        # no limit)
        self.drivers = tuple((d, None if c is None else int(c)) for d, c in drivers)

    def attach_limit(self) -> Optional[int]:
        counts = [c for _, c in self.drivers if c is not None]
        return min(counts) if counts else None


class VolumeIndex:
    """Point-in-time claim/class lookup built once per scheduling pass."""

    def __init__(
        self,
        claims: Iterable[PersistentVolumeClaim] = (),
        classes: Iterable[StorageClass] = (),
    ):
        self.claims: Dict[Tuple[str, str], PersistentVolumeClaim] = {
            (c.metadata.namespace, c.metadata.name): c for c in claims
        }
        self.classes: Dict[str, StorageClass] = {c.metadata.name: c for c in classes}

    @classmethod
    def from_cluster(cls, cluster) -> "VolumeIndex":
        return cls(cluster.list(PersistentVolumeClaim), cluster.list(StorageClass))

    def lookup(self, pod) -> Tuple[int, Optional[str], Optional[str]]:
        """Resolve a pod's claims -> (attach count, zone pin, blocked reason).

        Attach count includes every referenced claim (bound or not: the
        attachment happens wherever the pod lands). The zone pin is the
        zone of bound claims; two claims bound to DIFFERENT zones block
        the pod outright, as does a missing claim or an unbound claim
        whose class does not wait for a consumer: a NAMED class that is
        absent from the index or whose mode is Immediate blocks (the
        Kubernetes API defaults an unset volumeBindingMode to Immediate,
        and scheduling an unbound Immediate claim would stamp a zone the
        real provisioner may contradict). Classless unbound claims pass
        through as wait-style (static-binding rig convenience)."""
        count = 0
        zone: Optional[str] = None
        for ref in pod.volume_claims:
            claim = self.claims.get((pod.metadata.namespace, ref))
            if claim is None:
                return 0, None, f"persistentvolumeclaim {ref!r} not found"
            count += 1
            if claim.bound_zone is not None:
                if zone is not None and zone != claim.bound_zone:
                    return 0, None, (
                        f"volume zone conflict: claims bound to {zone} and {claim.bound_zone}"
                    )
                zone = claim.bound_zone
            elif not claim.bound and claim.storage_class_name:
                sc = self.classes.get(claim.storage_class_name)
                if sc is None or sc.binding_mode != BINDING_WAIT_FOR_FIRST_CONSUMER:
                    return 0, None, (
                        f"persistentvolumeclaim {ref!r} awaiting binding "
                        f"(class {claim.storage_class_name!r} does not wait for consumer)"
                    )
        return count, zone, None

    def bind_on_schedule(self, pod, zone: Optional[str], cluster=None) -> None:
        """First-consumer binding: stamp the landing zone onto the pod's
        still-unbound WaitForFirstConsumer claims (the PV controller's job
        upstream). With a cluster, writes go through the store so watches
        and optimistic concurrency apply."""
        if zone is None:
            return
        for ref in pod.volume_claims:
            claim = self.claims.get((pod.metadata.namespace, ref))
            if claim is None or claim.bound:
                continue
            claim.bound_zone = zone
            if cluster is not None:
                cluster.update(claim)


def effective_pods(pods: Sequence, index: VolumeIndex):
    """Lower volume claims into solver vocabulary.

    Returns (scheduling_pods, unschedulable: {pod name: reason}). Pods
    without claims pass through by IDENTITY. Pods with claims are replaced
    by copies whose requests carry the attach count on the
    attachable-volumes axis and whose nodeSelector carries the bound-zone
    pin; the copy keeps the original's name so decisions map back. Copies
    constructed from the same (spec token, resolution) share their
    requests/selector objects, so ReplicaSet/StatefulSet replicas with
    same-shaped claims still collapse into one equivalence class."""
    from karpenter_tpu_torch.apis.pod import Pod

    if not index.claims:
        has = [p for p in pods if p.volume_claims]
        if not has:
            return list(pods), {}
    out: List = []
    unschedulable: Dict[str, str] = {}
    shared: Dict[tuple, Tuple[Resources, dict]] = {}
    for p in pods:
        if not p.volume_claims:
            out.append(p)
            continue
        count, zone, blocked = index.lookup(p)
        if blocked is not None:
            unschedulable[p.metadata.name] = blocked
            continue
        if zone is not None and p.node_selector.get(wk.ZONE_LABEL, zone) != zone:
            unschedulable[p.metadata.name] = (
                f"volume bound to zone {zone} conflicts with node selector "
                f"{p.node_selector[wk.ZONE_LABEL]!r}"
            )
            continue
        share_key = (
            p._spec_token if p._spec_token is not None else p.grouping_signature(),
            count, zone,
        )
        cached = shared.get(share_key)
        if cached is None:
            reqs = p.requests + Resources.from_base_units({res.ATTACHABLE_VOLUMES: count})
            sel = dict(p.node_selector)
            if zone is not None:
                sel[wk.ZONE_LABEL] = zone
            cached = shared[share_key] = (reqs, sel)
        reqs, sel = cached
        eff = Pod(
            name=p.metadata.name,
            namespace=p.metadata.namespace,
            requests=reqs,
            limits=p.limits,
            node_selector=sel,
            node_affinity_terms=p.node_affinity_terms,
            preferred_node_affinity_terms=p.preferred_node_affinity_terms,
            tolerations=p.tolerations,
            topology_spread=p.topology_spread,
            affinity_terms=p.affinity_terms,
            preferred_affinity_terms=p.preferred_affinity_terms,
            priority=p.priority,
            labels=p.metadata.labels,
            annotations=p.metadata.annotations,
            owner_kind=p.owner_kind,
        )
        eff.metadata.uid = p.metadata.uid
        out.append(eff)
    return out, unschedulable


def pod_volume_requests(pod, index: VolumeIndex) -> Resources:
    """The attach-count component of a pod's node usage (binder / usage
    accounting): claims that cannot resolve contribute only their count."""
    n = len(pod.volume_claims)
    if not n:
        return Resources()
    return Resources.from_base_units({res.ATTACHABLE_VOLUMES: float(n)})
