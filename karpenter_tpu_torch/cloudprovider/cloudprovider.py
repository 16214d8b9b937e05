"""CloudProvider plugin boundary.

Rebuilds the contract of pkg/cloudprovider/cloudprovider.go:56-305 -- the
seam between the scheduling core and the provider stack:

  Create / Delete / Get / List / GetInstanceTypes / IsDrifted /
  RepairPolicies / Name / GetSupportedNodeClasses / DisruptionReasons

Create resolves the claim's nodeclass, lists candidate instance types,
delegates to the instance provider, and reflects the launched instance back
into the NodeClaim (instanceToNodeClaim :377-440). Drift detection compares
static hashes plus resolved cloud state (pkg/cloudprovider/drift.go:43-157).

Copy of karpenter_tpu/cloudprovider/cloudprovider.py, imports rewritten to the port's.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence

from karpenter_tpu_torch.apis import NodeClaim, NodePool, TPUNodeClass, labels as wk
from karpenter_tpu_torch.apis.nodeclaim import COND_LAUNCHED
from karpenter_tpu_torch.apis.nodeclass import HASH_ANNOTATION, HASH_VERSION, HASH_VERSION_ANNOTATION
from karpenter_tpu_torch.cloud.types import CloudInstance
from karpenter_tpu_torch.errors import NodeClassNotReadyError, NotFoundError
from karpenter_tpu_torch.kwok.cluster import Cluster
from karpenter_tpu_torch.providers.instance import InstanceProvider
from karpenter_tpu_torch.providers.instancetype.provider import InstanceTypeProvider
from karpenter_tpu_torch.providers.instancetype.types import InstanceType
from karpenter_tpu_torch.scheduling import Resources
from karpenter_tpu_torch.scheduling import resources as res
from karpenter_tpu_torch.utils import parse_instance_id

DRIFTED_STATIC = "NodeClassHashDrifted"
DRIFTED_NODECLASS = "NodeClassDrifted"
DRIFTED_IMAGE = "ImageDrifted"
DRIFTED_SUBNET = "SubnetDrifted"
DRIFTED_SECURITY_GROUP = "SecurityGroupDrifted"


@dataclass
class RepairPolicy:
    """Tolerate an unhealthy node condition for a window, then replace
    (reference: cloudprovider.go:264-305)."""

    condition_type: str
    condition_status: str
    toleration_seconds: float


class CloudProvider:
    NAME = "tpu"

    def __init__(
        self,
        cluster: Cluster,
        instance_types: InstanceTypeProvider,
        instances: InstanceProvider,
    ):
        self.cluster = cluster
        self.instance_types = instance_types
        self.instances = instances

    def launch_window(self, expected: int):
        return self.instances.launch_window(expected)

    def name(self) -> str:
        return self.NAME

    def get_supported_node_classes(self) -> List[type]:
        return [TPUNodeClass]

    def disruption_reasons(self) -> List[str]:
        return ["Underutilized", "Empty", "Drifted", "Expired", "Interrupted"]

    # -- catalog ------------------------------------------------------------
    def _nodeclass_for(self, obj) -> TPUNodeClass:
        ref = getattr(obj, "node_class_ref", None) or obj.template.node_class_ref
        nc = self.cluster.try_get(TPUNodeClass, ref.name)
        if nc is None:
            raise NotFoundError(f"nodeclass {ref.name} not found")
        return nc

    def get_instance_types(self, nodepool: NodePool) -> List[InstanceType]:
        nodeclass = self._nodeclass_for(nodepool)
        return self.instance_types.list(nodeclass)

    # -- lifecycle ----------------------------------------------------------
    def create(self, claim: NodeClaim) -> NodeClaim:
        nodeclass = self._nodeclass_for(claim)
        if not nodeclass.ready():
            raise NodeClassNotReadyError(f"nodeclass {nodeclass.name} is not ready")
        items = self.instance_types.list(nodeclass)
        compatible = [it for it in items if it.requirements.compatible(claim.requirements)]
        inst = self.instances.create(nodeclass, claim, compatible)
        # crash site: the canonical crash-consistency window -- the cloud
        # mutation has happened, the claim status commit has NOT. Without
        # the intent journal this instance leaks until GC's grace window;
        # with it, the restart recovery sweep adopts the instance by its
        # intent token (controllers/recovery.py)
        from karpenter_tpu_torch import failpoints

        failpoints.eval("crash.launch")
        chosen = next((it for it in items if it.name == inst.instance_type), None)
        return self._instance_to_nodeclaim(claim, inst, chosen)

    def adopt(self, claim: NodeClaim, inst: CloudInstance) -> NodeClaim:
        """Reflect an ALREADY-LAUNCHED instance into a claim whose status
        commit was lost to a crash (the recovery sweep's repair path):
        exactly the instanceToNodeClaim reflection create() would have
        done, minus the launch."""
        nodeclass = self._nodeclass_for(claim)
        items = self.instance_types.list(nodeclass)
        chosen = next((it for it in items if it.name == inst.instance_type), None)
        return self._instance_to_nodeclaim(claim, inst, chosen)

    def _instance_to_nodeclaim(
        self, claim: NodeClaim, inst: CloudInstance, itype: Optional[InstanceType]
    ) -> NodeClaim:
        labels = dict(claim.metadata.labels)
        if itype is not None:
            labels.update(itype.requirements.labels())
        labels[wk.INSTANCE_TYPE_LABEL] = inst.instance_type
        labels[wk.ZONE_LABEL] = inst.zone
        labels[wk.CAPACITY_TYPE_LABEL] = inst.capacity_type
        if inst.capacity_reservation_id:
            labels[wk.LABEL_CAPACITY_RESERVATION_ID] = inst.capacity_reservation_id
        claim.metadata.labels = labels
        claim.provider_id = inst.provider_id
        claim.image_id = inst.image_id
        if itype is not None:
            claim.capacity = itype.capacity
            claim.allocatable = itype.allocatable()
        claim.status_conditions.set_true(COND_LAUNCHED, "InstanceLaunched")
        return claim

    def delete(self, claim: NodeClaim) -> None:
        if not claim.provider_id:
            raise NotFoundError(f"nodeclaim {claim.name} has no provider id")
        self.instances.delete(parse_instance_id(claim.provider_id))

    def get(self, provider_id: str) -> CloudInstance:
        return self.instances.get(parse_instance_id(provider_id))

    def list_instances(self) -> List[CloudInstance]:
        return [i for i in self.instances.list() if i.state not in ("terminated",)]

    # -- drift --------------------------------------------------------------
    def is_drifted(self, claim: NodeClaim) -> Optional[str]:
        nodeclass = self._nodeclass_for(claim)
        # static hash drift (annotation stamped at claim creation)
        claimed_hash = claim.metadata.annotations.get(HASH_ANNOTATION)
        if (
            claimed_hash is not None
            and claim.metadata.annotations.get(HASH_VERSION_ANNOTATION) == HASH_VERSION
            and claimed_hash != nodeclass.static_hash()
        ):
            return DRIFTED_STATIC
        # image drift: the claim's image no longer in resolved status
        if claim.image_id and nodeclass.status_images:
            if claim.image_id not in {i.id for i in nodeclass.status_images}:
                return DRIFTED_IMAGE
        # cloud-state drift: instance's subnet / security groups no longer
        # covered by the nodeclass's resolved status (drift.go:43-157)
        if claim.provider_id and (nodeclass.status_subnets or nodeclass.status_security_groups):
            try:
                inst = self.get(claim.provider_id)
            except NotFoundError:
                return None
            if nodeclass.status_subnets and inst.subnet_id not in {s.id for s in nodeclass.status_subnets}:
                return DRIFTED_SUBNET
            if nodeclass.status_security_groups and inst.security_group_ids:
                if set(inst.security_group_ids) != {g.id for g in nodeclass.status_security_groups}:
                    return DRIFTED_SECURITY_GROUP
        return None

    # -- repair -------------------------------------------------------------
    def repair_policies(self) -> List[RepairPolicy]:
        return [
            RepairPolicy("Ready", "False", 30 * 60.0),
            RepairPolicy("Ready", "Unknown", 30 * 60.0),
            RepairPolicy("AcceleratedHardwareReady", "False", 10 * 60.0),
        ]
