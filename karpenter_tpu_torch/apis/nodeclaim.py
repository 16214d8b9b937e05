"""NodeClaim API type.

The unit of capacity the scheduler creates and the cloud provider fulfils
(reference: core CRD pkg/apis/crds/karpenter.sh_nodeclaims.yaml; lifecycle
visible in pkg/cloudprovider/cloudprovider.go:90-133 Create and
instanceToNodeClaim :377-440).

Copy of karpenter_tpu/apis/nodeclaim.py, imports rewritten to the port's.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

from karpenter_tpu_torch.apis.objects import APIObject
from karpenter_tpu_torch.apis.nodepool import NodeClassRef
from karpenter_tpu_torch.scheduling import Requirement, Requirements, Resources, Taint

# condition types (core vocabulary)
COND_LAUNCHED = "Launched"
COND_REGISTERED = "Registered"
COND_INITIALIZED = "Initialized"
COND_DRIFTED = "Drifted"
COND_EMPTY = "Empty"
COND_CONSOLIDATABLE = "Consolidatable"


class NodeClaim(APIObject):
    KIND = "NodeClaim"

    def __init__(
        self,
        name: str,
        requirements: Sequence[Requirement] = (),
        resources_requested: Optional[Resources] = None,
        node_class_ref: Optional[NodeClassRef] = None,
        taints: Sequence[Taint] = (),
        startup_taints: Sequence[Taint] = (),
        expire_after: Optional[float] = None,
    ):
        super().__init__(name=name)
        self.requirements = Requirements(requirements)
        self.resources_requested = resources_requested or Resources()
        self.node_class_ref = node_class_ref or NodeClassRef()
        self.taints: List[Taint] = list(taints)
        self.startup_taints: List[Taint] = list(startup_taints)
        self.expire_after = expire_after
        self.termination_grace_period: Optional[float] = None

        # status
        self.provider_id: str = ""
        self.image_id: str = ""
        self.capacity = Resources()
        self.allocatable = Resources()
        self.node_name: str = ""
        self.last_pod_event_time: float = 0.0

    @property
    def nodepool_name(self) -> Optional[str]:
        from karpenter_tpu_torch.apis import labels as wk

        return self.metadata.labels.get(wk.NODEPOOL_LABEL)

    @property
    def instance_type(self) -> Optional[str]:
        from karpenter_tpu_torch.apis import labels as wk

        return self.metadata.labels.get(wk.INSTANCE_TYPE_LABEL)

    @property
    def capacity_type(self) -> Optional[str]:
        from karpenter_tpu_torch.apis import labels as wk

        return self.metadata.labels.get(wk.CAPACITY_TYPE_LABEL)

    @property
    def zone(self) -> Optional[str]:
        from karpenter_tpu_torch.apis import labels as wk

        return self.metadata.labels.get(wk.ZONE_LABEL)

    def launched(self) -> bool:
        return self.status_conditions.is_true(COND_LAUNCHED)

    def registered(self) -> bool:
        return self.status_conditions.is_true(COND_REGISTERED)

    def initialized(self) -> bool:
        return self.status_conditions.is_true(COND_INITIALIZED)
