"""Copy of karpenter_tpu/apis/__init__.py, imports rewritten to the port's."""
from karpenter_tpu_torch.apis import labels
from karpenter_tpu_torch.apis.objects import APIObject, ObjectMeta, StatusConditions, Condition, generate_name
from karpenter_tpu_torch.apis.nodepool import (
    NodePool,
    NodeClaimTemplate,
    NodeClassRef,
    Disruption,
    Budget,
    CONSOLIDATION_WHEN_EMPTY,
    CONSOLIDATION_WHEN_EMPTY_OR_UNDERUTILIZED,
)
from karpenter_tpu_torch.apis.nodeclaim import NodeClaim
from karpenter_tpu_torch.apis.nodeclass import TPUNodeClass, SelectorTerm, ImageSelectorTerm
from karpenter_tpu_torch.apis.pod import Pod, Node, TopologySpreadConstraint, PodAffinityTerm
from karpenter_tpu_torch.apis.pdb import PodDisruptionBudget
from karpenter_tpu_torch.apis.daemonset import DaemonSet
from karpenter_tpu_torch.apis.storage import PersistentVolumeClaim, StorageClass

__all__ = [
    "labels",
    "APIObject",
    "ObjectMeta",
    "StatusConditions",
    "Condition",
    "generate_name",
    "NodePool",
    "NodeClaimTemplate",
    "NodeClassRef",
    "Disruption",
    "Budget",
    "CONSOLIDATION_WHEN_EMPTY",
    "CONSOLIDATION_WHEN_EMPTY_OR_UNDERUTILIZED",
    "NodeClaim",
    "TPUNodeClass",
    "SelectorTerm",
    "ImageSelectorTerm",
    "Pod",
    "Node",
    "TopologySpreadConstraint",
    "PodAffinityTerm",
    "PodDisruptionBudget",
    "DaemonSet",
]
