"""API types the provisioning solve reads (mirrors karpenter_tpu/apis)."""
from karpenter_tpu_torch.apis import labels
from karpenter_tpu_torch.apis.objects import APIObject, ObjectMeta
from karpenter_tpu_torch.apis.nodepool import NodePool, NodeClaimTemplate
from karpenter_tpu_torch.apis.pod import Pod, Node, TopologySpreadConstraint, PodAffinityTerm

__all__ = [
    "labels",
    "APIObject",
    "ObjectMeta",
    "NodePool",
    "NodeClaimTemplate",
    "Pod",
    "Node",
    "TopologySpreadConstraint",
    "PodAffinityTerm",
]
