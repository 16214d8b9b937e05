"""Post-launch instance tagging.

Rebuilds pkg/controllers/nodeclaim/tagging/controller.go:62-131: once a
NodeClaim is launched and registered, stamp the instance with its Name and
cluster-resolution tags (the fleet call already applied the ownership tags;
this adds the ones only known post-registration, e.g. the node name).

Copy of karpenter_tpu/controllers/tagging.py, imports rewritten to the port's.
"""
from __future__ import annotations

from karpenter_tpu_torch.apis import NodeClaim
from karpenter_tpu_torch.cloudprovider import CloudProvider
from karpenter_tpu_torch.errors import NotFoundError
from karpenter_tpu_torch.kwok.cluster import Cluster
from karpenter_tpu_torch.providers.instance.provider import NODECLAIM_TAG
from karpenter_tpu_torch.utils import parse_instance_id
from karpenter_tpu_torch.logging import get_logger

ANNOTATION_TAGGED = "karpenter.tpu/tagged"


class TaggingController:
    log = get_logger("tagging")

    def __init__(self, cluster: Cluster, cloud_provider: CloudProvider):
        self.cluster = cluster
        self.cloud_provider = cloud_provider

    def reconcile_all(self) -> int:
        tagged = 0
        for claim in self.cluster.list(NodeClaim):
            if not claim.launched() or claim.deleting:
                continue
            if claim.metadata.annotations.get(ANNOTATION_TAGGED) == "true":
                continue
            if not claim.node_name:
                continue  # wait for registration so the node name is final
            try:
                self.cloud_provider.instances.create_tags(
                    parse_instance_id(claim.provider_id),
                    {
                        "Name": claim.node_name,
                        NODECLAIM_TAG: claim.metadata.name,
                    },
                )
            except NotFoundError:
                continue
            claim.metadata.annotations[ANNOTATION_TAGGED] = "true"
            self.cluster.update(claim)
            tagged += 1
            self.log.debug("tagged instance", nodeclaim=claim.metadata.name, node=claim.node_name)
        return tagged
