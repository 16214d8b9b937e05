"""Standalone NodeClaim launcher: claims are a launch API, not just a
provisioner artifact.

The reference core's nodeclaim lifecycle controller launches ANY pending
NodeClaim resource -- users create claims directly for static capacity
(a claim with its own requirements + nodeclass ref, no NodePool
involved), and the same machinery drives registration/initialization
afterwards. In this framework the provisioner launches the claims IT
creates synchronously inside its own reconcile, so any claim that is
still unlaunched when this controller runs is a standalone one (or a
leftover the provisioner chose to delete -- it never leaves unlaunched
claims behind). Launching reuses the exact provider path
(CloudProvider.create resolves everything from the claim itself) under
the SAME launch_window + worker-pool rendezvous the provisioner uses, so
static capacity gets real fleet batching, ICE handling, and the kwok
lifecycle's registration flow.

Failures stay level-triggered: a claim whose nodeclass is not ready or
whose capacity is unavailable retries next tick, with a Warning event
(deduped by the recorder window) instead of silent stalling.

Copy of karpenter_tpu/controllers/nodeclaim_lifecycle.py, imports rewritten to the port's.
"""
from __future__ import annotations

from karpenter_tpu_torch.apis import NodeClaim, labels as wk
from karpenter_tpu_torch.apis.nodeclass import HASH_ANNOTATION, HASH_VERSION, HASH_VERSION_ANNOTATION, TPUNodeClass
from karpenter_tpu_torch import metrics
from karpenter_tpu_torch.logging import get_logger


class NodeClaimLifecycleController:
    log = get_logger("nodeclaim.lifecycle")

    # same fan-out as the provisioner's launch wave (SURVEY §2.4 row 1)
    MAX_CONCURRENT_LAUNCHES = 10

    def __init__(self, cluster, cloud_provider, recorder=None, journal=None):
        self.cluster = cluster
        self.cloud_provider = cloud_provider
        self.recorder = recorder
        # optional IntentJournal: standalone launches get the same
        # write-ahead crash-consistency protocol as provisioned ones
        self.journal = journal

    def reconcile_all(self) -> int:
        from karpenter_tpu_torch.controllers.provisioner import launch_all
        from karpenter_tpu_torch.providers.instance.provider import INTENT_TOKEN_ANNOTATION

        pending = [
            c for c in self.cluster.list(NodeClaim)
            if not c.launched() and not c.deleting
        ]
        if not pending:
            return 0
        intents = []
        for claim in pending:
            intent = None
            if self.journal is not None:
                intent = self.journal.begin_launch(claim)
                claim.metadata.annotations[INTENT_TOKEN_ANNOTATION] = intent.token
            intents.append(intent)
        outcomes = launch_all(self.cloud_provider, pending, self.MAX_CONCURRENT_LAUNCHES)
        launched = 0
        for claim, intent, err in zip(pending, intents, outcomes):
            if err is not None:
                if self.recorder is not None:
                    self.recorder.publish(claim, "LaunchFailed", str(err), type="Warning")
                # intent stays OPEN: unlike the provisioner the claim is
                # not dropped (level-triggered retry next tick reuses the
                # same intent and token, so the retry stays idempotent)
                continue
            # stamp the nodeclass static hash so drift detection covers
            # static capacity exactly as it covers provisioned capacity
            # (the provisioner stamps the same pair in _to_nodeclaim)
            nodeclass = self.cluster.try_get(TPUNodeClass, claim.node_class_ref.name)
            if nodeclass is not None and HASH_ANNOTATION not in claim.metadata.annotations:
                claim.metadata.annotations[HASH_ANNOTATION] = nodeclass.static_hash()
                claim.metadata.annotations[HASH_VERSION_ANNOTATION] = HASH_VERSION
            self.cluster.update(claim)
            if intent is not None:
                self.journal.resolve(intent, "committed")
            launched += 1
            metrics.NODECLAIMS_CREATED.inc(
                nodepool=claim.metadata.labels.get(wk.NODEPOOL_LABEL, "<standalone>")
            )
            self.log.info(
                "launched standalone nodeclaim",
                nodeclaim=claim.metadata.name,
                provider_id=claim.provider_id,
            )
        return launched
