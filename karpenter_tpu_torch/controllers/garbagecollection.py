"""Garbage collection: orphaned cloud instances and stale claims.

Rebuilds pkg/controllers/nodeclaim/garbagecollection/controller.go:55-111:
list cluster-owned cloud instances, subtract those with a live NodeClaim,
and terminate the rest (instances whose claim was deleted out-of-band).

With the intent journal wired (karpenter_tpu_torch/journal.py) GC is DEMOTED to
out-of-band deletions only: an instance whose intent token matches an open
journal intent belongs to the crash-consistency layer -- the recovery
sweep adopts or terminates it -- and is never eligible here, no matter its
age. The launch-grace window remains only as the safety net for instances
with no journal record (pre-journal launches, foreign tooling), and is
inclusive at the boundary: an instance aged EXACTLY the grace whose claim
status has not yet committed was the round-6 race -- eligible here in the
same tick the provisioner was about to commit it.

Copy of karpenter_tpu/controllers/garbagecollection.py, imports rewritten to the port's.
"""
from __future__ import annotations

from typing import List, Optional

from karpenter_tpu_torch.apis import NodeClaim, Node
from karpenter_tpu_torch import metrics
from karpenter_tpu_torch.cloudprovider import CloudProvider
from karpenter_tpu_torch.errors import NotFoundError
from karpenter_tpu_torch.kwok.cluster import Cluster
from karpenter_tpu_torch.logging import get_logger

LAUNCH_GRACE = 60.0


class GarbageCollectionController:
    log = get_logger("garbagecollection")

    def __init__(self, cluster: Cluster, cloud_provider: CloudProvider, journal=None,
                 recovery=None):
        self.cluster = cluster
        self.cloud_provider = cloud_provider
        self.journal = journal  # optional IntentJournal
        # optional RecoverySweepController: GC routes STALE intents (open
        # records whose claim left the bus out-of-band, so no restart will
        # ever replay them) through the same replay logic the
        # election-win sweep uses
        self.recovery = recovery

    def reconcile(self) -> List[str]:
        """Returns terminated instance ids."""
        from karpenter_tpu_torch.apis.objects import INTENT_TOKEN_KEY

        now = self.cluster.clock.now()
        if self.journal is not None and self.recovery is not None:
            # stale-intent janitor: an open intent whose claim is gone has
            # no termination controller left to resolve it and no restart
            # guaranteed to come -- replay it here (terminates any
            # half-launched instance immediately, resolves the record)
            for intent in self.journal.open_intents():
                if self.cluster.try_get(NodeClaim, intent.claim_name) is None:
                    try:
                        self.recovery.replay_intent(intent)
                    except Exception as e:  # noqa: BLE001 -- per-intent
                        # isolation, same as the sweep: a cloud fault costs
                        # this record's replay (it stays open for the next
                        # pass), never the whole GC reconcile
                        self.log.warning(
                            "stale-intent replay failed; left open",
                            intent=intent.metadata.name,
                            error=f"{type(e).__name__}: {e}",
                        )
        claimed = {c.provider_id for c in self.cluster.list(NodeClaim) if c.provider_id}
        nodes_by_provider = {n.provider_id: n for n in self.cluster.list(Node) if n.provider_id}
        open_tokens = (
            set(self.journal.open_tokens()) if self.journal is not None else set()
        )
        removed = []
        for inst in self.cloud_provider.list_instances():
            if inst.provider_id in claimed:
                continue
            token = inst.tags.get(INTENT_TOKEN_KEY)
            if token and token in open_tokens:
                # crash-consistency territory: an open launch intent owns
                # this instance; the recovery sweep (not GC) decides its
                # fate. Collecting it here would race the provisioner's
                # status commit at the grace boundary (round-6 race).
                continue
            if now - inst.launch_time <= LAUNCH_GRACE:
                continue
            try:
                # instance-level delete (there is no claim to route through
                # CloudProvider.delete); the instance provider still does the
                # reservation bookkeeping
                self.cloud_provider.instances.delete(inst.id)
                removed.append(inst.id)
                self.log.info("garbage-collected orphan instance", instance=inst.id)
                from karpenter_tpu_torch import metrics

                metrics.GARBAGE_COLLECTED.inc()
            except NotFoundError:
                pass
            node = nodes_by_provider.get(inst.provider_id)
            if node is not None:
                self.cluster.unbind_pods(node.metadata.name)
                node.metadata.finalizers = []
                self.cluster.delete(Node, node.metadata.name)
        return removed
