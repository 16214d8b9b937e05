"""Write-ahead intent journal: crash consistency at the cluster/cloud seam.

The reference provider survives operator crashes only via garbage
collection's 60 s grace window (controllers/garbagecollection.py): a crash
between a cloud launch and the NodeClaim status commit leaks the instance
for that window and leaves its pods pending. This journal closes the
window structurally, the way KubePACS (PAPERS.md) treats availability as a
first-class objective: every launch/terminate writes a DURABLE intent into
the coordination bus (the cluster store -- the same bus NodeClaims live
on, so it survives the process) BEFORE the cloud mutation, and resolves it
only after the claim status commit lands. The write order is the whole
protocol:

    launch:    create claim -> create intent(token) -> cloud launch(token)
               -> commit claim status -> resolve intent
    terminate: drain -> create intent(provider_id) -> cloud terminate
               -> drop finalizer -> resolve intent

An intent that survives a crash names exactly the work the restart
recovery sweep (controllers/recovery.py) must replay, and its idempotency
token -- stamped into the fleet call as a client token and onto the
instance as a tag (kwok/cloud.py INTENT_TOKEN_TAG) -- makes the replay
launch-at-most-once: the cloud returns the existing instance for a known
token instead of minting a double.

Tokens draw from a dedicated seeded stream (apis/objects.py
seed_intent_tokens) so trace replays stay byte-deterministic without
shifting the object-name stream the golden decision digests pin.

Every intent is stamped with the writer's fencing epoch
(karpenter_tpu_torch/fencing.py): recovery ignores nothing by epoch -- replay is
idempotent -- but the stamp makes a split-brain write auditable in
/debug/journal.

Copy of karpenter_tpu/journal.py, imports rewritten to the port's.
"""
from __future__ import annotations

from collections import deque
from typing import Dict, List, Optional

from karpenter_tpu_torch import metrics
from karpenter_tpu_torch.apis.objects import ProvisioningIntent, generate_intent_token
from karpenter_tpu_torch.logging import get_logger

# how many resolved intents /debug/journal remembers (in-memory, per
# process: an observability ring, not durable state)
RESOLVED_RING = 64


class IntentJournal:
    log = get_logger("journal")

    def __init__(self, cluster, fence=None):
        self.cluster = cluster
        self.fence = fence  # optional fencing.Fence: stamps epochs on records
        self._resolved_ring: deque = deque(maxlen=RESOLVED_RING)

    def _epoch(self) -> int:
        return self.fence.epoch if self.fence is not None else 0

    # -- write-ahead records -------------------------------------------------
    def begin_launch(self, claim) -> ProvisioningIntent:
        """Durable launch intent, written BEFORE the cloud call. Reuses an
        existing open intent for the claim (a relaunch after a crash whose
        recovery dropped nothing) so the token -- and therefore the cloud's
        idempotency key -- stays stable across retries."""
        from karpenter_tpu_torch.kwok.cluster import AlreadyExists

        name = f"launch-{claim.metadata.name}"
        existing = self.cluster.try_get(ProvisioningIntent, name)
        if existing is not None:
            return existing
        intent = ProvisioningIntent(
            name, op=ProvisioningIntent.OP_LAUNCH,
            claim_name=claim.metadata.name,
            token=generate_intent_token(), epoch=self._epoch(),
        )
        try:
            self.cluster.create(intent)
        except AlreadyExists:
            return self.cluster.get(ProvisioningIntent, name)
        metrics.JOURNAL_WRITES.inc(op="launch", event="begin")
        self._gauge()
        return intent

    def begin_terminate(self, claim) -> ProvisioningIntent:
        from karpenter_tpu_torch.kwok.cluster import AlreadyExists

        name = f"terminate-{claim.metadata.name}"
        existing = self.cluster.try_get(ProvisioningIntent, name)
        if existing is not None:
            return existing
        intent = ProvisioningIntent(
            name, op=ProvisioningIntent.OP_TERMINATE,
            claim_name=claim.metadata.name,
            token=generate_intent_token(), epoch=self._epoch(),
            provider_id=claim.provider_id,
        )
        try:
            self.cluster.create(intent)
        except AlreadyExists:
            return self.cluster.get(ProvisioningIntent, name)
        metrics.JOURNAL_WRITES.inc(op="terminate", event="begin")
        self._gauge()
        return intent

    def resolve(self, intent: ProvisioningIntent, outcome: str = "committed") -> None:
        """The claim status (or finalizer removal) committed: the intent has
        served its purpose and leaves the bus. `outcome` is bookkeeping for
        the metrics and the /debug/journal ring."""
        self.cluster.delete(ProvisioningIntent, intent.metadata.name)
        metrics.JOURNAL_WRITES.inc(op=intent.op, event=outcome)
        self._resolved_ring.append({
            "name": intent.metadata.name, "op": intent.op,
            "claim": intent.claim_name, "token": intent.token,
            "epoch": intent.epoch, "outcome": outcome,
        })
        self._gauge()

    # -- reads ---------------------------------------------------------------
    def open_intents(self) -> List[ProvisioningIntent]:
        return sorted(
            self.cluster.list(ProvisioningIntent),
            key=lambda i: i.metadata.name,
        )

    def open_tokens(self) -> Dict[str, ProvisioningIntent]:
        return {i.token: i for i in self.open_intents() if i.token}

    def _gauge(self) -> None:
        metrics.JOURNAL_OPEN.set(float(len(self.cluster.list(ProvisioningIntent))))

    def describe(self) -> dict:
        """The /debug/journal document: open intents off the bus plus the
        recently-resolved ring (loopback-only; operator/health.py)."""
        return {
            "open": [
                {
                    "name": i.metadata.name, "op": i.op, "claim": i.claim_name,
                    "token": i.token, "epoch": i.epoch,
                    "provider_id": i.provider_id,
                    "created": i.metadata.creation_timestamp,
                }
                for i in self.open_intents()
            ],
            "recently_resolved": list(self._resolved_ring),
        }
