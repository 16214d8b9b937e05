"""Restart recovery sweep: replay the intent journal on every election win.

The other half of the crash-consistency protocol (karpenter_tpu_torch/
journal.py): whatever the previous incarnation left mid-flight is exactly
the set of OPEN intents on the coordination bus, and this sweep -- run as
an on-election hook before the first controller sweep, on EVERY win, not
just the first -- replays each one to a safe state:

- launch intent, instance launched (found by its idempotency-token tag),
  claim present but status uncommitted  -> ADOPT: reflect the instance
  into the claim (CloudProvider.adopt) and commit, so the pod binds to
  capacity that already exists instead of a double-launch;
- launch intent, instance launched, claim gone/deleting -> the
  half-launch nobody wants: terminate the instance IMMEDIATELY (no
  60 s GC grace);
- launch intent, no instance -> the crash landed before the cloud
  mutation: drop the record (a surviving claim relaunches through the
  journaled lifecycle path, same token, idempotent);
- terminate intent -> re-issue the (idempotent) instance delete; a
  surviving claim finishes through the termination controller, a vanished
  one resolves here.

Every cloud mutation the sweep issues carries the NEW leader's fencing
epoch, so a deposed predecessor racing this sweep is rejected at the
cloud seam, not merged into it.

Copy of karpenter_tpu/controllers/recovery.py, imports rewritten to the port's.
"""
from __future__ import annotations

import time
from typing import Dict, Optional

from karpenter_tpu_torch import failpoints, metrics
from karpenter_tpu_torch.apis import NodeClaim
from karpenter_tpu_torch.apis.objects import ProvisioningIntent
from karpenter_tpu_torch.errors import NotFoundError
from karpenter_tpu_torch.logging import get_logger
from karpenter_tpu_torch.utils import parse_instance_id


class RecoverySweepController:
    log = get_logger("recovery")

    def __init__(self, cluster, cloud_provider, journal, recorder=None):
        self.cluster = cluster
        self.cloud_provider = cloud_provider
        self.journal = journal
        self.recorder = recorder
        self.last_sweep: Dict[str, int] = {}

    def sweep(self) -> Dict[str, int]:
        """Replay every open intent; returns outcome counts. Idempotent
        and crash-safe itself: a crash mid-sweep leaves the unprocessed
        intents open for the NEXT sweep (the crash.recovery failpoint
        drills exactly that)."""
        t0 = time.perf_counter()
        outcomes: Dict[str, int] = {}
        open_intents = self.journal.open_intents()
        # ONE describe for the whole sweep, indexed by token tag: a
        # per-intent by_token() would issue k unbatched full-fleet
        # describes back-to-back right after a restart -- exactly the
        # burst that trips a throttled cloud during recovery
        token_index = self._token_index() if open_intents else {}
        for intent in open_intents:
            # crash site: the recovery sweep itself dies mid-replay; the
            # remaining intents must survive for the next incarnation
            failpoints.eval("crash.recovery")
            try:
                outcome = self.replay_intent(intent, token_index)
            except Exception as e:  # noqa: BLE001 -- per-intent isolation
                # a throttled/erroring cloud must cost THIS intent's
                # replay, not the new leader's whole first tick (the
                # intent stays open for the next sweep); OperatorCrashed
                # is a BaseException and still propagates -- the
                # crash-during-recovery drill depends on it
                outcome = "failed"
                metrics.RECOVERY_SWEEP_INTENTS.inc(outcome=outcome)
                self.log.warning(
                    "intent replay failed; left open for the next sweep",
                    intent=intent.metadata.name, error=f"{type(e).__name__}: {e}",
                )
            outcomes[outcome] = outcomes.get(outcome, 0) + 1
        metrics.RECOVERY_SWEEP_DURATION.observe(time.perf_counter() - t0)
        self.last_sweep = outcomes
        if outcomes:
            self.log.info("recovery sweep replayed open intents", **outcomes)
        return outcomes

    def _token_index(self) -> Dict[str, object]:
        """Live cluster-owned instances keyed by intent-token tag, from
        ONE describe (the sweep's correlation read)."""
        from karpenter_tpu_torch.apis.objects import INTENT_TOKEN_KEY

        out: Dict[str, object] = {}
        for inst in self.cloud_provider.instances.list():
            token = inst.tags.get(INTENT_TOKEN_KEY)
            if token and inst.state not in ("terminated", "shutting-down"):
                out[token] = inst
        return out

    def replay_intent(self, intent: ProvisioningIntent,
                      token_index: Optional[Dict[str, object]] = None) -> str:
        """Replay ONE open intent to a safe state; also the janitor entry
        point garbage collection uses for intents orphaned DURING a reign
        (a claim deleted out-of-band -- e.g. the kwok lifecycle reaping a
        killed instance's claim -- strands its open intent with no
        restart in sight). Without a prebuilt token index the correlation
        read falls back to a single tag-filtered describe."""
        if intent.op == ProvisioningIntent.OP_LAUNCH:
            outcome = self._replay_launch(intent, token_index)
        else:
            outcome = self._replay_terminate(intent)
        metrics.RECOVERY_SWEEP_INTENTS.inc(outcome=outcome)
        return outcome

    def _owner_of(self, inst) -> "NodeClaim | None":
        """The claim (if any) whose committed provider id points at this
        instance -- the guard every terminate/adopt decision below runs
        first: a misdealt merged fleet batch can cross instances between
        claims, and killing an instance ANOTHER claim owns would turn a
        bookkeeping mixup into a real outage."""
        return next(
            (
                c for c in self.cluster.list(NodeClaim)
                if c.provider_id and parse_instance_id(c.provider_id) == inst.id
            ),
            None,
        )

    def _terminate_half_launch(self, intent: ProvisioningIntent, inst) -> str:
        try:
            self.cloud_provider.instances.delete(inst.id)
        except NotFoundError:
            pass
        self.journal.resolve(intent, "terminated_half_launch")
        self.log.info(
            "terminated half-launched instance", instance=inst.id,
            intent=intent.metadata.name,
        )
        return "terminated_half_launch"

    # -- launch intents ------------------------------------------------------
    def _replay_launch(self, intent: ProvisioningIntent,
                       token_index: Optional[Dict[str, object]] = None) -> str:
        claim = self.cluster.try_get(NodeClaim, intent.claim_name)
        inst = (
            token_index.get(intent.token) if token_index is not None
            else self.cloud_provider.instances.by_token(intent.token)
        )
        if inst is None:
            # crash landed before the cloud mutation: nothing to adopt.
            # A surviving claim relaunches through the journaled lifecycle
            # path with the SAME reused intent name/token (idempotent), so
            # dropping the record here loses nothing.
            self.journal.resolve(intent, "dropped")
            return "dropped"
        owner = self._owner_of(inst)
        if owner is not None and owner.metadata.name != intent.claim_name:
            # a DIFFERENT claim committed this instance (misdealt merged
            # batch): it is accounted for -- the record just goes
            self.journal.resolve(intent, "dropped")
            return "dropped"
        if claim is None or claim.deleting:
            # half-launch: the instance exists, its claim does not (or is
            # on its way out). Terminate NOW -- this is the leak the GC
            # grace window used to carry for 60 s.
            return self._terminate_half_launch(intent, inst)
        if claim.provider_id:
            if parse_instance_id(claim.provider_id) != inst.id:
                # the claim committed against a DIFFERENT instance and
                # nothing owns this token's instance: a true half-launch
                return self._terminate_half_launch(intent, inst)
            # launch AND commit both landed; only the resolve was lost
            self.journal.resolve(intent, "already_committed")
            return "already_committed"
        # the canonical repair: launch committed, claim status did not
        self.cloud_provider.adopt(claim, inst)
        self.cluster.update(claim)
        self.journal.resolve(intent, "adopted")
        if self.recorder is not None:
            self.recorder.publish(
                claim, "Adopted",
                f"recovery sweep adopted instance {inst.id} (uncommitted launch)",
            )
        self.log.info(
            "adopted instance into uncommitted claim",
            nodeclaim=claim.metadata.name, instance=inst.id,
        )
        return "adopted"

    # -- terminate intents ---------------------------------------------------
    def _replay_terminate(self, intent: ProvisioningIntent) -> str:
        claim = self.cluster.try_get(NodeClaim, intent.claim_name)
        if intent.provider_id:
            try:
                # idempotent: already-terminated instances no-op inside the
                # provider's delete
                self.cloud_provider.instances.delete(
                    parse_instance_id(intent.provider_id))
            except NotFoundError:
                pass
        if claim is None:
            # finalizer removal already landed (or the claim never had
            # one); the record is the last survivor
            self.journal.resolve(intent, "orphan_terminated")
            return "orphan_terminated"
        # the claim survives: the level-triggered termination controller
        # finishes the teardown (finalizer, node object) and resolves the
        # intent itself -- leave it open so a crash BETWEEN here and that
        # tick still has its record
        return "resumed_termination"
