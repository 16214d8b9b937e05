"""Interruption event schemas + parser registry.

Rebuilds the reference's message layer
(/root/reference/pkg/controllers/interruption/parser.go:1-93 and
messages/{spotinterruption,statechange,scheduledchange,
rebalancerecommendation,noop}) for this cloud's event bus: every body is an
EventBridge-shaped envelope -- `version` / `source` / `detail-type` metadata
with a nested `detail` document -- and a parser is selected by the exact
(version, source, detail-type) triple. Unknown triples, empty bodies, and
malformed JSON all degrade to a no-op message rather than erroring the
batch (parser.go:76-93).

The five message kinds and their wire shapes:

  Spot Instance Interruption Warning   (cloud.compute@SpotInterruption v0)
      detail: {"instance-id": ..., "instance-action": "terminate"}
  Instance State-change Notification   (cloud.compute@StateChange v1)
      detail: {"instance-id": ..., "state": "stopping|stopped|
               shutting-down|terminated"}  (other states parse to None ->
               noop, statechange/parser accepted-states set)
  Health Event                         (cloud.health@HealthEvent v0)
      detail: {"service": "COMPUTE", "eventTypeCategory":
               "scheduledChange", "affectedEntities":
               [{"entityValue": instance-id}, ...]}  (other services /
               categories -> noop, scheduledchange/parser)
  Instance Rebalance Recommendation    (cloud.compute@Rebalance v0)
      detail: {"instance-id": ...}
  no-op                                (everything else)

Copy of karpenter_tpu/controllers/interruption_messages.py, imports rewritten to the port's.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

# kinds (reference messages/types.go Kind values)
KIND_SPOT_INTERRUPTED = "spot_interrupted"
KIND_SCHEDULED_CHANGE = "scheduled_change"
KIND_INSTANCE_STOPPED = "instance_stopped"
KIND_INSTANCE_TERMINATED = "instance_terminated"
KIND_REBALANCE_RECOMMENDATION = "rebalance_recommendation"
KIND_NOOP = "no_op"

SOURCE_COMPUTE = "cloud.compute"
SOURCE_HEALTH = "cloud.health"

DETAIL_SPOT_INTERRUPTION = "Spot Instance Interruption Warning"
DETAIL_STATE_CHANGE = "Instance State-change Notification"
DETAIL_HEALTH_EVENT = "Health Event"
DETAIL_REBALANCE = "Instance Rebalance Recommendation"

_STOPPED_STATES = {"stopping", "stopped"}
_ACCEPTED_STATES = {"stopping", "stopped", "shutting-down", "terminated"}

_HEALTH_SERVICE = "COMPUTE"
_HEALTH_CATEGORY = "scheduledChange"


@dataclass
class Metadata:
    """The EventBridge envelope (reference messages/types.go Metadata)."""

    version: str = ""
    source: str = ""
    detail_type: str = ""
    id: str = ""
    region: str = ""
    account: str = ""
    time: str = ""
    resources: List[str] = field(default_factory=list)

    @classmethod
    def from_doc(cls, doc: dict) -> "Metadata":
        resources = doc.get("resources")
        return cls(
            version=str(doc.get("version", "")),
            source=str(doc.get("source", "")),
            detail_type=str(doc.get("detail-type", "")),
            id=str(doc.get("id", "")),
            region=str(doc.get("region", "")),
            account=str(doc.get("account", "")),
            time=str(doc.get("time", "")),
            # arbitrary JSON may put a scalar here; never raise on shape
            resources=[str(r) for r in resources] if isinstance(resources, list) else [],
        )


@dataclass
class Message:
    """A parsed interruption event: which instances, what kind."""

    metadata: Metadata
    kind: str
    instance_ids: List[str] = field(default_factory=list)
    state: str = ""

    def start_time(self) -> str:
        return self.metadata.time


def _noop(metadata: Optional[Metadata] = None) -> Message:
    return Message(metadata=metadata or Metadata(), kind=KIND_NOOP)


class SpotInterruptionParser:
    """cloud.compute@SpotInterruption (reference
    messages/spotinterruption/parser.go)."""

    version = "0"
    source = SOURCE_COMPUTE
    detail_type = DETAIL_SPOT_INTERRUPTION

    def parse(self, metadata: Metadata, detail: dict) -> Optional[Message]:
        iid = str(detail.get("instance-id", ""))
        if not iid:
            return None
        return Message(metadata=metadata, kind=KIND_SPOT_INTERRUPTED, instance_ids=[iid])


class StateChangeParser:
    """cloud.compute@StateChange (reference messages/statechange/parser.go:
    only the accepted states produce a message; stopping/stopped map to
    InstanceStopped, shutting-down/terminated to InstanceTerminated)."""

    version = "1"
    source = SOURCE_COMPUTE
    detail_type = DETAIL_STATE_CHANGE

    def parse(self, metadata: Metadata, detail: dict) -> Optional[Message]:
        iid = str(detail.get("instance-id", ""))
        state = str(detail.get("state", "")).lower()
        if not iid or state not in _ACCEPTED_STATES:
            return None
        kind = KIND_INSTANCE_STOPPED if state in _STOPPED_STATES else KIND_INSTANCE_TERMINATED
        return Message(metadata=metadata, kind=kind, instance_ids=[iid], state=state)


class ScheduledChangeParser:
    """cloud.health@HealthEvent (reference messages/scheduledchange/
    parser.go: only COMPUTE scheduledChange events; every affected entity
    is an instance)."""

    version = "0"
    source = SOURCE_HEALTH
    detail_type = DETAIL_HEALTH_EVENT

    def parse(self, metadata: Metadata, detail: dict) -> Optional[Message]:
        if (
            str(detail.get("service", "")) != _HEALTH_SERVICE
            or str(detail.get("eventTypeCategory", "")) != _HEALTH_CATEGORY
        ):
            return None
        entities = detail.get("affectedEntities")
        if not isinstance(entities, list):
            return None
        ids = [
            str(e.get("entityValue", ""))
            for e in entities
            if isinstance(e, dict) and e.get("entityValue")
        ]
        if not ids:
            return None
        return Message(metadata=metadata, kind=KIND_SCHEDULED_CHANGE, instance_ids=ids)


class RebalanceRecommendationParser:
    """cloud.compute@Rebalance (reference
    messages/rebalancerecommendation/parser.go)."""

    version = "0"
    source = SOURCE_COMPUTE
    detail_type = DETAIL_REBALANCE

    def parse(self, metadata: Metadata, detail: dict) -> Optional[Message]:
        iid = str(detail.get("instance-id", ""))
        if not iid:
            return None
        return Message(
            metadata=metadata, kind=KIND_REBALANCE_RECOMMENDATION, instance_ids=[iid]
        )


DEFAULT_PARSERS = (
    SpotInterruptionParser(),
    StateChangeParser(),
    ScheduledChangeParser(),
    RebalanceRecommendationParser(),
)


class EventParser:
    """Parser registry keyed by the (version, source, detail-type) triple
    (reference parser.go:32-74). Everything unrecognized is a no-op."""

    def __init__(self, *parsers):
        ps = parsers or DEFAULT_PARSERS
        self._by_key: Dict[Tuple[str, str, str], object] = {
            (p.version, p.source, p.detail_type): p for p in ps
        }

    def parse(self, raw: str) -> Message:
        if not raw:
            return _noop()
        try:
            doc = json.loads(raw)
        except (json.JSONDecodeError, TypeError):
            return _noop()
        if not isinstance(doc, dict):
            return _noop()
        metadata = Metadata.from_doc(doc)
        parser = self._by_key.get((metadata.version, metadata.source, metadata.detail_type))
        if parser is None:
            return _noop(metadata)
        detail = doc.get("detail")
        if not isinstance(detail, dict):
            return _noop(metadata)
        msg = parser.parse(metadata, detail)
        return msg if msg is not None else _noop(metadata)
