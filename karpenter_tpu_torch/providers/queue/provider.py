"""Interruption-queue provider.

Rebuilds pkg/providers/sqs/sqs.go:32-113: the thin access layer between the
interruption controller and the cloud queue -- queue-URL discovery
(memoized; rediscovered on queue recreation), receive with long-poll-shaped
batching, and per-message deletion. Keeping this behind a provider (rather
than the controller holding the raw API) matches the reference seam so the
controller is testable against any queue fake.

Copy of karpenter_tpu/providers/queue/provider.py, imports rewritten to the port's.
"""
from __future__ import annotations

from typing import List

from karpenter_tpu_torch.cloud.api import QueueAPI
from karpenter_tpu_torch.cloud.types import QueueMessage

MAX_RECEIVE = 10  # reference receives <=10 messages per poll


class QueueProvider:
    """The QueueAPI handle is already queue-addressed (the cloud layer binds
    the queue at construction), so unlike sqs.go there is no URL to memoize
    here -- url() is a passthrough used for discovery/liveness checks."""

    def __init__(self, queue_api: QueueAPI):
        self.queue_api = queue_api

    # -- discovery -----------------------------------------------------------
    def url(self) -> str:
        return self.queue_api.queue_url()

    # -- message flow ---------------------------------------------------------
    def receive(self, max_messages: int = MAX_RECEIVE) -> List[QueueMessage]:
        return self.queue_api.receive(max_messages=max_messages)

    def delete(self, receipt: str) -> None:
        self.queue_api.delete(receipt)

    def send(self, body: str) -> None:
        """Test/emulator convenience (the production feed is the cloud event
        bridge, not the controller)."""
        self.queue_api.send(body)
