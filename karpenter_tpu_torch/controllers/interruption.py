"""Interruption controller: queue events -> node drain.

Rebuilds pkg/controllers/interruption/controller.go:96-248: polls the
interruption queue, parses each body through the (version, source,
detail-type)-keyed EventBridge parser registry
(interruption_messages.EventParser -- the five kinds: spot interruption,
scheduled health change, instance stopped, instance terminated, rebalance
recommendation, plus no-op), marks reclaimed spot capacity unavailable in
the ICE cache so the scheduler routes around it (controller.go:219-225),
deletes the affected NodeClaim (cordon-and-drain), and deletes the message.

Messages fan out over a worker pool exactly as the reference's
workqueue.ParallelizeUntil(ctx, 10, ...) (controller.go:119); the in-memory
cluster is lock-protected, and each worker keeps per-message isolation (a
bad message never blocks the batch).

Copy of karpenter_tpu/controllers/interruption.py, imports rewritten to the port's.
"""
from __future__ import annotations

import threading
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional

from karpenter_tpu_torch.apis import NodeClaim, labels as wk
from karpenter_tpu_torch.cache.unavailable_offerings import UnavailableOfferings
from karpenter_tpu_torch import metrics
from karpenter_tpu_torch.events import Recorder, WARNING
from karpenter_tpu_torch.cloud.api import QueueAPI
from karpenter_tpu_torch.controllers.interruption_messages import (
    KIND_NOOP,
    KIND_REBALANCE_RECOMMENDATION,
    KIND_SPOT_INTERRUPTED,
    EventParser,
    Message,
)
from karpenter_tpu_torch.kwok.cluster import Cluster
from karpenter_tpu_torch.logging import get_logger

PARALLELISM = 10  # reference: workqueue.ParallelizeUntil(ctx, 10, ...)


class InterruptionController:
    log = get_logger("interruption")

    def __init__(
        self,
        cluster: Cluster,
        queue: QueueAPI,
        unavailable: UnavailableOfferings,
        recorder: Optional[Recorder] = None,
        parser: Optional[EventParser] = None,
        max_per_sweep: int = 1000,
    ):
        self.cluster = cluster
        self.queue = queue
        self.unavailable = unavailable
        self.recorder = recorder or Recorder()
        self.parser = parser or EventParser()
        # bounded per-sweep intake (overload hardening): an interruption
        # STORM must not grow one sweep unboundedly -- past the bound the
        # still-queued remainder carries over to the next sweep (messages
        # stay on the queue; nothing is dropped), counted into
        # karpenter_interruption_deferred_total. 0 = unbounded (the
        # throughput bench's mode).
        self.max_per_sweep = int(max_per_sweep)
        # True when the LAST sweep stopped at its bound: the deferral is
        # counted only when the carried-over messages are actually
        # RECEIVED next sweep (the queue API cannot be peeked, and a
        # sweep whose bound landed exactly on the final message must not
        # report a deferral that never happened)
        self._bound_hit = False
        # serializes the deleting-check + delete + count: two workers
        # handling duplicate events for one instance must terminate (and
        # count) the claim exactly once
        self._drain_lock = threading.Lock()

    def reconcile(self, max_messages: int = 10,
                  max_per_sweep: Optional[int] = None) -> int:
        """One poll sweep; returns messages handled. The reference requeues
        immediately while messages remain (:114-136); callers loop. The
        intake is BOUNDED per sweep (max_per_sweep, default from the
        constructor): past the bound the sweep returns and the remainder
        stays queued for the next sweep, so an interruption storm costs
        bounded tick time instead of one unbounded batch."""
        limit = self.max_per_sweep if max_per_sweep is None else int(max_per_sweep)
        handled = 0
        with ThreadPoolExecutor(max_workers=PARALLELISM) as pool:
            while True:
                want = max_messages if limit <= 0 else min(
                    max_messages, limit - handled)
                batch = self.queue.receive(want)
                if not batch:
                    # the previous sweep's bound left nothing behind after
                    # all: no deferral to report
                    self._bound_hit = False
                    return handled
                if handled == 0 and self._bound_hit:
                    # the previous sweep's bound left work behind and
                    # this sweep found messages waiting: count the
                    # deferral at the moment the carry-over is observed.
                    # A bound landing exactly on the last queued message
                    # counts nothing UNLESS fresh messages arrived in the
                    # gap -- indistinguishable without queue visibility,
                    # and under the arrival stream that makes it happen
                    # the bound genuinely is deferring capacity anyway.
                    self._bound_hit = False
                    metrics.INTERRUPTION_DEFERRED.inc()
                list(pool.map(self._process, batch))
                handled += len(batch)
                if 0 < limit <= handled:
                    # carry-over: whatever is still queued waits for the
                    # next sweep (the queue holds it durably)
                    self._bound_hit = True
                    self.log.info(
                        "interruption intake bound reached; deferring "
                        "any remainder to the next sweep",
                        handled=handled, bound=limit,
                    )
                    return handled

    def _process(self, msg) -> None:
        parsed = None
        try:
            # parsing stays INSIDE the isolation boundary: a pathological
            # body must neither strand the batch nor leave the message
            # undeleted (the contract the module docstring promises)
            parsed = self.parser.parse(msg.body)
            metrics.INTERRUPTION_RECEIVED.inc(kind=parsed.kind)
            self._handle(parsed)
        except Exception as e:  # noqa: BLE001 -- per-message isolation
            self.recorder.publish(
                parsed, "InterruptionHandlingFailed", str(e), type=WARNING
            )
        finally:
            self.queue.delete(msg.receipt)
            metrics.INTERRUPTION_DELETED.inc()

    # -- handling -----------------------------------------------------------
    def _claim_for_instance(self, instance_id: str) -> Optional[NodeClaim]:
        # O(1) via the status.instanceID field index when the operator
        # registered it (reference: NodeClaimInstanceIDIndexer,
        # pkg/operator/operator.go:284-305); a bare controller without the
        # index (unit tests) falls back to the scan
        if self.cluster.has_index(NodeClaim, "status.instanceID"):
            hits = self.cluster.by_index(NodeClaim, "status.instanceID", instance_id)
            return hits[0] if hits else None
        suffix = f"/{instance_id}"
        for claim in self.cluster.list(NodeClaim):
            if claim.provider_id.endswith(suffix):
                return claim
        return None

    def _handle(self, parsed: Message) -> None:
        if parsed.kind == KIND_NOOP:
            return
        for instance_id in parsed.instance_ids:
            claim = self._claim_for_instance(instance_id)
            if claim is None:
                continue
            if parsed.kind == KIND_REBALANCE_RECOMMENDATION:
                # advisory only: record, do not disrupt (reference treats
                # rebalance recommendations as events unless configured)
                self.recorder.publish(
                    claim, "RebalanceRecommendation", "capacity may be reclaimed soon"
                )
                continue
            if parsed.kind == KIND_SPOT_INTERRUPTED:
                # the pool is being reclaimed: negative-cache it so the
                # scheduler stops offering this (type, zone, spot) pool
                # (controller.go:219-225)
                itype = claim.instance_type
                zone = claim.zone
                if itype and zone:
                    self.unavailable.mark_unavailable(
                        itype, zone, wk.CAPACITY_TYPE_SPOT, reason="SpotInterruption"
                    )
            self.recorder.publish(
                claim, "Interrupted", f"{parsed.kind} for {instance_id}", type=WARNING
            )
            with self._drain_lock:
                if claim.deleting:
                    continue
                self.cluster.delete(NodeClaim, claim.metadata.name)
                metrics.NODECLAIMS_TERMINATED.inc(
                    nodepool=claim.nodepool_name or "", reason="interruption"
                )
                self.log.info(
                    "interruption drain",
                    nodeclaim=claim.metadata.name,
                    kind=parsed.kind,
                    instance=instance_id,
                )
