"""NodeClaim metrics controller.

Rebuilds pkg/controllers/metrics/controller.go:33-106: export per-NodeClaim
cloud dimensions (instance type, zone, capacity type, nodepool, reservation)
as an info gauge, pruning series for claims that no longer exist so the
registry never leaks cardinality across claim churn.

Copy of karpenter_tpu/controllers/metrics_controller.py, imports rewritten to the port's.
"""
from __future__ import annotations

from typing import Dict, Tuple

from karpenter_tpu_torch.apis import NodeClaim, NodePool, labels as wk
from karpenter_tpu_torch import metrics
from karpenter_tpu_torch.kwok.cluster import Cluster
from karpenter_tpu_torch.scheduling import Resources
from karpenter_tpu_torch.logging import get_logger

INSTANCE_INFO = metrics.REGISTRY.gauge(
    "karpenter_cloudprovider_instance_info",
    "Per-nodeclaim cloud instance dimensions (value is always 1).",
    labels=("nodeclaim", "instance_type", "zone", "capacity_type", "nodepool", "reservation_id"),
)

# generic status-condition metrics (reference: the operatorpkg
# status.Controller registered per watched kind,
# pkg/controllers/controllers.go:98): object counts aggregated by
# (kind, condition type, status, reason) -- bounded cardinality no matter
# how many objects churn -- plus a transition counter bumped whenever an
# object's condition changes status between sweeps.
STATUS_CONDITION_COUNT = metrics.REGISTRY.gauge(
    "karpenter_status_condition_count",
    "Objects per (kind, condition type, condition status, reason).",
    labels=("kind", "type", "condition_status", "reason"),
)
STATUS_CONDITION_TRANSITIONS = metrics.REGISTRY.counter(
    "karpenter_status_condition_transitions_total",
    "Condition status changes observed between metric sweeps.",
    labels=("kind", "type", "condition_status"),
)


class MetricsController:
    log = get_logger("metrics")

    def __init__(self, cluster: Cluster):
        self.cluster = cluster
        self._series: Dict[str, Tuple] = {}  # claim name -> label values
        # (kind, object name, condition type) -> status, for transitions
        self._cond_last: Dict[Tuple[str, str, str], str] = {}
        self._cond_series: set = set()  # live (kind, type, status, reason) keys

    def _labels_of(self, claim: NodeClaim) -> Dict[str, str]:
        l = claim.metadata.labels
        return {
            "nodeclaim": claim.metadata.name,
            "instance_type": l.get(wk.INSTANCE_TYPE_LABEL, ""),
            "zone": l.get(wk.ZONE_LABEL, ""),
            "capacity_type": l.get(wk.CAPACITY_TYPE_LABEL, ""),
            "nodepool": l.get(wk.NODEPOOL_LABEL, ""),
            "reservation_id": l.get(wk.LABEL_CAPACITY_RESERVATION_ID, ""),
        }

    def reconcile_all(self) -> int:
        live = {}
        for claim in self.cluster.list(NodeClaim):
            if not claim.launched():
                continue
            labels = self._labels_of(claim)
            live[claim.metadata.name] = tuple(labels[n] for n in INSTANCE_INFO.label_names)
            INSTANCE_INFO.set(1.0, **labels)
        # prune series for claims that disappeared or changed dimensions --
        # remove, never zero, so claim churn cannot grow cardinality
        label_names = INSTANCE_INFO.label_names
        for name, values in list(self._series.items()):
            if live.get(name) != values:
                INSTANCE_INFO.remove(**dict(zip(label_names, values)))
        if len(live) != len(self._series):
            self.log.debug(
                "instance info series", series=len(live), pruned=len(self._series) - len(live)
            )
        self._series = live
        self._sweep_conditions()
        self._aggregate_pool_status()
        return len(live)

    def _aggregate_pool_status(self) -> None:
        """NodePool.status.resources: aggregate capacity of the pool's
        launched claims (the core's nodepool counter controller --
        `kubectl get nodepool` shows it; limits are judged against live
        usage elsewhere, this is the observability surface). DELETING
        claims still count: a draining instance holds real (billed)
        capacity until it is actually gone, and INSTANCE_INFO above uses
        the same membership. Updated only on change so steady state
        writes nothing."""
        totals: Dict[str, Resources] = {}
        for claim in self.cluster.list(NodeClaim):
            pool_name = claim.nodepool_name
            if not pool_name or not claim.launched():
                continue
            totals[pool_name] = totals.get(pool_name, Resources()) + claim.capacity
        from karpenter_tpu_torch.kube.client import ApiError, NotFound as HttpNotFound
        from karpenter_tpu_torch.kwok.cluster import Conflict, NotFound

        for pool in self.cluster.list(NodePool):
            want = totals.get(pool.metadata.name, Resources())
            if pool.status_resources != want:
                pool.status_resources = want
                try:
                    self.cluster.update(pool)
                except (Conflict, NotFound, HttpNotFound):
                    pass  # stale read vs a concurrent writer/deleter: next sweep retries
                except (ApiError, OSError) as e:  # kube mode: a racing delete
                    # or apiserver hiccup (HTTP error or transport failure --
                    # socket/ssl errors are OSErrors) must not abort the whole
                    # operator tick (ADVICE round 4); the sweep is idempotent
                    # next tick
                    self.log.warning("pool status update failed", error=str(e))


    def _sweep_conditions(self) -> None:
        """Aggregate every object's status conditions into the bounded
        (kind, type, status, reason) gauge and count transitions."""
        from karpenter_tpu_torch.apis import NodePool, TPUNodeClass

        counts: Dict[Tuple[str, str, str, str], int] = {}
        seen: Dict[Tuple[str, str, str], str] = {}
        for kind in (NodeClaim, TPUNodeClass, NodePool):
            for obj in self.cluster.list(kind):
                for cond in obj.status_conditions.all():
                    key = (kind.KIND, cond.type, cond.status, cond.reason or "")
                    counts[key] = counts.get(key, 0) + 1
                    # creation timestamp in the key: a deleted object and a
                    # same-named successor are different objects, and the
                    # successor's first status must not read as a transition
                    tkey = (kind.KIND, obj.metadata.name, obj.metadata.creation_timestamp, cond.type)
                    seen[tkey] = cond.status
                    prev = self._cond_last.get(tkey)
                    if prev is not None and prev != cond.status:
                        STATUS_CONDITION_TRANSITIONS.inc(
                            kind=kind.KIND, type=cond.type, condition_status=cond.status
                        )
        self._cond_last = seen
        label_names = ("kind", "type", "condition_status", "reason")
        for key, n in counts.items():
            STATUS_CONDITION_COUNT.set(float(n), **dict(zip(label_names, key)))
        # prune series whose (kind,type,status,reason) disappeared so the
        # gauge never reports stale objects
        for key in self._cond_series - set(counts):
            STATUS_CONDITION_COUNT.remove(**dict(zip(label_names, key)))
        self._cond_series = set(counts)
