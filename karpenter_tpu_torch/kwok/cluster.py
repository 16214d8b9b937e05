"""In-memory cluster: the kube-apiserver stand-in.

The reference's coordination bus is the Kubernetes API server (CRDs, watches,
field indexers -- SURVEY.md section 2.4). This module provides the same
contract for a standalone process: a thread-safe typed object store with
resource-version optimistic concurrency, finalizer-aware deletion, event
listeners (watch analogue), and the pod/node relational queries the
scheduler and disruption controllers need (the role of the core's cluster
state, state.NewCluster at cmd/controller/main.go:43).

Everything is step-driven and clock-injected: no background goroutine
analogues, so tests and the benchmark rig are deterministic.

Copy of karpenter_tpu/kwok/cluster.py, imports rewritten to the port's.
"""
from __future__ import annotations

import threading
from typing import Callable, Dict, Iterable, List, Optional, Tuple, Type

from karpenter_tpu_torch.apis import (
    DaemonSet, NodeClaim, NodePool, Pod, Node, PersistentVolumeClaim,
    PodDisruptionBudget, StorageClass, TPUNodeClass,
)
from karpenter_tpu_torch.apis.storage import CSINode
from karpenter_tpu_torch.apis.objects import APIObject, Lease, ProvisioningIntent
from karpenter_tpu_torch.cache.ttl import Clock
from karpenter_tpu_torch.scheduling import Resources


class Conflict(Exception):
    """Optimistic-concurrency failure (stale resourceVersion)."""


class NotFound(Exception):
    pass


class AlreadyExists(Exception):
    pass


EventHandler = Callable[[str, APIObject], None]  # (event_type, object)



class RelationalQueries:
    """Read-only pod/node/claim relations derived purely from list() --
    shared verbatim by the in-memory Cluster and the apiserver-backed
    KubeCluster so the two buses can never drift on these semantics."""

    def pending_pods(self) -> List[Pod]:
        return [p for p in self.list(Pod) if p.schedulable()]

    def pods_on_node(self, node_name: str) -> List[Pod]:
        return [p for p in self.list(Pod) if p.node_name == node_name]

    def nodeclaim_for_node(self, node: Node) -> Optional[NodeClaim]:
        for nc in self.list(NodeClaim):
            if nc.provider_id and nc.provider_id == node.provider_id:
                return nc
        return None

    def node_for_nodeclaim(self, claim: NodeClaim) -> Optional[Node]:
        for n in self.list(Node):
            if n.provider_id and n.provider_id == claim.provider_id:
                return n
        return None

    def node_usage(self, node_name: str, vol_index=None) -> Resources:
        """One node's usage; delegates to node_usage_map so exactly ONE
        copy of the accounting formula exists (a drifted duplicate --
        usage omitting the PODS axis -- was a round-5 bug)."""
        return self.node_usage_map([node_name], vol_index)[node_name]

    def node_usage_map(self, node_names, vol_index=None) -> Dict[str, Resources]:
        """Usage for MANY nodes in ONE pod pass (the per-node form is
        O(all pods) per call on stores without a pod index -- kube's
        TTL-cached list -- which made per-tick snapshots O(nodes x pods)
        at fleet scale, round 5). THE accounting formula lives here:
        each bound pod charges its requests plus ONE slot on the pods
        axis (the solver, oracle, and binder all charge PODS:1 per
        placement), and claim-carrying pods charge their resolved volume
        attachments (apis/storage; hot callers pass a prebuilt index)."""
        from karpenter_tpu_torch.apis.storage import PersistentVolumeClaim, pod_volume_requests, VolumeIndex
        from karpenter_tpu_torch.scheduling import resources as res

        out: Dict[str, Resources] = {n: Resources() for n in node_names}
        one_pod = Resources.from_base_units({res.PODS: 1})
        for p in self.list(Pod):
            total = out.get(p.node_name)
            if total is None:
                continue
            total = total + p.requests + one_pod
            if p.volume_claims:
                if vol_index is None:
                    vol_index = VolumeIndex(self.list(PersistentVolumeClaim))
                total = total + pod_volume_requests(p, vol_index)
            out[p.node_name] = total
        return out

    def nodepool_usage(self, nodepool_name: str) -> Resources:
        from karpenter_tpu_torch.apis import labels as wk

        total = Resources()
        for nc in self.list(NodeClaim):
            if nc.metadata.labels.get(wk.NODEPOOL_LABEL) == nodepool_name and not nc.deleting:
                total = total + nc.capacity
        return total



class Cluster(RelationalQueries):
    KINDS: Tuple[Type[APIObject], ...] = (
        Pod, Node, NodeClaim, NodePool, TPUNodeClass, Lease,
        ProvisioningIntent,
        PodDisruptionBudget, DaemonSet, PersistentVolumeClaim, StorageClass,
        CSINode,
    )

    POD_NODE_INDEX = "spec.nodeName"
    NODE_PROVIDER_INDEX = "spec.providerID"
    CLAIM_PROVIDER_INDEX = "status.providerID"

    def __init__(self, clock: Optional[Clock] = None):
        self.clock = clock or Clock()
        self._lock = threading.RLock()
        self._store: Dict[str, Dict[str, APIObject]] = {k.KIND: {} for k in self.KINDS}
        self._version = 0
        self._handlers: List[EventHandler] = []
        # field indexers (reference: mgr.GetFieldIndexer().IndexField on
        # NodeClaim status fields, pkg/operator/operator.go:284-305):
        # (kind, index name) -> key fn; per index a forward map key ->
        # {object name: object} and a reverse map object name -> key
        self._indexers: Dict[Tuple[str, str], Callable[[APIObject], Optional[str]]] = {}
        self._indexes: Dict[Tuple[str, str], Tuple[Dict[str, Dict[str, APIObject]], Dict[str, str]]] = {}
        # built-in pod-by-node index: pods_on_node was an O(all pods) scan
        # per call, quadratic in the 50k full-loop E2E (round 5). Writes
        # go through create/update/delete (bind_pod/unbind_pods do), which
        # is the informer contract by_index already documents.
        self.add_field_index(Pod, self.POD_NODE_INDEX, lambda p: p.node_name or None)
        # providerID indexes: node<->claim correlation ran as linear scans
        # per call -- O(claims x nodes) per controller tick at fleet scale
        self.add_field_index(Node, self.NODE_PROVIDER_INDEX,
                             lambda n: n.provider_id or None)
        self.add_field_index(NodeClaim, self.CLAIM_PROVIDER_INDEX,
                             lambda c: c.provider_id or None)

    def pods_on_node(self, node_name: str) -> List[Pod]:  # type: ignore[override]
        return self.by_index(Pod, self.POD_NODE_INDEX, node_name)

    def nodeclaim_for_node(self, node: Node) -> Optional[NodeClaim]:  # type: ignore[override]
        if not node.provider_id:
            return None
        hits = self.by_index(NodeClaim, self.CLAIM_PROVIDER_INDEX, node.provider_id)
        return hits[0] if hits else None

    def node_for_nodeclaim(self, claim: NodeClaim) -> Optional[Node]:  # type: ignore[override]
        if not claim.provider_id:
            return None
        hits = self.by_index(Node, self.NODE_PROVIDER_INDEX, claim.provider_id)
        return hits[0] if hits else None

    # -- watch --------------------------------------------------------------
    def on_event(self, handler: EventHandler) -> None:
        self._handlers.append(handler)

    # -- field indexes ------------------------------------------------------
    def add_field_index(
        self, kind: Type[APIObject], name: str, key_fn: Callable[[APIObject], Optional[str]]
    ) -> None:
        """Register an O(1) lookup over one derived key, maintained on
        every create/update/delete -- the in-memory analogue of
        controller-runtime's field indexer. key_fn returns None for
        objects that should not be indexed (e.g. an empty providerID
        before launch)."""
        with self._lock:
            self._indexers[(kind.KIND, name)] = key_fn
            fwd: Dict[str, Dict[str, APIObject]] = {}
            rev: Dict[str, str] = {}
            for obj in self._store[kind.KIND].values():
                key = key_fn(obj)
                if key:
                    fwd.setdefault(key, {})[obj.metadata.name] = obj
                    rev[obj.metadata.name] = key
            self._indexes[(kind.KIND, name)] = (fwd, rev)

    def by_index(self, kind: Type[APIObject], name: str, key: str) -> List[APIObject]:
        """Objects whose indexed key equals `key`. Hits are re-verified
        against key_fn so an object mutated WITHOUT a cluster.update()
        call is filtered rather than returned stale (informer caches have
        the same contract: writes must go through the store)."""
        with self._lock:
            entry = self._indexes.get((kind.KIND, name))
            if entry is None:
                raise KeyError(f"no field index {name!r} for {kind.KIND}")
            key_fn = self._indexers[(kind.KIND, name)]
            return [o for o in entry[0].get(key, {}).values() if key_fn(o) == key]

    def has_index(self, kind: Type[APIObject], name: str) -> bool:
        with self._lock:
            return (kind.KIND, name) in self._indexes

    def _index_touch(self, obj: APIObject, removed: bool = False) -> None:
        """Under self._lock: re-key `obj` in every index on its kind."""
        kind = type(obj).KIND
        oname = obj.metadata.name
        for (ikind, iname), key_fn in self._indexers.items():
            if ikind != kind:
                continue
            fwd, rev = self._indexes[(ikind, iname)]
            old = rev.pop(oname, None)
            if old is not None:
                bucket = fwd.get(old)
                if bucket is not None:
                    bucket.pop(oname, None)
                    if not bucket:
                        fwd.pop(old, None)
            if not removed:
                key = key_fn(obj)
                if key:
                    fwd.setdefault(key, {})[oname] = obj
                    rev[oname] = key

    def _emit(self, event: str, obj: APIObject) -> None:
        for h in self._handlers:
            h(event, obj)

    # -- CRUD ---------------------------------------------------------------
    def create(self, obj: APIObject) -> APIObject:
        # admission: the store is the apiserver stand-in, so the CRD
        # validation rules run here (apis/validation.py; reference: CEL
        # rules compiled into pkg/apis/crds/*.yaml, enforced at admission)
        from karpenter_tpu_torch.apis.validation import admit

        admit(obj)
        with self._lock:
            kind = type(obj).KIND
            if obj.metadata.name in self._store[kind]:
                raise AlreadyExists(f"{kind}/{obj.metadata.name}")
            self._version += 1
            obj.metadata.resource_version = self._version
            if not obj.metadata.creation_timestamp:
                obj.metadata.creation_timestamp = self.clock.now()
            self._store[kind][obj.metadata.name] = obj
            self._index_touch(obj)
        self._emit("ADDED", obj)
        return obj

    def get(self, kind: Type[APIObject], name: str) -> APIObject:
        with self._lock:
            obj = self._store[kind.KIND].get(name)
            if obj is None:
                raise NotFound(f"{kind.KIND}/{name}")
            return obj

    def try_get(self, kind: Type[APIObject], name: str) -> Optional[APIObject]:
        with self._lock:
            return self._store[kind.KIND].get(name)

    def list(self, kind: Type[APIObject], predicate: Optional[Callable[[APIObject], bool]] = None) -> List[APIObject]:
        with self._lock:
            items = list(self._store[kind.KIND].values())
        if predicate is not None:
            items = [o for o in items if predicate(o)]
        return items

    def update(self, obj: APIObject, expect_version: Optional[int] = None) -> APIObject:
        from karpenter_tpu_torch.apis.validation import admit

        admit(obj)
        with self._lock:
            kind = type(obj).KIND
            current = self._store[kind].get(obj.metadata.name)
            if current is None:
                raise NotFound(f"{kind}/{obj.metadata.name}")
            if expect_version is not None and current.metadata.resource_version != expect_version:
                raise Conflict(f"{kind}/{obj.metadata.name}: version {expect_version} is stale")
            self._version += 1
            obj.metadata.resource_version = self._version
            self._store[kind][obj.metadata.name] = obj
            self._index_touch(obj)
        self._emit("MODIFIED", obj)
        return obj

    def delete(self, kind: Type[APIObject], name: str) -> Optional[APIObject]:
        """Finalizer-aware: with finalizers set, marks deleting and returns
        the object; actual removal happens once finalizers clear."""
        with self._lock:
            obj = self._store[kind.KIND].get(name)
            if obj is None:
                return None
            if obj.metadata.finalizers:
                if obj.metadata.deletion_timestamp is None:
                    obj.metadata.deletion_timestamp = self.clock.now()
                    self._version += 1
                    obj.metadata.resource_version = self._version
                result = obj
            else:
                del self._store[kind.KIND][name]
                self._index_touch(obj, removed=True)
                result = None
        if result is not None:
            self._emit("DELETING", obj)
        else:
            self._emit("DELETED", obj)
        return result

    def remove_finalizer(self, obj: APIObject, finalizer: str) -> None:
        with self._lock:
            if finalizer in obj.metadata.finalizers:
                obj.metadata.finalizers.remove(finalizer)
            if obj.metadata.deletion_timestamp is not None and not obj.metadata.finalizers:
                self._store[type(obj).KIND].pop(obj.metadata.name, None)
                self._index_touch(obj, removed=True)
                removed = True
            else:
                removed = False
        if removed:
            self._emit("DELETED", obj)

    # -- relational writes (reads shared via RelationalQueries) -------------
    def bind_pod(self, pod: Pod, node: Node) -> None:
        pod.node_name = node.metadata.name
        pod.phase = "Running"
        self.update(pod)

    def unbind_pods(self, node_name: str) -> List[Pod]:
        """Node went away: owned pods return to Pending (controller
        re-creation abstracted to an in-place reset)."""
        out = []
        for p in self.pods_on_node(node_name):
            p.node_name = ""
            p.phase = "Pending"
            self.update(p)
            out.append(p)
        return out
