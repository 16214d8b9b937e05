"""Pod and Node object model for the in-memory cluster.

Trimmed copy of karpenter_tpu/apis/pod.py (the disruption helpers --
deletion cost, do-not-disrupt -- belong to the consolidation slice).

The reference consumes real corev1.Pod/Node through the core scheduler; this
framework carries the subset of those objects the scheduling and disruption
paths actually read: requests, node selector / required node affinity,
tolerations, topology spread, (anti-)affinity, priority, ownership, and
node binding.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Mapping, Optional, Sequence

from karpenter_tpu_torch.apis.objects import APIObject
from karpenter_tpu_torch.scheduling import Requirement, Requirements, Resources, Taint, Toleration


@dataclass
class TopologySpreadConstraint:
    max_skew: int
    topology_key: str
    when_unsatisfiable: str = "DoNotSchedule"  # or ScheduleAnyway
    label_selector: Dict[str, str] = field(default_factory=dict)

    def hard(self) -> bool:
        return self.when_unsatisfiable == "DoNotSchedule"


@dataclass
class PodAffinityTerm:
    label_selector: Dict[str, str] = field(default_factory=dict)
    topology_key: str = "kubernetes.io/hostname"
    anti: bool = False


# spec-token intern table (utils.InternTable: monotone ids, safe clears):
# the raw token is a nested tuple whose hash the 50k-pod grouping loop
# would otherwise recompute on EVERY dict probe (measured ~2.5 ms/tick at
# 50k); interning at CONSTRUCTION -- watch-ingestion time, off the
# scheduling-latency path -- makes the hot-loop key a trivially-hashed
# int. Content-equal tuples intern to the same int, so token semantics
# (equality == shared spec) are unchanged. After an overflow clear, a
# live pod KEEPS its old int and still takes the token path; safety rests
# solely on the monotone counter never reusing ids (round-5 review).
from karpenter_tpu_torch.utils import InternTable as _InternTable

_SPEC_TOKENS = _InternTable()
_intern_spec_token = _SPEC_TOKENS.intern


class Pod(APIObject):
    KIND = "Pod"

    def __init__(
        self,
        name: str,
        namespace: str = "default",
        requests: Optional[Resources] = None,
        limits: Optional[Resources] = None,
        node_selector: Optional[Mapping[str, str]] = None,
        node_affinity_terms: Sequence[Sequence[Requirement]] = (),
        preferred_node_affinity_terms: Sequence = (),
        tolerations: Sequence[Toleration] = (),
        topology_spread: Sequence[TopologySpreadConstraint] = (),
        affinity_terms: Sequence[PodAffinityTerm] = (),
        preferred_affinity_terms: Sequence = (),
        priority: int = 0,
        labels: Optional[Dict[str, str]] = None,
        annotations: Optional[Dict[str, str]] = None,
        owner_kind: str = "ReplicaSet",
        scheduling_gates: Sequence[str] = (),
        volume_claims: Sequence[str] = (),
    ):
        super().__init__(name=name)
        self.metadata.namespace = namespace
        self.metadata.labels = dict(labels or {})
        self.metadata.annotations = dict(annotations or {})
        self.requests = requests or Resources()
        self.limits = limits or Resources()
        self.node_selector = dict(node_selector or {})
        # required node affinity: OR over terms, each term a list of Requirements
        self.node_affinity_terms = [list(t) for t in node_affinity_terms]
        # preferred node affinity: (weight, [Requirement]) pairs. Scheduled
        # via the core's preference-relaxation model (oracle.schedule):
        # preferences apply as requirements, and on failure the lowest-
        # weight one is dropped and the pod retried, until it places.
        self.preferred_node_affinity_terms = [
            (int(w), list(term)) for w, term in preferred_node_affinity_terms
        ]
        self.tolerations = list(tolerations)
        self.topology_spread = list(topology_spread)
        self.affinity_terms = list(affinity_terms)
        # preferred pod (anti-)affinity: (weight, PodAffinityTerm) pairs,
        # scheduled by the SAME relaxation ladder as preferred node
        # affinity (oracle._place_pod): all preferences apply as required
        # terms, strongest set first; each failed attempt drops the
        # lowest-weight preference of EITHER kind and retries
        self.preferred_affinity_terms = [
            (int(w), t) for w, t in preferred_affinity_terms
        ]
        self.priority = priority
        self.owner_kind = owner_kind  # "" = bare pod (blocks consolidation)
        self.scheduling_gates = list(scheduling_gates)
        # PVC references (claim names in the pod's namespace). Resolution
        # into solver vocabulary -- attach counts + bound-zone pins -- is
        # external (apis/storage.effective_pods) because it depends on
        # claim state at SCHEDULE time, not construction time; the
        # scheduler swaps in resolved copies, so claim-carrying pods
        # must not ride the shared-spec token fast path below.
        self.volume_claims = tuple(volume_claims)

        # status / spec binding
        self.node_name: str = ""
        self.phase: str = "Pending"
        # memoized grouping signature + interned signature id
        # (solver/encode.group_pods); pod specs are immutable post-creation
        # in k8s, so computing once is sound
        self._group_sig: Optional[tuple] = None
        self._sig_id: Optional[int] = None  # interned signature id (monotone)
        # shared-spec grouping token: ReplicaSet replicas share their spec,
        # and callers decoding watch events intern the spec objects once per
        # template -- so pods constructed from the SAME argument objects are
        # structurally identical by construction. The token is the tuple of
        # those objects' ids; _spec_refs pins them so an id can never be
        # reused while any pod carrying it is alive, which makes token
        # equality a sound proxy for spec equality between LIVE pods. The
        # batch grouper (solver/encode.group_pods) then runs its expensive
        # structural path once per distinct token instead of once per pod --
        # the difference between ~180 ms and ~20 ms for a 50k-pod cold tick.
        # Excluded from the token fast path, taking the (per-pod, still
        # interned) signature path instead:
        # - topology spread pods: grouping identity also depends on
        #   metadata.labels matching the constraint's selector (per-pod);
        # - pods with NESTED term structures (node/pod affinity,
        #   preferences): an inner-list element replaced in place between
        #   constructions changes no outer id, so no cheap fingerprint is
        #   sound against realistic spec reuse (round-4 review) -- and
        #   these are the rare shapes, several of which route to the
        #   oracle anyway.
        # The dominant template shapes (plain, nodeSelector, tolerations)
        # keep the token with FULL content fingerprints: a caller that
        # mutates the selector dict or the tolerations list between
        # constructions (any key, any element, same length or not) changes
        # the fingerprint, so pods never falsely share a token. Both
        # containers hold flat immutable-content entries (strings /
        # Toleration fields), so content covers them fully; construction is
        # off the scheduling-latency path, so the fingerprint cost lands on
        # watch ingestion, not the solve. The sole remaining doctrine hole
        # is mutating a shared Toleration OBJECT's attributes in place --
        # the same spec-immutability assumption the _group_sig memo
        # already relies on.
        if (
            topology_spread or node_affinity_terms or affinity_terms
            or preferred_node_affinity_terms or preferred_affinity_terms
            or volume_claims
        ):
            self._spec_refs = None
            self._spec_token = None
        else:
            # pin the id-carrying containers: an id is only a sound
            # identity while the object it names is alive (CPython reuses
            # freed addresses)
            self._spec_refs = (requests, node_selector, tolerations)
            self._spec_token = _intern_spec_token((
                id(requests), id(node_selector), id(tolerations),
                tuple(sorted(node_selector.items())) if node_selector else (),
                tuple((t.key, t.operator, t.value, t.effect) for t in tolerations)
                if tolerations else (),
            ))

    def grouping_signature(self) -> tuple:
        """A cheap structural signature over every spec field that affects
        scheduling identity. Pods with equal signatures are interchangeable
        for the batch solver; the expensive canonical key (Requirements
        construction + stable hash) is computed once per distinct signature,
        not per pod -- this is the hot-path grouping cache the 50k-pod
        scheduling budget depends on (reference hot loop #1:
        designs/bin-packing.md:17-43 pre-groups pods the same way).

        Construction is cold-path tuned: the common empty spec fields short-
        circuit to shared empty tuples, and the requests signature is
        memoized on the (template-shared) Resources object itself."""
        sig = self._group_sig
        if sig is None:
            ns = self.node_selector
            tol = self.tolerations
            tsc = self.topology_spread
            aff = self.affinity_terms
            nat = self.node_affinity_terms
            pref = self.preferred_node_affinity_terms
            labels = self.metadata.labels
            sig = self._group_sig = (
                self.requests.sig(),
                tuple(sorted(ns.items())) if ns else (),
                tuple(
                    tuple(
                        (r.key, r.complement, tuple(sorted(r.values)), r.greater_than, r.less_than, r.min_values)
                        for r in term
                    )
                    for term in nat
                ) if nat else (),
                tuple((t.key, t.operator, t.value, t.effect) for t in tol) if tol else (),
                tuple(
                    (
                        t.topology_key,
                        t.max_skew,
                        t.when_unsatisfiable,
                        tuple(sorted(t.label_selector.items())),
                        all(labels.get(k) == v for k, v in t.label_selector.items()),
                    )
                    for t in tsc
                ) if tsc else (),
                tuple(
                    (tuple(sorted(t.label_selector.items())), t.topology_key, t.anti)
                    for t in aff
                ) if aff else (),
                tuple(
                    (w, tuple(
                        (r.key, r.complement, tuple(sorted(r.values)), r.greater_than, r.less_than)
                        for r in term
                    ))
                    for w, term in pref
                ) if pref else (),
                tuple(
                    (w, tuple(sorted(t.label_selector.items())), t.topology_key, t.anti)
                    for w, t in self.preferred_affinity_terms
                ) if self.preferred_affinity_terms else (),
                # raw (unresolved) claim identity: claim-carrying pods only
                # reach the solver as resolved copies (apis/storage), but a
                # direct group_pods call must still not merge across claims
                self.volume_claims,
            )
        return sig

    # -- scheduling views ---------------------------------------------------
    def scheduling_requirements(self) -> List[Requirements]:
        """The pod's hard node constraints as alternatives (OR of ANDs):
        nodeSelector AND each nodeAffinity term. No affinity -> one term."""
        base = Requirements.from_labels(self.node_selector)
        if not self.node_affinity_terms:
            return [base]
        return [base.copy().add(*term) for term in self.node_affinity_terms]

    @property
    def bound(self) -> bool:
        return bool(self.node_name)

    @property
    def pending(self) -> bool:
        return self.phase == "Pending" and not self.node_name

    def schedulable(self) -> bool:
        return self.pending and not self.scheduling_gates and not self.deleting



class Node(APIObject):
    KIND = "Node"

    def __init__(
        self,
        name: str,
        labels: Optional[Dict[str, str]] = None,
        capacity: Optional[Resources] = None,
        allocatable: Optional[Resources] = None,
        taints: Sequence[Taint] = (),
        provider_id: str = "",
    ):
        super().__init__(name=name)
        self.metadata.labels = dict(labels or {})
        self.capacity = capacity or Resources()
        self.allocatable = allocatable if allocatable is not None else self.capacity
        self.taints: List[Taint] = list(taints)
        self.provider_id = provider_id
        self.ready: bool = False
        self.unschedulable: bool = False  # cordon

    @property
    def zone(self) -> Optional[str]:
        return self.metadata.labels.get("topology.kubernetes.io/zone")
