"""Pure-Python FFD scheduling oracle.

Copy of karpenter_tpu/solver/oracle.py.

The correctness reference for the TPU solver: a readable, sequential
re-implementation of the core scheduler's provisioning simulation
(First-Fit-Decreasing bin-packing per designs/bin-packing.md:17-43, the
behavior the external sigs.k8s.io/karpenter module implements -- SURVEY.md
section 2.3). Every TPU solve is differential-tested against this oracle on
randomized instances.

Semantics covered:
- pods sorted by descending dominant resource (FFD)
- existing capacity first, then open "in-flight" node groups, then new groups
- a node group holds a *set* of still-feasible instance types that narrows
  as pods accumulate (the core's NodeClaim simulation)
- requirements algebra + taints/tolerations + nodepool weights and limits
- hard topology spread over zone/hostname, hostname pod anti-affinity
  (stateful constraints; the scan-with-carry part of the TPU formulation)
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from karpenter_tpu_torch.apis import NodePool, Pod, labels as wk
from karpenter_tpu_torch.apis.pod import TopologySpreadConstraint
from karpenter_tpu_torch.providers.instancetype.types import InstanceType
from karpenter_tpu_torch.scheduling import (
    Operator, Requirement, Requirements, Resources, Taint, tolerates_all,
)
from karpenter_tpu_torch.scheduling import resources as res
from karpenter_tpu_torch.scheduling.requirements import min_values_shortfall
from karpenter_tpu_torch.solver import encode
from karpenter_tpu_torch.solver.encode import pod_sort_key
from karpenter_tpu_torch.solver.spread import soft_zone_tsc as _soft_zone_tsc

# labels the scheduler may leave undefined on a not-yet-launched node
_ALLOW_UNDEFINED = wk.WELL_KNOWN_LABELS


@dataclass
class ExistingNode:
    """A live (or nominated in-flight) node the simulation can pack onto."""

    name: str
    labels: Dict[str, str]
    allocatable: Resources
    taints: List[Taint] = field(default_factory=list)
    used: Resources = field(default_factory=Resources)

    def remaining(self) -> Resources:
        return self.allocatable - self.used


@dataclass
class NewNodeGroup:
    """A simulated NodeClaim: pods packed together onto one future node."""

    nodepool: NodePool
    requirements: Requirements
    instance_types: List[InstanceType]
    taints: List[Taint]
    pods: List[Pod] = field(default_factory=list)
    requested: Resources = field(default_factory=lambda: Resources.from_base_units({res.PODS: 0}))

    def add_requested(self, pod: Pod) -> Resources:
        return self.requested + pod.requests + Resources.from_base_units({res.PODS: 1})


@dataclass
class SchedulingResult:
    existing_assignments: Dict[str, str] = field(default_factory=dict)  # pod name -> node name
    new_groups: List[NewNodeGroup] = field(default_factory=list)
    unschedulable: Dict[str, str] = field(default_factory=dict)  # pod name -> reason

    def node_count(self) -> int:
        return len(self.new_groups)


def _dominant_size(pod: Pod) -> Tuple[float, float]:
    return (pod.requests.get(res.CPU), pod.requests.get(res.MEMORY))


def _fits_type(it: InstanceType, requested: Resources) -> bool:
    return requested.fits(it.allocatable())


class _TopologyState:
    """Domain counts for hard topology-spread constraints, keyed by the
    spreading selector so different workloads spread independently."""

    def __init__(self):
        self._counts: Dict[tuple, Dict[str, int]] = {}

    @staticmethod
    def _key(tsc: TopologySpreadConstraint) -> tuple:
        return (tsc.topology_key, tuple(sorted(tsc.label_selector.items())))

    def seed_existing(self, pods_by_node: Dict[str, List[Pod]], node_labels: Dict[str, Dict[str, str]]):
        # seeds mirror live accounting (_record_placement) exactly: hard
        # constraints count when the pod matches its own selector, and the
        # single EFFECTIVE soft zone preference counts once -- a pod with
        # both a hard and a soft constraint on one selector must not seed
        # the shared (topology_key, selector) count twice (round-4 review)
        for node, pods in pods_by_node.items():
            for p in pods:
                for tsc in p.topology_spread:
                    if not tsc.hard() or not _pod_matches_selector(p, tsc.label_selector):
                        continue
                    domain = node_labels.get(node, {}).get(tsc.topology_key)
                    if domain:
                        self.count(tsc)[domain] = self.count(tsc).get(domain, 0) + 1
                t = _soft_zone_tsc(p)
                if t is not None:
                    domain = node_labels.get(node, {}).get(wk.ZONE_LABEL)
                    if domain:
                        self.count(t)[domain] = self.count(t).get(domain, 0) + 1

    def count(self, tsc: TopologySpreadConstraint) -> Dict[str, int]:
        return self._counts.setdefault(self._key(tsc), {})

    def allowed_domains(
        self, tsc: TopologySpreadConstraint, candidates: Set[str], all_domains: Optional[Set[str]] = None
    ) -> Set[str]:
        """Candidate domains where adding one pod keeps skew <= max_skew.
        The global minimum is over ALL eligible domains (k8s semantics --
        empty domains count), not just the candidates reachable here."""
        counts = self.count(tsc)
        if not candidates:
            return set()
        domain_universe = all_domains if all_domains else candidates
        global_min = min(counts.get(d, 0) for d in domain_universe)
        return {d for d in candidates if counts.get(d, 0) + 1 - global_min <= tsc.max_skew}

    def add(self, tsc: TopologySpreadConstraint, domain: str) -> None:
        self.count(tsc)[domain] = self.count(tsc).get(domain, 0) + 1


def _pod_matches_selector(pod: Pod, selector: Dict[str, str]) -> bool:
    return all(pod.metadata.labels.get(k) == v for k, v in selector.items())


class Scheduler:
    """One simulation run over a fixed snapshot (pods, pools, capacity)."""

    def __init__(
        self,
        nodepools: Sequence[NodePool],
        instance_types: Dict[str, List[InstanceType]],  # nodepool name -> catalog
        existing_nodes: Sequence[ExistingNode] = (),
        pods_by_node: Optional[Dict[str, List[Pod]]] = None,
        nodepool_usage: Optional[Dict[str, Resources]] = None,
        zones: Optional[Set[str]] = None,
        objective: str = "price",
        daemon_overhead: Optional[Dict[str, Resources]] = None,
    ):
        # per-nodepool daemonset overhead: every FRESH node of the pool
        # reserves these resources before workload pods pack onto it
        # (apis/daemonset.overhead_by_pool; the reference core sizes its
        # simulated nodes the same way). Existing nodes are unaffected --
        # their daemon pods are already bound and counted in usage.
        self.daemon_overhead = daemon_overhead or {}
        # packing objective, mirrored from TPUSolver: "price" restricts a
        # fresh group's candidate types to the min-price-per-pod envelope
        # (solver/ffd.py _ffd_body); "fit" keeps every compatible type
        self.objective = objective
        self._zero_overhead = Resources()
        self.nodepools = sorted(nodepools, key=lambda p: -p.weight)
        self.instance_types = instance_types
        self.existing = list(existing_nodes)
        self.topology = _TopologyState()
        pods_by_node = pods_by_node or {}
        self.topology.seed_existing(pods_by_node, {n.name: n.labels for n in self.existing})
        self.usage = dict(nodepool_usage or {})
        self.zones = zones or set()
        self._feasible_zone_cache: Dict[tuple, Set[str]] = {}
        # price-envelope bookkeeping (objective == "price"): the envelope a
        # class's FIRST group opens with is reused by its later groups --
        # the batch solver opens all of a class's groups in one scan step
        # with one envelope, so recomputing with a shrunken remaining count
        # would diverge. Keys are the device's canonical class key merged
        # with the pool context (encode._class_key orientation).
        self._env_cache: Dict[tuple, Optional[Tuple[float, float]]] = {}
        self._env_key_memo: Dict[tuple, tuple] = {}
        self._env_totals: Dict[str, Dict[tuple, int]] = {}
        self._env_placed: Dict[tuple, int] = {}
        self._sched_pods: List[Pod] = []
        # soft-spread relaxation state: True only inside a _place_pod retry
        # where the pod's ScheduleAnyway zone preference has been dropped
        self._soft_relaxed = False
        # per-placement memo for _zone_choice: topology counts change only
        # when a placement lands (_record_placement clears), so the pinned
        # zone is invariant across the existing-node loop -- without the
        # memo every candidate node pays a catalog/zone scan (round-4
        # review). _attempt_gen keys one ladder attempt's entries.
        self._zone_choice_memo: Dict[tuple, Optional[str]] = {}
        self._attempt_gen = 0
        # pod-(anti-)affinity occupancy (reference core scheduling algebra,
        # SURVEY.md section 2.3; BOTH directions enforced):
        #   _labels_on   location (node name / group id) -> pod labels
        #   _zone_pods   zone -> pod labels (zone-topology terms; a group's
        #                pods count once the group is pinned to one zone)
        #   _anti_in     (topology key, domain) -> anti-affinity selectors of
        #                resident pods (SYMMETRY: residents repel newcomers)
        #   _all_labels  every placed pod's labels (bootstrap rule: a
        #                required-affinity pod whose selector matches no pod
        #                anywhere may place iff it matches itself)
        self._labels_on: Dict[str, List[Dict[str, str]]] = {}
        self._zone_pods: Dict[str, List[Dict[str, str]]] = {}
        self._anti_in: Dict[Tuple[str, str], List[Dict[str, str]]] = {}
        self._all_labels: List[Dict[str, str]] = []
        # label-pair indexes (round 5): affinity checks at 50k scale must
        # not scan every placed pod's labels per group try. Single-key
        # equality selectors (the overwhelmingly common shape) resolve in
        # O(1) against these; multi-key selectors narrow to the first
        # pair's bucket and verify the full selector there.
        #   _kv_labels   (k, v) -> label dicts of every placed pod with it
        #   _loc_kv      (location, k, v) -> count at that node/group
        #   _zone_kv     (zone, k, v) -> count in that zone
        #   _loc_groups  (k, v) -> open groups hosting a matching pod (for
        #                candidate pruning in _attempt_placement)
        self._kv_labels: Dict[Tuple[str, str], List[Dict[str, str]]] = {}
        self._loc_kv: Dict[Tuple[str, str, str], int] = {}
        self._zone_kv: Dict[Tuple[str, str, str], int] = {}
        self._loc_groups: Dict[Tuple[str, str], List] = {}
        self._loc_groups_seen: Dict[Tuple[str, str], set] = {}
        self._open_seq_next = 0
        # per-type scaled capacity + offering tuples for _price_open_filter
        # (immutable for this Scheduler's snapshot lifetime)
        self._type_stats_memo: Dict[int, tuple] = {}
        # per-group axis-wise max allocatable (an upper bound -- see
        # _try_group's precheck; never invalidated, survivors only shrink)
        self._gmax_cache: Dict[int, Resources] = {}
        # (group id, requests sig) pairs the capacity upper bound has
        # permanently rejected (see _try_group)
        self._cap_reject: set = set()
        node_labels = {n.name: n.labels for n in self.existing}
        for node, pods in pods_by_node.items():
            self._labels_on[node] = [dict(p.metadata.labels) for p in pods]
            zone = node_labels.get(node, {}).get(wk.ZONE_LABEL)
            for p in pods:
                labels = dict(p.metadata.labels)
                self._all_labels.append(labels)
                self._index_labels(labels, node, zone)
                if zone:
                    self._zone_pods.setdefault(zone, []).append(labels)
                self._record_anti_terms(p, node, zone)

    def _index_labels(self, labels: Dict[str, str], location: str, zone: Optional[str]) -> None:
        for k, v in labels.items():
            self._kv_labels.setdefault((k, v), []).append(labels)
            lk = (location, k, v)
            self._loc_kv[lk] = self._loc_kv.get(lk, 0) + 1
            if zone:
                zk = (zone, k, v)
                self._zone_kv[zk] = self._zone_kv.get(zk, 0) + 1

    # -- constraint checks --------------------------------------------------
    @staticmethod
    def _match(labels: Dict[str, str], selector: Dict[str, str]) -> bool:
        return all(labels.get(k) == v for k, v in selector.items())

    def _record_anti_terms(self, pod: Pod, location: str, zone: Optional[str]) -> None:
        for term in pod.affinity_terms:
            if not term.anti:
                continue
            if term.topology_key == wk.HOSTNAME_LABEL:
                self._anti_in.setdefault((wk.HOSTNAME_LABEL, location), []).append(
                    dict(term.label_selector)
                )
            elif term.topology_key == wk.ZONE_LABEL and zone:
                self._anti_in.setdefault((wk.ZONE_LABEL, zone), []).append(
                    dict(term.label_selector)
                )

    def _any_match(self, selector: Dict[str, str]) -> bool:
        if not selector:
            return bool(self._all_labels)
        # narrow to the first pair's bucket; verify the full selector there
        k, v = next(iter(selector.items()))
        bucket = self._kv_labels.get((k, v))
        if not bucket:
            return False
        if len(selector) == 1:
            return True
        return any(self._match(labels, selector) for labels in bucket)

    def _domain_has_match(self, domain: str, selector: Dict[str, str],
                          counts: Dict, fallback: List[Dict[str, str]]) -> bool:
        """Does `domain` (a location or zone) host a pod matching
        `selector`? O(1) for single-key selectors via `counts`; multi-key
        selectors verify against the domain's label list `fallback`."""
        if not selector:
            return bool(fallback)
        if len(selector) == 1:
            k, v = next(iter(selector.items()))
            return counts.get((domain, k, v), 0) > 0
        return any(self._match(l, selector) for l in fallback)

    def _affinity_ok(self, pod: Pod, location: str, domain_labels: Dict[str, str]) -> bool:
        """All required pod-(anti-)affinity terms of `pod` admit placing it
        at `location` (an existing node or an open group), and no resident
        pod's anti-affinity term repels it (full symmetry). Zone-topology
        terms use the location's concrete zone when it has one
        (`domain_labels`); a multi-zone group is treated as containing no
        zone domain, so zone-affinity pods narrow or reject it instead
        (see _affinity_narrow)."""
        labels = pod.metadata.labels
        zone = domain_labels.get(wk.ZONE_LABEL)
        for term in pod.affinity_terms:
            sel = term.label_selector
            if term.topology_key == wk.HOSTNAME_LABEL:
                has = self._domain_has_match(
                    location, sel, self._loc_kv, self._labels_on.get(location, []))
            elif term.topology_key == wk.ZONE_LABEL:
                has = zone is not None and self._domain_has_match(
                    zone, sel, self._zone_kv, self._zone_pods.get(zone, []))
            else:
                has = False
            if term.anti:
                if has:
                    return False
                # own anti-term also applies to itself landing in a domain
                # already holding a match -- covered above; nothing else
            else:
                if has:
                    continue
                # bootstrap: no matching pod anywhere -> self-match admits
                if not self._any_match(sel) and self._match(labels, sel):
                    continue
                return False
        # symmetry: residents' anti-affinity selectors repel this pod
        for l_sel in self._anti_in.get((wk.HOSTNAME_LABEL, location), []):
            if self._match(labels, l_sel):
                return False
        if zone:
            for l_sel in self._anti_in.get((wk.ZONE_LABEL, zone), []):
                if self._match(labels, l_sel):
                    return False
        return True

    def _affinity_narrow(self, pod: Pod, reqs: Requirements) -> Optional[Requirements]:
        """Zone-topology affinity narrows a NEW group's zone requirement to
        the admissible zones (the core narrows NodeClaim requirements the
        same way): positive terms restrict to zones holding a matching pod
        (any zone under the bootstrap rule); anti terms exclude zones
        holding a match. Returns None when no zone survives."""

        out = reqs
        for term in pod.affinity_terms:
            if term.topology_key != wk.ZONE_LABEL:
                continue
            sel = term.label_selector
            matching = {
                z for z in self._zone_pods
                if self._domain_has_match(z, sel, self._zone_kv, self._zone_pods[z])
            }
            if term.anti:
                if matching:
                    out = out.copy()
                    out.add(Requirement(wk.ZONE_LABEL, Operator.NOT_IN, sorted(matching)))
            else:
                if not matching:
                    if not self._any_match(sel) and self._match(pod.metadata.labels, sel):
                        continue  # bootstrap: any zone
                    return None
                out = out.copy()
                out.add(Requirement(wk.ZONE_LABEL, Operator.IN, sorted(matching)))
        return out

    def _zone_choice(
        self, pod: Pod, tsc: TopologySpreadConstraint, skew: bool = True
    ) -> Optional[str]:
        """The pod's pinned spread zone: lexicographically-first minimum-
        count zone among skew-eligible feasible domains (the same choice
        _spread_narrow_group makes when opening/joining groups, computed
        against the highest-weight pool COMPATIBLE with the pod). Pinning
        the SAME zone for existing-node packing keeps the oracle
        differentially equal to the batch path, whose split pass assigns
        zones before node packing. skew=False is the soft-spread variant:
        a preference biases placement but never gates on max_skew."""
        # the preference-relaxation ladder rebinds node_affinity_terms per
        # attempt, and the choice below reads scheduling_requirements();
        # the monotonic attempt counter invalidates the memo across
        # attempts (a stale None would reject every existing node after
        # the preference was dropped -- round-4 review; an id() of the
        # transient terms list is NOT sound, CPython reuses freed
        # addresses across attempts)
        memo_key = (id(pod), id(tsc), skew, self._soft_relaxed, self._attempt_gen)
        if memo_key in self._zone_choice_memo:
            return self._zone_choice_memo[memo_key]
        pod_reqs = pod.scheduling_requirements()[0]
        pool = next(
            (
                p
                for p in self.nodepools
                if p.requirements().compatible(pod_reqs, allow_undefined=_ALLOW_UNDEFINED)
            ),
            None,
        )
        base = pod_reqs
        if pool is not None:
            base = pool.requirements().copy().add(*base)
        requested = pod.requests + Resources.from_base_units({res.PODS: 1})
        domains = self._feasible_spread_zones(pool, base, requested)
        candidates = self._group_zone_domains(base) & domains
        if skew:
            allowed = self.topology.allowed_domains(tsc, candidates, all_domains=domains)
        else:
            allowed = candidates
        if not allowed:
            choice = None
        else:
            counts = self.topology.count(tsc)
            choice = min(sorted(allowed), key=lambda z: counts.get(z, 0))
        self._zone_choice_memo[memo_key] = choice
        return choice

    def _spread_ok_existing(self, pod: Pod, node: ExistingNode) -> bool:
        for tsc in pod.topology_spread:
            if not tsc.hard() or not _pod_matches_selector(pod, tsc.label_selector):
                continue
            domain = node.labels.get(tsc.topology_key)
            if domain is None:
                return False
            if tsc.topology_key == wk.ZONE_LABEL:
                # zone spread packs onto existing nodes only in the pod's
                # PINNED (min-count) zone -- a stricter deterministic
                # refinement of the skew rule (min-count is always within
                # skew) shared with the batch solver's split pass
                if domain != self._zone_choice(pod, tsc):
                    return False
                continue
            candidates = self._domains_for(tsc)
            if domain not in self.topology.allowed_domains(tsc, candidates, all_domains=candidates):
                return False
        if not self._soft_relaxed:
            # soft zone preference: existing-node joins honor the pinned
            # (min-count) zone like hard spread; the relaxation retry
            # (_place_pod) lifts this when the pinned placement fails
            t = _soft_zone_tsc(pod)
            if t is not None:
                choice = self._zone_choice(pod, t, skew=False)
                if choice is not None and node.labels.get(wk.ZONE_LABEL) != choice:
                    return False
        return True

    def _domains_for(self, tsc: TopologySpreadConstraint) -> Set[str]:
        if tsc.topology_key == wk.ZONE_LABEL:
            return set(self.zones)
        if tsc.topology_key == wk.HOSTNAME_LABEL:
            domains = {n.name for n in self.existing}
            domains.update(self.topology.count(tsc).keys())
            return domains
        return set(self.topology.count(tsc).keys())

    def _record_placement(self, pod: Pod, location: str, domain_labels: Dict[str, str],
                          group=None) -> None:
        # a landed placement can move topology counts: pinned-zone memos
        # computed against the previous counts are now stale
        self._zone_choice_memo.clear()
        labels = dict(pod.metadata.labels)
        self._labels_on.setdefault(location, []).append(labels)
        self._all_labels.append(labels)
        zone = domain_labels.get(wk.ZONE_LABEL)
        self._index_labels(labels, location, zone)
        if group is not None:
            # candidate-pruning buckets: a positive hostname-affinity pod
            # only ever joins a group already hosting a match
            # (_attempt_placement), so groups index by resident label pair.
            # Membership via a companion id-set: a list scan here would be
            # O(groups) per placed label pair (round-5 review)
            for kv in labels.items():
                seen = self._loc_groups_seen.setdefault(kv, set())
                if id(group) not in seen:
                    seen.add(id(group))
                    self._loc_groups.setdefault(kv, []).append(group)
        if zone:
            self._zone_pods.setdefault(zone, []).append(labels)
        self._record_anti_terms(pod, location, zone)
        for tsc in pod.topology_spread:
            if not tsc.hard() or not _pod_matches_selector(pod, tsc.label_selector):
                continue
            domain = domain_labels.get(tsc.topology_key)
            if domain:
                self.topology.add(tsc, domain)
        if not self._soft_relaxed:
            # applied soft zone preferences count (the split pass adds its
            # delivered water-fill the same way); RELAXED placements do not
            # -- the device cannot know their zones pre-solve
            t = _soft_zone_tsc(pod)
            if t is not None:
                domain = domain_labels.get(wk.ZONE_LABEL)
                if domain:
                    self.topology.add(t, domain)

    # -- existing-node packing ---------------------------------------------
    def _try_existing(self, pod: Pod, result: SchedulingResult) -> bool:
        for node in self.existing:
            if not tolerates_all(pod.tolerations, node.taints):
                continue
            compatible = any(alt.matches_labels(node.labels) for alt in pod.scheduling_requirements())
            if not compatible:
                continue
            needed = pod.requests + Resources.from_base_units({res.PODS: 1})
            if not needed.fits(node.remaining()):
                continue
            if not self._affinity_ok(pod, node.name, node.labels):
                continue
            if not self._spread_ok_existing(pod, node):
                continue
            node.used = node.used + needed
            result.existing_assignments[pod.metadata.name] = node.name
            self._record_placement(pod, node.name, node.labels)
            return True
        return False

    # -- new-node packing ---------------------------------------------------
    def _group_zone_domains(self, group_or_reqs) -> Set[str]:
        reqs = group_or_reqs.requirements if isinstance(group_or_reqs, NewNodeGroup) else group_or_reqs
        zreq = reqs.get(wk.ZONE_LABEL)
        if zreq is None:
            return set(self.zones)
        if zreq.complement:
            return {z for z in self.zones if zreq.matches(z)}
        return set(zreq.values)

    def _ovh(self, pool: NodePool) -> Resources:
        return self.daemon_overhead.get(pool.name) or self._zero_overhead

    def _feasible_spread_zones(self, pool: Optional[NodePool], base: Requirements, requested: Resources) -> Set[str]:
        """Zones where some instance type of `pool` is compatible with the
        pod+pool requirements pinned to that zone, fits one pod, and has an
        available offering there. These are the spread DOMAINS for the pod:
        a zone with no schedulable capacity neither receives pods nor drags
        the global minimum down (kube-scheduler's eligible-domain rule; the
        batch solver computes the same set from catalog tensors)."""

        if pool is None:
            return set(self.zones)
        key = (pool.name, base.stable_hash(), tuple(requested.to_vector()))
        hit = self._feasible_zone_cache.get(key)
        if hit is not None:
            return hit
        items = self.instance_types.get(pool.name, [])
        out: Set[str] = set()
        for z in self.zones:
            reqz = base.copy().add(Requirement(wk.ZONE_LABEL, Operator.IN, [z]))
            for it in items:
                if (
                    it.requirements.compatible(reqz)
                    and _fits_type(it, requested + self._ovh(pool))
                    and any(o.available and o.zone == z for o in it.offerings)
                ):
                    out.add(z)
                    break
        self._feasible_zone_cache[key] = out
        return out

    def _spread_narrow_group(
        self,
        pod: Pod,
        reqs: Requirements,
        base_fn=None,
        pool: Optional[NodePool] = None,
    ) -> Optional[Requirements]:
        """Apply hard zone-spread by pinning the pod's globally-chosen zone;
        returns None when the pod cannot go where spreading demands.

        Spec: GREEDY MIN-COUNT spreading over FEASIBLE domains -- every
        spread pod goes to the lexicographically-first minimum-count zone
        among candidates that are skew-eligible AND have schedulable
        capacity (so an exhausted zone steers spreading instead of
        livelocking it); `base_fn` supplies the pod+pool requirements,
        independent of any particular group, built lazily since most pods
        carry no spread constraints. A group is joinable only if its zones
        include the chosen zone. This is a deterministic, stricter
        refinement of the k8s max-skew contract and exactly what the batch
        solver's water-fill computes (solver/spread.py), keeping the two
        paths differentially equal. Hostname spread over a new node is
        always a fresh domain (count 0): allowed iff 1 - global_min <=
        max_skew."""

        out = reqs
        for tsc in pod.topology_spread:
            if not tsc.hard() or not _pod_matches_selector(pod, tsc.label_selector):
                continue
            if tsc.topology_key == wk.ZONE_LABEL:
                base = base_fn() if base_fn is not None else out
                requested = pod.requests + Resources.from_base_units({res.PODS: 1})
                domains = self._feasible_spread_zones(pool, base, requested)
                candidates = self._group_zone_domains(base) & domains
                allowed = self.topology.allowed_domains(
                    tsc, candidates, all_domains=domains
                )
                if not allowed:
                    return None
                counts = self.topology.count(tsc)
                want = min(sorted(allowed), key=lambda z: counts.get(z, 0))
                if want not in self._group_zone_domains(out):
                    return None  # this group cannot host the chosen zone
                out = out.copy()
                out.add(Requirement(wk.ZONE_LABEL, Operator.IN, [want]))
            elif tsc.topology_key == wk.HOSTNAME_LABEL:
                counts = self.topology.count(tsc)
                domains = self._domains_for(tsc)
                global_min = min((counts.get(d, 0) for d in domains), default=0)
                if 1 - global_min > tsc.max_skew:
                    return None
        if not self._soft_relaxed:
            # soft (ScheduleAnyway) zone spread: pin the min-count feasible
            # zone as a PREFERENCE -- same water-fill choice as hard but
            # with no skew gate; with no feasible candidate it constrains
            # nothing (the split pass passes such classes through), and a
            # pinned placement that fails is retried relaxed (_place_pod)
            t = _soft_zone_tsc(pod)
            if t is not None:
                base = base_fn() if base_fn is not None else out
                requested = pod.requests + Resources.from_base_units({res.PODS: 1})
                domains = self._feasible_spread_zones(pool, base, requested)
                candidates = self._group_zone_domains(base) & domains
                if candidates:
                    counts = self.topology.count(t)
                    want = min(sorted(candidates), key=lambda z: counts.get(z, 0))
                    if want not in self._group_zone_domains(out):
                        return None  # this group cannot host the preferred zone
                    out = out.copy()
                    out.add(Requirement(wk.ZONE_LABEL, Operator.IN, [want]))
        return out

    def _try_group(self, pod: Pod, group: NewNodeGroup, pod_reqs: Requirements) -> bool:
        # negative capacity memo: once a group rejects THIS request shape
        # on the capacity upper bound, it rejects it forever (requested
        # only grows, the survivor set only shrinks) -- consecutive
        # same-shaped pods scanning a packed fleet skip in O(1) instead of
        # re-paying the checks below (round 5: suffix anchors scanning
        # ~600 full device groups dominated the mixed-batch tick)
        cap_key = (id(group), pod.requests.sig())
        if cap_key in self._cap_reject:
            return False
        if not tolerates_all(pod.tolerations, group.taints):
            return False
        if not group.requirements.compatible(pod_reqs, allow_undefined=None):
            return False
        if not self._affinity_ok(pod, id(group), group.requirements.labels()):
            return False
        # capacity upper-bound precheck: if even the roomiest type the
        # group has EVER had cannot hold the new total, no survivor can --
        # reject before the merge/narrow/survivor-scan cost. Sound because
        # survivor lists only shrink and per-type allocatable is fixed, so
        # a stale cached max stays an upper bound (round 5: suffix pods
        # probing tightly packed device groups made this the hot reject).
        requested = group.add_requested(pod)
        effective = requested + self._ovh(group.nodepool)
        if not effective.fits(self._group_max_alloc(group)):
            self._cap_reject.add(cap_key)
            return False
        merged = group.requirements.copy().add(*pod_reqs)
        # zone topology spread narrows the merged requirements; the chosen
        # zone is computed pool-wide (pod+pool), not from this group's
        # already-narrowed zones, so joining can never dodge the spread
        narrowed = self._spread_narrow_group(
            pod, merged,
            base_fn=lambda: group.nodepool.requirements().copy().add(*pod_reqs),
            pool=group.nodepool,
        )
        if narrowed is None:
            return False
        # zone-topology affinity narrows the joined group's zones too; an
        # empty intersection surfaces as zero surviving types below
        narrowed = self._affinity_narrow(pod, narrowed)
        if narrowed is None:
            return False
        # NOTE: an "empty In" requirement here is NOT provably dead -- the
        # algebra deliberately conflates DoesNotExist (matches absent
        # labels) with an emptied intersection (requirements.py matches()),
        # so a fast-reject on that shape would break DoesNotExist pool
        # templates (round-5 review finding, with repro). The survivor
        # scan below is the authority.
        survivors = [
            it
            for it in group.instance_types
            if it.requirements.compatible(narrowed) and _fits_type(it, effective)
        ]
        if not survivors:
            return False

        if min_values_shortfall(narrowed, survivors) is not None:
            return False  # joining would shrink flexibility below minValues
        group.requirements = narrowed
        group.instance_types = survivors
        group.pods.append(pod)
        group.requested = requested
        self._record_placement(pod, id(group), narrowed.labels(), group=group)
        return True

    def _group_max_alloc(self, group: NewNodeGroup) -> Resources:
        key = id(group)
        r = self._gmax_cache.get(key)
        if r is None:
            vals: Dict[str, float] = {}
            for it in group.instance_types:
                for k, v in it.allocatable().items():
                    if v > vals.get(k, 0.0):
                        vals[k] = v
            r = self._gmax_cache[key] = Resources.from_base_units(vals)
        return r

    def _env_key(self, pod: Pod, pool: NodePool) -> tuple:

        memo_key = (pool.name, pod.grouping_signature())
        key = self._env_key_memo.get(memo_key)
        if key is None:
            # group_pods orientation: pod requirements + pool extras. The
            # suffix rank (_class_key[0]) is STRIPPED: an affinity follower
            # shares its anchor's price envelope even though it can no
            # longer share its class -- the envelope sizes the anchor's
            # group for the followers too. The device/oracle split stays
            # sound because supports() BLOCKS the carve whenever a suffix
            # pod's rank-stripped key collides with a device class
            # (_aff_partition_blocked key-collision check).
            merged = pod.scheduling_requirements()[0].copy().add(*pool.requirements())
            key = self._env_key_memo[memo_key] = (pool.name, encode._class_key(pod, merged)[1:])
        return key

    def _note_placed(self, pod: Pod) -> None:
        if self.objective != "price":
            return
        for pool in self.nodepools:
            key = self._env_key(pod, pool)
            self._env_placed[key] = self._env_placed.get(key, 0) + 1

    def _remaining(self, pod: Pod, pool: NodePool) -> int:
        totals = self._env_totals.get(pool.name)
        if totals is None:
            totals = self._env_totals[pool.name] = {}
            for p in self._sched_pods:
                k = self._env_key(p, pool)
                totals[k] = totals.get(k, 0) + 1
        key = self._env_key(pod, pool)
        return totals.get(key, 1) - self._env_placed.get(key, 0)

    def _price_open_filter(
        self,
        candidates: List[InstanceType],
        narrowed: Requirements,
        requested: Resources,
        remaining: int,
        env_key: Optional[tuple] = None,
        overhead: Optional[Resources] = None,
    ) -> List[InstanceType]:
        """Price-aware opening envelope, the oracle half of the batch
        solver's objective == "price" (solver/ffd.py _ffd_body step): pick
        the candidate k* minimizing the TOTAL cost of hosting the class's
        `remaining` pods -- price * ceil(remaining / fit) over the
        (zone, captype) offerings the narrowed requirements admit -- then
        keep only candidates at least as cheap that can hold k*'s
        allocation. A class's later groups reuse the first group's cached
        envelope (`env_key`). Arithmetic is float32 so floors, divisions,
        and argmin ties agree with the device tensors exactly."""

        req32 = encode.scale_vector(requested.to_vector()).astype(np.float32)
        ovh32 = (
            encode.scale_vector(overhead.to_vector()).astype(np.float32)
            if overhead is not None else None
        )
        pos = req32 > 0
        zreq = narrowed.get(wk.ZONE_LABEL)
        creq = narrowed.get(wk.CAPACITY_TYPE_LABEL)
        inf32 = np.float32(np.inf)
        # per-type immutable inputs memoized per Scheduler (the filter runs
        # per distinct env key; re-deriving 600+ scaled capacity vectors
        # and offering tuples each time dominated suffix opens -- round 5)
        memo = self._type_stats_memo
        stats = []
        for it in candidates:
            pre = memo.get(id(it))
            if pre is None:
                cap_base = encode.scale_vector(
                    it.allocatable().to_vector()).astype(np.float32)
                offers = tuple(
                    (o.zone, o.capacity_type, np.float32(o.price),
                     o.capacity_type == wk.CAPACITY_TYPE_RESERVED)
                    for o in it.offerings if o.available
                )
                pre = memo[id(it)] = (cap_base, offers)
            cap32, offers = pre
            if ovh32 is not None:
                # fresh nodes reserve the pool's daemonset overhead before
                # workload pods pack (the device subtracts the same scaled
                # vector from cap -- float32 exactness holds, small ints)
                cap32 = np.maximum(cap32 - ovh32, np.float32(0.0))
            n = np.floor(cap32[pos] / req32[pos]).min() if pos.any() else inf32
            price = inf32
            has_reserved = False
            zone_ok = cap_ok = False
            for zone, captype, p32, reserved in offers:
                z_m = zreq is None or zreq.matches(zone)
                c_m = creq is None or creq.matches(captype)
                zone_ok = zone_ok or z_m
                cap_ok = cap_ok or c_m
                if z_m and c_m:
                    if p32 < price:
                        price = p32
                    if reserved:
                        has_reserved = True
            # the device's fresh_row is the SEPARABLE availability join
            # (admitted zone exists AND admitted captype exists, over
            # available offerings); candidates outside it must not anchor
            # the density reference n_max
            joined = zone_ok and cap_ok
            stats.append((n, price, has_reserved, joined))
        env = self._env_cache.get(env_key) if env_key is not None else None
        if env is None:
            rem32 = np.float32(max(remaining, 1))
            n_max = max((n for n, _, _, j in stats if j), default=np.float32(0.0))
            best_cost = inf32
            env = False
            need = min(n_max, rem32)
            for (n, price, has_reserved, joined) in stats:
                # density envelope (mirrors ffd step): only types packing at
                # least half the demanded density -- min(best packer,
                # remaining) -- compete on price; reserved-capable types
                # bypass the gate (prepaid capacity)
                if joined and n >= 1 and (
                    np.float32(2.0) * min(n, rem32) >= need or has_reserved
                ):
                    cost = price * np.ceil(rem32 / n)
                else:
                    cost = inf32
                if cost < best_cost:
                    best_cost = cost
                    env = (n, price)
            if env_key is not None:
                self._env_cache[env_key] = env
        if env is False:
            return []
        n_star, p_star = env
        return [
            it
            for it, (n, price, _, _) in zip(candidates, stats)
            if n >= n_star and price <= p_star
        ]

    def _spread_pin_applies(self, pod: Pod) -> bool:
        """True when the pod's placement carries a spread zone pin (hard,
        or soft not yet relaxed): pinned pods keep the full max-fit
        candidate set, mirroring the split pass's env_count = 0."""
        if any(
            t.hard() and _pod_matches_selector(pod, t.label_selector)
            for t in pod.topology_spread
        ):
            return True
        return not self._soft_relaxed and _soft_zone_tsc(pod) is not None

    def _open_group(self, pod: Pod, pod_reqs: Requirements, result: SchedulingResult) -> Optional[str]:
        last_reason = "no nodepool matches pod requirements"
        for pool in self.nodepools:
            pool_reqs = pool.requirements()
            if not pool_reqs.compatible(pod_reqs, allow_undefined=_ALLOW_UNDEFINED):
                continue
            taints = list(pool.template.taints)
            if not tolerates_all(pod.tolerations, taints):
                last_reason = f"pod does not tolerate nodepool {pool.name} taints"
                continue
            merged = pool_reqs.copy().add(*pod_reqs)
            narrowed = self._spread_narrow_group(pod, merged, pool=pool)
            if narrowed is None:
                last_reason = "topology spread constraints unsatisfiable"
                continue
            # pod affinity on a FRESH node: a positive hostname term admits
            # only the bootstrap case (the new node starts with no pods, so
            # a pod that must co-locate with an existing match cannot start
            # a new hostname domain); zone terms narrow the group's zones
            affinity_blocked = False
            for term in pod.affinity_terms:
                if not term.anti and term.topology_key == wk.HOSTNAME_LABEL:
                    sel = term.label_selector
                    if self._any_match(sel) or not self._match(pod.metadata.labels, sel):
                        affinity_blocked = True
                        break
            if affinity_blocked:
                last_reason = "pod affinity requires co-location with an existing pod"
                continue
            narrowed = self._affinity_narrow(pod, narrowed)
            if narrowed is None:
                last_reason = "pod affinity unsatisfiable in any zone"
                continue
            requested = pod.requests + Resources.from_base_units({res.PODS: 1})
            effective = requested + self._ovh(pool)
            candidates = [
                it
                for it in self.instance_types.get(pool.name, [])
                if it.requirements.compatible(narrowed) and _fits_type(it, effective)
            ]

            has_min_values = any(r.min_values is not None for r in narrowed)
            if candidates and has_min_values:
                # checked on the FULL candidate set, before any cost
                # narrowing: minValues is a flexibility floor
                short = min_values_shortfall(narrowed, candidates)
                if short is not None:
                    last_reason = (
                        f"minValues requirement for {short} not met by nodepool {pool.name}"
                    )
                    continue
            if (
                candidates
                and self.objective == "price"
                # minValues groups keep the full candidate set: the price
                # envelope narrows types and would defeat the flexibility
                # floor (availability beats cost, as with spread)
                and not has_min_values
                # hard-spread pods keep the full (max-fit) candidate set:
                # spreading is an availability constraint and the batch
                # solver marks spread sub-classes env_count = 0 (fit mode).
                # A constraint whose selector the pod itself does not match
                # never applies (the split pass ignores it the same way).
                # Applied soft pins are excluded the same way; a RELAXED
                # soft pod keeps the price envelope (the split's unpinned
                # residual keeps the class env_count).
                and not self._spread_pin_applies(pod)
            ):
                candidates = self._price_open_filter(
                    candidates, narrowed, requested,
                    self._remaining(pod, pool), env_key=self._env_key(pod, pool),
                    overhead=self._ovh(pool),
                )
            if not candidates:
                last_reason = f"no instance type in nodepool {pool.name} fits pod"
                continue
            # nodepool resource limits: smallest candidate must stay in budget
            if pool.limits is not None:
                usage = self.usage.get(pool.name, Resources())
                smallest = min(candidates, key=lambda it: it.capacity.get(res.CPU))
                if not (usage + smallest.capacity).within(pool.limits):
                    last_reason = f"nodepool {pool.name} limits exceeded"
                    continue
                self.usage[pool.name] = usage + smallest.capacity
            group = NewNodeGroup(
                nodepool=pool,
                requirements=narrowed,
                instance_types=candidates,
                # scheduling-relevant taints only: startup taints lift
                # before pods land, so they must not block later pods from
                # JOINING this group either (_try_group gates on these; the
                # provisioner re-derives startup taints from the pool when
                # building the NodeClaim)
                taints=taints,
                pods=[pod],
                requested=requested,
            )
            result.new_groups.append(group)
            group._open_seq = self._open_seq_next
            self._open_seq_next += 1
            self._record_placement(pod, id(group), narrowed.labels(), group=group)
            return None
        return last_reason

    # -- entry point --------------------------------------------------------
    def schedule(
        self, pods: Sequence[Pod], seed_result: Optional[SchedulingResult] = None
    ) -> SchedulingResult:
        # seed_result: continue a pass over an already-built result -- the
        # oracle-suffix carve (service._oracle_suffix) hands the device
        # pass's open groups here so suffix pods can JOIN them exactly as
        # one full pass would; placements land in the shared result
        result = seed_result if seed_result is not None else SchedulingResult()
        # per-call envelope totals: they are lazily computed from
        # _sched_pods (rebound just below), so a SECOND schedule() call on
        # one Scheduler -- the three-phase split, retries, test reuse --
        # must not inherit totals sized for the previous call's pods
        self._env_totals = {}
        # group-open sequence numbers: candidate pruning
        # (_candidate_groups) must preserve the first-fit order of
        # result.new_groups even when candidates come from label buckets
        for i, g in enumerate(result.new_groups):
            g._open_seq = i
        self._open_seq_next = len(result.new_groups)
        # canonical order shared with the batch solver (encode.pod_sort_key):
        # suffix rank, then dominant size descending, pool-independent
        # class-signature tie-break

        ordered = sorted(pods, key=pod_sort_key)
        self._sched_pods = ordered
        for pod in ordered:
            placed, reasons = self._place_pod(pod, result)
            if not placed and not self._soft_relaxed and _soft_zone_tsc(pod) is not None:
                # ScheduleAnyway: the zone preference must never make a pod
                # unschedulable -- retry the full placement with the soft
                # pin dropped (the split pass's unpinned residual is the
                # device-side mirror of this relaxation)
                self._soft_relaxed = True
                try:
                    placed, reasons = self._place_pod(pod, result)
                finally:
                    self._soft_relaxed = False
            if not placed:
                result.unschedulable[pod.metadata.name] = "; ".join(reasons) or "unschedulable"
            else:
                self._note_placed(pod)
        return result

    def _place_pod(self, pod: Pod, result: SchedulingResult):
        """One placement pass under the current soft-spread state,
        including the UNIFIED preference-relaxation ladder over preferred
        node affinity AND preferred pod (anti-)affinity (the core's
        preferences model): all preferences apply as requirements,
        strongest set first; each failed attempt drops the lowest-weight
        preference of either kind and retries, ending with none.

        Attempts mutate-and-restore node_affinity_terms/affinity_terms;
        the grouping signature is memoized FROM THE ORIGINAL SPEC first,
        so helpers that read it mid-attempt (_env_key) can never capture
        a variant. An HONORED preferred anti-affinity term is recorded
        like a required one (_record_anti_terms reads the live terms), so
        it keeps repelling later arrivals -- a stricter deterministic
        refinement of upstream's per-pod scoring, in the same spirit as
        the min-count spread pin."""
        self._attempt_gen += 1
        node_prefs = [(w, "node", term) for w, term in pod.preferred_node_affinity_terms]
        pod_prefs = [(w, "pod", t) for w, t in pod.preferred_affinity_terms]
        if not node_prefs and not pod_prefs:
            return self._attempt_placement(pod, result)
        prefs = sorted(node_prefs + pod_prefs, key=lambda p: -p[0])
        pod.grouping_signature()
        original_nat = pod.node_affinity_terms
        original_aff = pod.affinity_terms
        placed, reasons = False, []
        try:
            for n in range(len(prefs), -1, -1):
                self._attempt_gen += 1
                active = prefs[:n]
                node_terms = [term for _, kind, term in active if kind == "node"]
                pod_terms = [t for _, kind, t in active if kind == "pod"]
                if node_terms:
                    base = original_nat or [[]]
                    flat = [r for term in node_terms for r in term]
                    pod.node_affinity_terms = [list(t) + flat for t in base]
                else:
                    pod.node_affinity_terms = original_nat
                pod.affinity_terms = (
                    original_aff + pod_terms if pod_terms else original_aff
                )
                placed, reasons = self._attempt_placement(pod, result)
                if placed:
                    break
        finally:
            pod.node_affinity_terms = original_nat
            pod.affinity_terms = original_aff
        return placed, reasons

    def _candidate_groups(self, pod: Pod, result: SchedulingResult) -> List[NewNodeGroup]:
        """Groups worth trying for a pod with affinity terms. A positive
        HOSTNAME term admits only groups already hosting a match (unless
        the bootstrap self-match rule applies), so the scan narrows from
        every open group to the term's label bucket -- the difference
        between O(groups) and O(matches) per follower pod at 50k scale.
        SOUNDNESS: the bucket is a superset filter (keyed by the
        selector's first pair); _try_group still runs the full
        _affinity_ok, and the first-fit order is preserved via the
        groups' open sequence numbers."""
        best = None
        for term in pod.affinity_terms:
            if term.anti or term.topology_key != wk.HOSTNAME_LABEL:
                continue
            sel = term.label_selector
            if not sel:
                continue
            if not self._any_match(sel):
                if self._match(pod.metadata.labels, sel):
                    continue  # bootstrap: the term passes at any location
                return []     # unsatisfiable at every open group
            bucket = self._loc_groups.get(next(iter(sel.items())), [])
            if best is None or len(bucket) < len(best):
                best = bucket
        if best is None:
            return result.new_groups
        return sorted(best, key=lambda g: g._open_seq)

    def _attempt_placement(self, pod: Pod, result: SchedulingResult):
        """One full placement attempt under the pod's CURRENT constraints:
        existing nodes, then open groups, then a fresh group. Side effects
        only on success -- except the monotone negative-capacity memo
        (_cap_reject), which failed joins may append to; it stays sound
        because group capacity never grows back. Returns (placed,
        reasons)."""
        if self._try_existing(pod, result):
            return True, []
        groups = (
            self._candidate_groups(pod, result) if pod.affinity_terms
            else result.new_groups
        )
        for pod_reqs in pod.scheduling_requirements():
            for group in groups:
                if self._try_group(pod, group, pod_reqs):
                    return True, []
        reasons = []
        for pod_reqs in pod.scheduling_requirements():
            reason = self._open_group(pod, pod_reqs, result)
            if reason is None:
                return True, []
            reasons.append(reason)
        return False, reasons
