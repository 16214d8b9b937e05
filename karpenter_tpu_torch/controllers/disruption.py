"""Disruption controller: expiration, drift, emptiness, consolidation.

Rebuilds the single-deprovisioning-controller design the reference documents
(designs/deprovisioning.md; consolidation mechanics in
designs/consolidation.md -- HOT LOOP #3 in SURVEY.md section 3.2) around
the same decision order and safety rails:

- candidates: initialized, past consolidate-after, pods all evictable
  (owned, no do-not-disrupt), nodepool disruption budgets respected
- reasons, in priority order: Expired -> Drifted -> Empty -> Underutilized
- consolidation evaluates candidates in ascending *disruption cost*
  (pods x (1 + deletion-cost + priority/1e6), weighted by remaining
  lifetime), then simulates rescheduling the candidate's pods against the
  rest of the cluster:
    deletion     -- pods fit on existing capacity
    replacement  -- pods fit on existing capacity + ONE strictly cheaper
                    new node (spot-to-spot guarded by the feature gate)
- stabilization: no consolidation while pods are pending or capacity is
  still materializing (the reference waits for cluster-state sync)

Execution is delegated to the termination controller by deleting the
NodeClaim (taint -> drain -> terminate), mirroring Delete at
pkg/cloudprovider/cloudprovider.go:209-220.

Copy of karpenter_tpu/controllers/disruption.py, imports rewritten to the port's.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from karpenter_tpu_torch.apis import (
    CONSOLIDATION_WHEN_EMPTY,
    NodeClaim,
    NodePool,
    Node,
    Pod,
    TPUNodeClass,
    labels as wk,
)
from karpenter_tpu_torch.apis.nodeclaim import COND_CONSOLIDATABLE, COND_DRIFTED, COND_EMPTY
from karpenter_tpu_torch.cloudprovider import CloudProvider
from karpenter_tpu_torch.errors import CloudError
from karpenter_tpu_torch.kwok.cluster import Cluster
from karpenter_tpu_torch.logging import get_logger
from karpenter_tpu_torch.scheduling import Resources
from karpenter_tpu_torch.scheduling import resources as res
from karpenter_tpu_torch.solver.oracle import ExistingNode, Scheduler

MIN_NODE_LIFETIME = 5 * 60.0  # consolidation waits for PVC binding etc.
# brownout rung 1 (overload.BrownoutController): with a device evaluator
# wired, the sweep DOWNGRADES to a bounded singleton-only device pass
# over this many cheapest-to-disrupt candidates instead of standing down
# entirely -- one dispatch, no drift/replacement/multi-node host work
BROWNOUT_MAX_CANDIDATES = 16
# spot->spot consolidation keeps at least this many cheaper instance-type
# options on the replacement (upstream's flexibility minimum: replacing a
# spot node with a single cheaper spot type would trade price for a much
# higher re-interruption probability)
MIN_TYPES_SPOT_TO_SPOT = 15

REASON_EXPIRED = "Expired"
REASON_DRIFTED = "Drifted"
REASON_EMPTY = "Empty"
REASON_UNDERUTILIZED = "Underutilized"


@dataclass
class Candidate:
    claim: NodeClaim
    node: Node
    # None for a STANDALONE claim (no NodePool): eligible for the
    # claim-level reasons (expiration, drift) but not the pool-policy
    # reasons (emptiness, consolidation), as in the core
    nodepool: Optional[NodePool]
    pods: List[Pod]
    price: float
    disruption_cost: float
    # node/claim-level karpenter.sh/do-not-disrupt: blocks the GRACEFUL
    # voluntary reasons (drift, emptiness, consolidation); expiration is a
    # forceful method upstream and proceeds regardless
    do_not_disrupt: bool = False


class DisruptionController:
    log = get_logger("disruption")

    def __init__(
        self,
        cluster: Cluster,
        cloud_provider: CloudProvider,
        pricing,
        feature_gates: Optional[dict] = None,
        evaluator=None,
        recorder=None,
        brownout=None,
        repack=None,
    ):
        self.cluster = cluster
        self.cloud_provider = cloud_provider
        self.pricing = pricing
        self.feature_gates = feature_gates or {}
        self.recorder = recorder  # optional events.Recorder
        # optional overload.BrownoutController: consolidation/disruption
        # is the brownout ladder's FIRST shed (rung 1) -- under sustained
        # tick-deadline pressure the whole sweep stands down (counted)
        # until the ladder recovers hysteretically
        self.brownout = brownout
        # batched device evaluator (solver/consolidate.py): all candidate
        # sets are judged in one dispatch; candidates with stateful
        # constraints fall back to the per-candidate oracle simulation
        self.evaluator = evaluator
        # optional convex.repack.RepackOracle: fleet-wide regret scoring
        # proposes candidate sets the local prefix/pair enumerations miss;
        # proposals only NOMINATE -- stage 6 judges each through the same
        # simulate/price differential as the controller's own enumerations
        self.repack = repack
        self.last_decisions: List[Tuple[str, str]] = []  # (claim name, reason)
        # per-sweep stats for the flight recorder (obs/flight.py): sweep
        # mode (full / bounded / shed), wall ms, candidate-set counts by
        # enumeration kind, and the engine's dispatch route
        self.last_sweep_stats: dict = {}
        # candidate-set counts accumulated across the CURRENT pass's
        # batched dispatches (singleton batch + prefix/pair batch +
        # mid-pass re-judges)
        self._pass_set_counts: Dict[str, int] = {}
        # nodes disrupted in the CURRENT pass: their NodeClaims are deleting
        # but the Node objects are not yet marked (termination runs later),
        # so simulations must exclude them explicitly or later candidates
        # would repack onto capacity that is already going away
        self._pass_disrupted: List[str] = []
        # per-pass pool/catalog snapshot (None outside a pass: helpers
        # called directly, e.g. from tests, fetch fresh)
        self._pass_pools: Optional[List[NodePool]] = None
        self._pass_catalogs: Optional[Dict[str, list]] = None
        self._pass_pdb_guard = None
        self._pass_daemon_overhead: Optional[Dict[str, Resources]] = None
        # per-pass claim/class snapshot for volume lowering (built once in
        # _reconcile; helpers called directly, e.g. from tests, build fresh)
        self._pass_vol_index = None
        # pods whose simulation exclusion was already logged this pass
        self._pass_blocked_logged: set = set()
        # (budget id, minute) -> bool; bounded, cleared on overflow
        self._budget_active_memo: Dict[tuple, bool] = {}

    # -- helpers ------------------------------------------------------------
    def _price_of(self, claim: NodeClaim) -> float:
        it = claim.instance_type
        if not it:
            return float("inf")
        if claim.capacity_type == wk.CAPACITY_TYPE_SPOT and claim.zone:
            p, ok = self.pricing.spot_price(it, claim.zone)
        else:
            p, ok = self.pricing.on_demand_price(it)
        return p if ok else float("inf")

    def _disruption_cost(self, claim: NodeClaim, pods: Sequence[Pod]) -> float:
        """designs/consolidation.md 'Selecting Nodes for Consolidation':
        pod count + deletion-cost + priority, weighted by lifetime left."""
        cost = 0.0
        for p in pods:
            cost += 1.0 + p.deletion_cost() + p.priority / 1e6
        lifetime_factor = 1.0
        if claim.expire_after:
            age = self.cluster.clock.now() - claim.metadata.creation_timestamp
            lifetime_factor = max(0.0, 1.0 - age / claim.expire_after)
        return cost * lifetime_factor

    def _candidates(self) -> List[Candidate]:
        now = self.cluster.clock.now()
        out = []
        for claim in self.cluster.list(NodeClaim):
            if claim.deleting or not claim.initialized():
                continue
            node = self.cluster.node_for_nodeclaim(claim)
            if node is None or node.deleting or node.unschedulable:
                continue
            dnd = (
                node.metadata.annotations.get(wk.DO_NOT_DISRUPT_ANNOTATION) == "true"
                or claim.metadata.annotations.get(wk.DO_NOT_DISRUPT_ANNOTATION) == "true"
            )
            pool_name = claim.nodepool_name
            pool = self.cluster.try_get(NodePool, pool_name) if pool_name else None
            if pool_name and pool is None:
                continue  # pool-owned claim whose pool is mid-delete
            pods = self.cluster.pods_on_node(node.metadata.name)
            out.append(
                Candidate(
                    claim=claim,
                    node=node,
                    nodepool=pool,
                    pods=pods,
                    price=self._price_of(claim),
                    disruption_cost=self._disruption_cost(claim, pods),
                    do_not_disrupt=dnd,
                )
            )
        return out

    def _budget_allows(self, pool: Optional[NodePool], reason: str, disrupting: Dict[str, int], totals: Dict[str, int]) -> bool:
        if pool is None:
            return True  # standalone claims carry no pool budgets
        total = totals.get(pool.name, 0)
        current = disrupting.get(pool.name, 0)
        now = self.cluster.clock.now()
        for budget in pool.disruption.budgets:
            if budget.reasons is not None and reason not in budget.reasons:
                continue
            # activity memoized per (budget, minute): the window scan walks
            # duration/60 cron checks, and _budget_allows runs per
            # candidate -- hundreds of candidates x a 24h window would be
            # ~10^5 redundant parses per pass
            akey = (budget.schedule, budget.duration, int(now // 60))
            active = self._budget_active_memo.get(akey)
            if active is None:
                active = self._budget_active_memo[akey] = budget.active(now)
                if len(self._budget_active_memo) > 256:
                    self._budget_active_memo.clear()
            if not active:
                continue  # scheduled budget outside its window
            if current + 1 > budget.allowed(total):
                return False
        return True

    def _all_pods_evictable(self, pods: Sequence[Pod], charge_always: bool = False) -> bool:
        """Every pod is controller-replaced, consented (no do-not-disrupt),
        AND currently evictable under its PodDisruptionBudgets -- a node
        whose drain would immediately stall on an exhausted budget is not
        a voluntary-disruption candidate this pass (the budget freeing up
        later makes it one again). ONE guard serves the whole pass
        (_pass_pdb_guard): disrupting a claim does not unbind its pods, so
        per-call guards would let several nodes sharing one allowance all
        pass candidacy and then jointly stall the drain; the shared guard
        consumes allowance across candidates exactly as the drains will.
        Accounting is ATOMIC per candidate (try_evict_all): a rejected
        candidate consumes nothing, so it cannot block a sibling node
        sharing the same budget (ADVICE round 3). With charge_always (the
        terminationGracePeriod carve-out, where the caller force-drains
        regardless of the verdict) a failing candidate still charges its
        pods, so a later candidate cannot double-book allowance the forced
        drain will consume; the charge is conservative when a downstream
        gate (disruption budget, failed simulation) then skips the drift
        -- siblings just defer to the next pass."""
        from karpenter_tpu_torch.controllers.pdb_guard import PDBGuard

        if self._pass_pools is not None:
            # inside a pass: one shared guard
            guard = self._pass_pdb_guard
            if guard is None:
                guard = self._pass_pdb_guard = PDBGuard(self.cluster)
        else:
            # helper called directly (tests): fresh snapshot
            guard = PDBGuard(self.cluster)
        if all(p.reschedulable() for p in pods):
            return guard.try_evict_all(pods, charge_on_fail=charge_always)
        if charge_always:
            guard.charge(pods)
        return False

    # -- simulation ---------------------------------------------------------
    def _vol_index(self):
        from karpenter_tpu_torch.apis.storage import VolumeIndex

        if self._pass_vol_index is not None:
            return self._pass_vol_index
        return VolumeIndex.from_cluster(self.cluster)

    def _effective_in_flight(self, vol_index) -> List[Pod]:
        """Resolved in-flight pods (see _in_flight_pods). Vol-blocked ones
        are DROPPED, not vetoes: they are unschedulable with or without
        the disruption under evaluation, and letting one frozen PVC
        freeze consolidation cluster-wide starves every other candidate
        (ADVICE round 4). Each drop is logged once per pass so the
        exclusion is operator-visible."""
        from karpenter_tpu_torch.apis.storage import effective_pods

        pods, blocked = effective_pods(self._in_flight_pods(), vol_index)
        for name, reason in blocked.items():
            if name not in self._pass_blocked_logged:
                self._pass_blocked_logged.add(name)
                self.log.warning(
                    "in-flight pod excluded from disruption simulation",
                    pod=name, reason=reason,
                )
        return pods

    def _other_nodes(self, excluded: Sequence[str]) -> List[ExistingNode]:
        out = []
        vol_index = self._vol_index()
        live = [
            n for n in self.cluster.list(Node)
            if n.metadata.name not in excluded
            and not n.deleting and not n.unschedulable and n.ready
        ]
        # ONE pod pass for every node's usage (node_usage per node is
        # O(all pods) per call on index-less stores -- round 5)
        usage_map = self.cluster.node_usage_map(
            [n.metadata.name for n in live], vol_index)
        for node in live:
            out.append(
                ExistingNode(
                    name=node.metadata.name,
                    labels=dict(node.metadata.labels),
                    allocatable=node.allocatable,
                    taints=list(node.taints),
                    used=usage_map[node.metadata.name],
                )
            )
        return out

    def _pods_by_node(self) -> Dict[str, List[Pod]]:
        out: Dict[str, List[Pod]] = {}
        for p in self.cluster.list(Pod):
            if p.node_name:
                out.setdefault(p.node_name, []).append(p)
        return out

    def _in_flight_pods(self) -> List[Pod]:
        """Reschedulable pods still bound to nodes disrupted earlier in this
        pass. They have not rebound yet, so later simulations must place
        them ALONGSIDE the candidate's pods -- otherwise two candidates
        would each claim the same surviving headroom (ADVICE round 1)."""
        by_node = self._pods_by_node()
        return [
            p
            for n in self._pass_disrupted
            for p in by_node.get(n, [])
            if p.reschedulable()
        ]

    def _simulate(self, candidates: Sequence[Candidate], allow_new_node: bool):
        """Can every pod on the candidate set reschedule elsewhere (plus at
        most one new node when allow_new_node)? Returns (ok, new_groups)."""
        from karpenter_tpu_torch.apis.storage import effective_pods

        excluded = [c.node.metadata.name for c in candidates] + list(self._pass_disrupted)
        # volume-backed pods re-simulate with their attach counts and
        # bound-zone pins (claims are bound by now: the pod ran), so
        # consolidation never plans a move a zonal volume forbids. A
        # vol-blocked pod VETOES only when it runs on a candidate: evicting
        # it would strand a pod that cannot rebind. In-flight pods from
        # nodes disrupted earlier this pass are dropped instead of vetoing
        # -- they are unschedulable with or without this disruption, and
        # letting one frozen PVC freeze all consolidation cluster-wide
        # starves every other candidate (ADVICE round 4).
        vol_index = self._vol_index()
        in_flight = self._effective_in_flight(vol_index)
        own = [p for c in candidates for p in c.pods if p.reschedulable()]
        own, vol_blocked = effective_pods(own, vol_index)
        if vol_blocked:
            return False, []
        pods = in_flight + own
        nodepools, pass_catalogs = self._pool_context()
        catalogs: Dict[str, list] = {}
        zones: set = set()
        if allow_new_node:
            catalogs = pass_catalogs
            for items in catalogs.values():
                for it in items:
                    for o in it.available_offerings():
                        zones.add(o.zone)
        sched = Scheduler(
            nodepools=nodepools if allow_new_node else [],
            instance_types=catalogs,
            existing_nodes=self._other_nodes(excluded),
            pods_by_node={k: v for k, v in self._pods_by_node().items() if k not in excluded},
            nodepool_usage={p.name: self.cluster.nodepool_usage(p.name) for p in nodepools},
            zones=zones,
            daemon_overhead=self._daemon_overhead(nodepools),
        )
        result = sched.schedule(pods)
        if result.unschedulable:
            return False, []
        if not allow_new_node and result.new_groups:
            return False, []
        if allow_new_node and len(result.new_groups) > 1:
            return False, []
        return True, result.new_groups

    # -- reconcile ----------------------------------------------------------
    def reconcile(self, max_disruptions: int = 1) -> List[Tuple[str, str]]:
        """One disruption pass; returns [(claim, reason)] acted on."""
        import time as _time

        from karpenter_tpu_torch import metrics, tracing

        bounded = False
        if self.brownout is not None and self.brownout.sheds_disruption():
            if self.evaluator is None:
                # brownout ladder rung 1, no device engine wired: the
                # sweep stands down entirely -- the per-candidate oracle
                # simulations are exactly the host-side cost a pressured
                # tick cannot afford. Nothing is lost: candidates
                # re-judge once the ladder recovers.
                metrics.OVERLOAD_SKIPPED_SWEEPS.inc(stage="disruption")
                tracing.annotate(disruption="shed-brownout")
                self.last_decisions = []
                self.last_sweep_stats = {"mode": "shed", "consolidation_ms": 0.0}
                return []
            # with the batched device engine the sweep is cheap enough to
            # LEAVE ON during brownout: rung 1 downgrades to a bounded
            # singleton-only device pass (one dispatch over the cheapest
            # candidates, deletion verdicts only) instead of standing down
            bounded = True
        t0 = _time.perf_counter()
        self._pass_set_counts = {}
        mode = "bounded" if bounded else "full"
        try:
            with tracing.span("disruption"):
                if bounded:
                    metrics.DISRUPTION_DEVICE_BOUNDED_SWEEPS.inc()
                    tracing.annotate(disruption="brownout-bounded")
                    return self._reconcile_bounded(max_disruptions)
                return self._reconcile(max_disruptions)
        finally:
            self._pass_pools, self._pass_catalogs = None, None
            self._pass_pdb_guard = None
            self._pass_daemon_overhead = None
            # drop the claim snapshot too: helpers called between passes
            # (tests, ad-hoc verdicts) must see the live cluster, not the
            # last pass's volume world
            self._pass_vol_index = None
            self._pass_blocked_logged = set()
            elapsed = _time.perf_counter() - t0
            metrics.DISRUPTION_EVAL_DURATION.observe(elapsed)
            if self.evaluator is None:
                path = "oracle"
            elif not self._pass_set_counts:
                # THIS pass made no device dispatch; last_dispatch would
                # report a previous sweep's route
                path = "none"
            else:
                path = getattr(self.evaluator, "last_dispatch", {}).get("path", "none")
            self.last_sweep_stats = {
                "mode": mode,
                "consolidation_ms": round(elapsed * 1e3, 3),
                "sets": dict(self._pass_set_counts),
                "path": path,
            }

    def _daemon_overhead(self, pools) -> Dict[str, "Resources"]:
        """Per-pool fresh-node daemonset reserve, SNAPSHOT per pass like
        _pool_context: every candidate in one pass must be judged against
        the same node sizing (a mid-pass DaemonSet change applies next
        pass)."""
        if self._pass_daemon_overhead is not None:
            return self._pass_daemon_overhead
        from karpenter_tpu_torch.apis import DaemonSet
        from karpenter_tpu_torch.apis.daemonset import overhead_by_pool

        out = overhead_by_pool(self.cluster.list(DaemonSet), pools)
        if self._pass_pools is not None:
            self._pass_daemon_overhead = out
        return out

    def _pool_context(self) -> Tuple[List[NodePool], Dict[str, list]]:
        """(live pools, their catalogs). Inside a pass this is the snapshot
        taken at pass start -- catalogs change on the 12h refresh cadence,
        not mid-pass, so verdict re-judges must not re-fetch them."""
        if self._pass_pools is not None and self._pass_catalogs is not None:
            return self._pass_pools, self._pass_catalogs
        pools = [p for p in self.cluster.list(NodePool) if not p.deleting]
        catalogs: Dict[str, list] = {}
        for pool in pools:
            try:
                catalogs[pool.name] = self.cloud_provider.get_instance_types(pool)
            except CloudError:
                catalogs[pool.name] = []
        return pools, catalogs

    def _pass_setup(self) -> None:
        """Per-pass snapshot state shared by the full and bounded sweeps
        (torn down by reconcile's finally)."""
        from karpenter_tpu_torch.apis.storage import VolumeIndex

        self.last_decisions = []
        self._pass_disrupted = []
        self._pass_blocked_logged = set()
        self._pass_vol_index = VolumeIndex.from_cluster(self.cluster)
        self._pass_pools, self._pass_catalogs = None, None
        self._pass_pdb_guard = None
        self._pass_daemon_overhead = None
        self._pass_pools, self._pass_catalogs = self._pool_context()

    def _disruption_counts(self) -> Tuple[Dict[str, int], Dict[str, int]]:
        """(claims currently disrupting, claim totals) per pool -- the
        budget denominators."""
        disrupting: Dict[str, int] = {}
        totals: Dict[str, int] = {}
        for claim in self.cluster.list(NodeClaim):
            if claim.nodepool_name:
                totals[claim.nodepool_name] = totals.get(claim.nodepool_name, 0) + 1
                if claim.deleting:
                    disrupting[claim.nodepool_name] = disrupting.get(claim.nodepool_name, 0) + 1
        return disrupting, totals

    def _consolidatable(self, candidates: Sequence[Candidate]) -> List[Candidate]:
        """Pool-owned, consenting, past the consolidation age gate, in
        ascending disruption-cost order -- the candidate assembly both
        sweep modes share."""
        now = self.cluster.clock.now()
        acted = [n for n, _ in self.last_decisions]
        return sorted(
            (
                c
                for c in candidates
                if not c.do_not_disrupt
                and c.claim.metadata.name not in acted
                and c.nodepool is not None  # pool-policy reasons only
                and now - c.claim.metadata.creation_timestamp
                >= max(MIN_NODE_LIFETIME, c.nodepool.disruption.consolidate_after)
            ),
            key=lambda c: c.disruption_cost,
        )

    def _reconcile_bounded(self, max_disruptions: int) -> List[Tuple[str, str]]:
        """The brownout rung-1 sweep: candidate assembly capped at the
        BROWNOUT_MAX_CANDIDATES cheapest-to-disrupt nodes, ONE singleton-
        only device dispatch with no replacement context, emptiness +
        deletion verdicts applied under the usual budget/PDB gates. No
        drift, no expiration, no replacement launches, no multi-node work
        -- the host-side cost is candidate assembly plus verdict
        application, which is exactly what a pressured tick can afford."""
        self._pass_setup()
        if self.cluster.pending_pods():
            return self.last_decisions
        disrupting, totals = self._disruption_counts()
        consolidatable = self._consolidatable(self._candidates())[:BROWNOUT_MAX_CANDIDATES]
        verdicts = self._device_verdicts(consolidatable, replacement=False)
        decided = len(self.last_decisions)
        for i, c in enumerate(consolidatable):
            if len(self.last_decisions) >= max_disruptions:
                break
            if len(self.last_decisions) != decided:
                # same re-judge discipline as the full sweep: an earlier
                # disruption this pass consumed surviving headroom, and a
                # stale verdict would double-book it -- one fresh bounded
                # dispatch per decision, still O(max_disruptions) cheap
                decided = len(self.last_decisions)
                verdicts = self._device_verdicts(
                    consolidatable[i:], replacement=False)
            reschedulable = [p for p in c.pods if p.owner_kind != "Node"]
            if not reschedulable:
                c.claim.status_conditions.set_true(COND_EMPTY)
                if self._budget_allows(c.nodepool, REASON_EMPTY, disrupting, totals):
                    self._disrupt(c, REASON_EMPTY, disrupting)
                continue
            if c.nodepool.disruption.consolidation_policy == CONSOLIDATION_WHEN_EMPTY:
                continue
            v = verdicts.get(c.claim.metadata.name)
            if v is None or not v.can_delete:
                continue
            if not self._all_pods_evictable(c.pods):
                continue
            if not self._budget_allows(c.nodepool, REASON_UNDERUTILIZED, disrupting, totals):
                continue
            c.claim.status_conditions.set_true(COND_CONSOLIDATABLE)
            self._disrupt(c, REASON_UNDERUTILIZED, disrupting)
        return self.last_decisions

    def _reconcile(self, max_disruptions: int) -> List[Tuple[str, str]]:
        self._pass_setup()
        disrupting, totals = self._disruption_counts()
        candidates = self._candidates()
        now = self.cluster.clock.now()

        # 1) expiration (forceful; budget-exempt in the core's model for
        #    expired-by-spec, but we respect budgets like modern karpenter)
        for c in candidates:
            if len(self.last_decisions) >= max_disruptions:
                return self.last_decisions
            if c.claim.expire_after is not None and now - c.claim.metadata.creation_timestamp >= c.claim.expire_after:
                if self._budget_allows(c.nodepool, REASON_EXPIRED, disrupting, totals):
                    self._disrupt(c, REASON_EXPIRED, disrupting)

        # 2) drift (graceful: requires replacement simulation)
        for c in candidates:
            if len(self.last_decisions) >= max_disruptions:
                return self.last_decisions
            if c.claim.metadata.name in [n for n, _ in self.last_decisions]:
                continue
            if c.do_not_disrupt:
                continue
            drift = self._drift_reason(c)
            if not drift:
                continue
            # With a terminationGracePeriod on the claim, drift proceeds
            # even when the evictability check fails (do-not-disrupt pods
            # or exhausted budgets): the grace force-drain guarantees
            # completion, exactly the upstream carve-out. charge_always
            # makes that forced drain's pods charge the shared per-pass
            # PDB guard even on a failing verdict, so a later candidate
            # cannot double-book the same allowance and stall its drain.
            has_grace = c.claim.termination_grace_period is not None
            evictable = self._all_pods_evictable(c.pods, charge_always=has_grace)
            if evictable or has_grace:
                if not self._budget_allows(c.nodepool, REASON_DRIFTED, disrupting, totals):
                    continue
                c.claim.status_conditions.set_true(COND_DRIFTED, drift)
                ok, groups = self._simulate([c], allow_new_node=True)
                if ok:
                    self._replace_then_disrupt(c, groups, REASON_DRIFTED, disrupting)

        # 3) emptiness + 4) consolidation share the stabilization gate
        if self.cluster.pending_pods():
            return self.last_decisions
        consolidatable = self._consolidatable(candidates)
        verdicts = self._device_verdicts(consolidatable)
        decided = len(self.last_decisions)
        for i, c in enumerate(consolidatable):
            if len(self.last_decisions) >= max_disruptions:
                return self.last_decisions
            if len(self.last_decisions) != decided:
                # a disruption earlier in this pass consumed surviving
                # headroom; stale verdicts would double-book it (ADVICE
                # round 1) -- re-judge the remaining candidates in one
                # fresh batched dispatch
                decided = len(self.last_decisions)
                verdicts = self._device_verdicts(consolidatable[i:])
            reschedulable = [p for p in c.pods if p.owner_kind != "Node"]
            if not reschedulable:
                c.claim.status_conditions.set_true(COND_EMPTY)
                if self._budget_allows(c.nodepool, REASON_EMPTY, disrupting, totals):
                    self._disrupt(c, REASON_EMPTY, disrupting)
                continue
            if c.nodepool.disruption.consolidation_policy == CONSOLIDATION_WHEN_EMPTY:
                continue
            if not self._all_pods_evictable(c.pods):
                continue
            if not self._budget_allows(c.nodepool, REASON_UNDERUTILIZED, disrupting, totals):
                continue
            v = verdicts.get(c.claim.metadata.name)
            if v is not None:
                # device verdict: deletion decisions are oracle-equivalent
                # (differential tests); replacement is a pre-filter -- the
                # oracle re-derives the actual group before acting
                if v.can_delete:
                    c.claim.status_conditions.set_true(COND_CONSOLIDATABLE)
                    self._disrupt(c, REASON_UNDERUTILIZED, disrupting)
                    continue
                if not self._device_replacement_cheaper(c, v):
                    continue
                ok, groups = self._simulate([c], allow_new_node=True)
                if ok and groups and self._replacement_cheaper(c, groups):
                    c.claim.status_conditions.set_true(COND_CONSOLIDATABLE)
                    self._replace_then_disrupt(c, groups, REASON_UNDERUTILIZED, disrupting)
                continue
            # oracle path: deletion first, then single-node replacement
            ok, _ = self._simulate([c], allow_new_node=False)
            if ok:
                c.claim.status_conditions.set_true(COND_CONSOLIDATABLE)
                self._disrupt(c, REASON_UNDERUTILIZED, disrupting)
                continue
            ok, groups = self._simulate([c], allow_new_node=True)
            if ok and groups and self._replacement_cheaper(c, groups):
                c.claim.status_conditions.set_true(COND_CONSOLIDATABLE)
                self._replace_then_disrupt(c, groups, REASON_UNDERUTILIZED, disrupting)

        # 5) multi-node consolidation: try deleting the k cheapest-to-disrupt
        #    candidates together; when pure deletion fails, collapse them
        #    into ONE cheaper replacement node, and when no PREFIX of the
        #    disruption-cost order works, try underutilized PAIRS outside
        #    it (two nodes whose pods only fold together)
        #    (reference: designs/consolidation.md:5-36 node replacement)
        if len(self.last_decisions) < max_disruptions and len(consolidatable) >= 2:
            remaining = [
                c
                for c in consolidatable
                if c.claim.metadata.name not in [n for n, _ in self.last_decisions]
                and self._all_pods_evictable(c.pods)
            ]
            device_verdicts = self._device_prefix_verdicts(remaining)
            subset = self._largest_deletable_prefix(remaining, device_verdicts)
            if subset:
                # budgets re-checked per disruption as the count grows;
                # deleting a prefix of the simulated subset is safe
                # (fewer exclusions than simulated only adds capacity)
                for c in subset:
                    if not self._budget_allows(c.nodepool, REASON_UNDERUTILIZED, disrupting, totals):
                        break
                    self._disrupt(c, REASON_UNDERUTILIZED, disrupting)
            elif len(remaining) >= 2:
                acted = self._multi_node_replacement(
                    remaining, device_verdicts, disrupting, totals)
                if not acted:
                    self._pair_consolidation(
                        remaining, device_verdicts, disrupting, totals,
                        max_disruptions)

        # 6) global repack oracle (convex tier, opt-in): fleet-wide regret
        #    scoring over the survivors nominates the sets whose members
        #    sit too far apart in disruption-cost order for the prefix/pair
        #    enumerations to ever co-select; each nomination passes the
        #    SAME simulate/price differential before anything is touched
        if self.repack is not None and len(self.last_decisions) < max_disruptions:
            survivors = [
                c
                for c in consolidatable
                if c.claim.metadata.name not in [n for n, _ in self.last_decisions]
                and not c.do_not_disrupt
                and c.nodepool.disruption.consolidation_policy != CONSOLIDATION_WHEN_EMPTY
                and self._all_pods_evictable(c.pods)
            ]
            self._repack_consolidation(
                survivors, disrupting, totals, max_disruptions)
        return self.last_decisions

    def _repack_consolidation(
        self,
        remaining: List[Candidate],
        disrupting: Dict[str, int],
        totals: Dict[str, int],
        max_disruptions: int,
    ) -> bool:
        """Stage 6: judge the repack oracle's nominated candidate sets
        with the controller's own machinery -- pure deletion when the
        set's pods fold into the survivors, else ONE cheaper replacement
        node. The oracle only nominates; the simulate/price differential
        decides, so a bad proposal costs planning time, never capacity."""
        if not remaining:
            return False
        try:
            sets = self.repack.propose(
                remaining, self._pass_pools or [], self._pass_catalogs)
        except Exception:  # noqa: BLE001 -- an oracle fault costs this
            # sweep its stage-6 nominations only; the local enumerations
            # above already ran (OperatorCrashed is BaseException and
            # still propagates)
            self.log.warning("repack oracle failed; skipping stage 6")
            return False
        acted = False
        for idx in sets:
            if len(self.last_decisions) >= max_disruptions:
                break
            decided = {n for n, _ in self.last_decisions}
            sel = [remaining[i] for i in idx]
            if any(c.claim.metadata.name in decided for c in sel):
                continue
            if not self._budget_allows_set(sel, disrupting, totals):
                continue
            self._pass_set_counts["repack"] = (
                self._pass_set_counts.get("repack", 0) + 1)
            ok, _ = self._simulate(sel, allow_new_node=False)
            if ok:
                for c in sel:
                    c.claim.status_conditions.set_true(COND_CONSOLIDATABLE)
                    self._disrupt(c, REASON_UNDERUTILIZED, disrupting)
                acted = True
                continue
            ok, groups = self._simulate(sel, allow_new_node=True)
            if ok and groups and self._replacement_cheaper(sel, groups):
                for c in sel:
                    c.claim.status_conditions.set_true(COND_CONSOLIDATABLE)
                self._replace_then_disrupt(
                    sel, groups, REASON_UNDERUTILIZED, disrupting)
                acted = True
        return acted

    def _multi_node_replacement(
        self,
        remaining: List[Candidate],
        device_verdicts: Optional[Dict[object, object]],
        disrupting: Dict[str, int],
        totals: Dict[str, int],
    ) -> bool:
        """Replace N underutilized nodes with one cheaper node: largest
        prefix (by the disruption-cost order) whose pods fit the survivors
        plus ONE new node strictly cheaper than the prefix's aggregate
        price. `device_verdicts` is the per-prefix batch already dispatched
        for the deletion decision (replacement context included); the oracle
        re-derives the replacement group before acting. True when a
        replacement launched (the pair stage only runs when nothing did)."""
        for k in range(len(remaining), 1, -1):
            prefix = remaining[:k]
            if device_verdicts is not None:
                v = device_verdicts.get(k)
                if v is None or not self._device_replacement_cheaper_multi(prefix, v):
                    continue
            # the whole prefix drains behind one launch, so budget-check it
            # as a unit: members from one pool count against that pool's
            # budget cumulatively
            if not self._budget_allows_set(prefix, disrupting, totals):
                continue
            ok, groups = self._simulate(prefix, allow_new_node=True)
            if ok and groups and self._replacement_cheaper(prefix, groups):
                for c in prefix:
                    c.claim.status_conditions.set_true(COND_CONSOLIDATABLE)
                self._replace_then_disrupt(prefix, groups, REASON_UNDERUTILIZED, disrupting)
                return True
        return False

    def _budget_allows_set(self, cands: List[Candidate], disrupting: Dict[str, int],
                           totals: Dict[str, int]) -> bool:
        """Budget-check a candidate set as a UNIT (the whole set drains
        behind one decision): members from one pool count against that
        pool's budget cumulatively."""
        trial = dict(disrupting)
        for c in cands:
            if not self._budget_allows(c.nodepool, REASON_UNDERUTILIZED, trial, totals):
                return False
            trial[c.nodepool.name] = trial.get(c.nodepool.name, 0) + 1
        return True

    def _pair_consolidation(
        self,
        remaining: List[Candidate],
        device_verdicts: Optional[Dict[object, object]],
        disrupting: Dict[str, int],
        totals: Dict[str, int],
        max_disruptions: int,
    ) -> bool:
        """Underutilized pairs OUTSIDE the prefix order: two nodes whose
        pods only fold together (or onto one cheaper replacement) even
        though no contiguous disruption-cost prefix worked -- the
        multi-node shape the reference's descending-k loop cannot see.
        Pairs come from solver/disrupt.enumerate_pairs over the cheapest
        candidates (bounded window, (0, 1) excluded: that set IS the k=2
        prefix already judged). The device batch pre-filters; deletion
        verdicts apply directly (exact equivalence) while replacement
        re-derives through the oracle -- and the oracle-only path runs
        the same pair order through the same simulations, so decisions
        agree with and without the engine."""
        from karpenter_tpu_torch.solver.disrupt import enumerate_pairs

        def delete_pair(pair: List[Candidate]) -> None:
            # _budget_allows_set above already proved both members fit the
            # pool budgets with exactly this accumulation
            for c in pair:
                c.claim.status_conditions.set_true(COND_CONSOLIDATABLE)
                self._disrupt(c, REASON_UNDERUTILIZED, disrupting)

        def replace_pair(pair: List[Candidate]) -> bool:
            ok, groups = self._simulate(pair, allow_new_node=True)
            if ok and groups and self._replacement_cheaper(pair, groups):
                for c in pair:
                    c.claim.status_conditions.set_true(COND_CONSOLIDATABLE)
                self._replace_then_disrupt(pair, groups, REASON_UNDERUTILIZED, disrupting)
                return True
            return False

        for i, j in enumerate_pairs(len(remaining)):
            if len(self.last_decisions) >= max_disruptions:
                return False
            pair = [remaining[i], remaining[j]]
            if not self._budget_allows_set(pair, disrupting, totals):
                continue
            if device_verdicts is not None:
                v = device_verdicts.get(("pair", i, j))
                if v is None:
                    continue
                if v.can_delete:
                    # deletion decisions are oracle-equivalent
                    # (differential tests): act without re-simulation
                    delete_pair(pair)
                    return True
                if self._device_replacement_cheaper_multi(pair, v) and replace_pair(pair):
                    return True
                continue
            # oracle path: same order, same checks
            ok, _ = self._simulate(pair, allow_new_node=False)
            if ok:
                delete_pair(pair)
                return True
            if replace_pair(pair):
                return True
        return False

    def _device_prefix_verdicts(self, remaining: List[Candidate]):
        """Multi-node candidate-set batch, ONE device dispatch with
        replacement context: a SetVerdict for every prefix (keyed k =
        2..N of the disruption-cost order) AND every underutilized pair
        (keyed ("pair", i, j) from solver/disrupt.enumerate_pairs) --
        serves the deletion decisions, the multi-node replacement price
        gate, and the pair stage. None when any pod is device-ineligible
        (the oracle loops judge the same sets themselves)."""
        if self.evaluator is None or len(remaining) < 2:
            return None
        from karpenter_tpu_torch import metrics
        from karpenter_tpu_torch.apis.storage import effective_pods
        from karpenter_tpu_torch.solver.disrupt import device_eligible, enumerate_pairs

        # same volume lowering as _device_verdicts: raw claim-carrying
        # pods would under-state attach demand in the prefix repacks
        vol_index = self._vol_index()
        resched = {}
        for c in remaining:
            eff, blocked = effective_pods(
                [p for p in c.pods if p.reschedulable()], vol_index
            )
            if blocked:
                return None
            resched[c.claim.metadata.name] = eff
        # vol-blocked in-flight pods are dropped, same as _simulate: they
        # must not push every candidate onto the oracle path either
        in_flight = self._effective_in_flight(vol_index)
        if not all(
            device_eligible(resched[c.claim.metadata.name]) for c in remaining
        ) or not device_eligible(in_flight):
            return None

        def one_set(members: List[Candidate]):
            return (
                in_flight + [p for c in members for p in resched[c.claim.metadata.name]],
                [c.node.metadata.name for c in members],
            )

        sets = []
        keys: List[object] = []
        for k in range(2, len(remaining) + 1):
            sets.append(one_set(remaining[:k]))
            keys.append(k)
        n_prefix = len(sets)
        for i, j in enumerate_pairs(len(remaining)):
            sets.append(one_set([remaining[i], remaining[j]]))
            keys.append(("pair", i, j))
        self._pass_set_counts["prefix"] = (
            self._pass_set_counts.get("prefix", 0) + n_prefix)
        self._pass_set_counts["pair"] = (
            self._pass_set_counts.get("pair", 0) + len(sets) - n_prefix)
        metrics.DISRUPTION_DEVICE_SETS.inc(n_prefix, kind="prefix")
        metrics.DISRUPTION_DEVICE_SETS.inc(len(sets) - n_prefix, kind="pair")
        pools, catalogs = self._pool_context()
        verdicts = self.evaluator.evaluate(
            self._other_nodes(list(self._pass_disrupted)), sets,
            pools=pools, catalogs=catalogs,
            daemon_overhead=self._daemon_overhead(pools),
        )
        return dict(zip(keys, verdicts))

    def _device_replacement_cheaper_multi(self, prefix: List[Candidate], v) -> bool:
        import math

        price = v.replace_price
        if any(
            c.claim.capacity_type == wk.CAPACITY_TYPE_SPOT for c in prefix
        ) and not self.feature_gates.get("SpotToSpotConsolidation"):
            price = v.replace_od_price
        return math.isfinite(price) and price < sum(c.price for c in prefix)

    def _largest_deletable_prefix(
        self, remaining: List[Candidate],
        device_verdicts: Optional[Dict[object, object]] = None,
    ) -> List[Candidate]:
        """Largest k such that candidates[0:k] can all be deleted with their
        pods repacked on surviving capacity. `device_verdicts` is the
        per-prefix batch from _device_prefix_verdicts (one dispatch serves
        deletion AND the replacement price gate); None falls back to the
        oracle's descending-k simulation loop."""
        if len(remaining) < 2:
            return []
        if device_verdicts is not None:
            for k in range(len(remaining), 1, -1):  # largest k first
                v = device_verdicts.get(k)
                if v is not None and v.can_delete:
                    return remaining[:k]
            return []
        k = len(remaining)
        while k >= 2:
            subset = remaining[:k]
            ok, _ = self._simulate(subset, allow_new_node=False)
            if ok:
                return subset
            k -= 1
        return []

    def _device_verdicts(self, consolidatable: Sequence[Candidate],
                         replacement: bool = True) -> Dict[str, object]:
        """One batched device evaluation of every eligible single-node
        candidate; ineligible candidates (stateful constraints) are absent
        from the result and take the oracle path. ``replacement=False``
        (the brownout-bounded sweep) skips the per-pool replacement
        context entirely: deletion verdicts only, minimum host encode."""
        if self.evaluator is None or not consolidatable:
            return {}
        from karpenter_tpu_torch import metrics
        from karpenter_tpu_torch.apis.storage import effective_pods
        from karpenter_tpu_torch.solver.disrupt import device_eligible

        # volume-backed pods evaluate as their RESOLVED scheduling copies
        # (attach counts on the volume axis, bound zones as selector pins
        # -- apis/storage): the raw objects would under-state demand and
        # let can_delete overcommit surviving nodes' attach budgets.
        # Survivor headroom already counts attachments (_other_nodes ->
        # node_usage), so both sides of the repack see the same axis.
        vol_index = self._vol_index()
        # vol-blocked in-flight pods are dropped (logged), same as
        # _simulate: one frozen PVC must not disable the fast path
        in_flight = self._effective_in_flight(vol_index)
        if in_flight and not device_eligible(in_flight):
            # in-flight pods carry stateful constraints the evaluator does
            # not model; every remaining candidate takes the oracle path
            return {}
        eligible: List[Candidate] = []
        sets = []
        for c in consolidatable:
            resched = [p for p in c.pods if p.reschedulable()]
            resched, blocked = effective_pods(resched, vol_index)
            if blocked or not resched or not device_eligible(resched):
                continue  # unresolvable claims etc.: the oracle path decides
            eligible.append(c)
            # in-flight pods repack jointly with the candidate's: the
            # verdict only says can_delete when BOTH fit the survivors
            sets.append((in_flight + resched, [c.node.metadata.name]))
        if not eligible:
            return {}
        self._pass_set_counts["singleton"] = (
            self._pass_set_counts.get("singleton", 0) + len(sets))
        metrics.DISRUPTION_DEVICE_SETS.inc(len(sets), kind="singleton")
        if replacement:
            pools, catalogs = self._pool_context()
            verdicts = self.evaluator.evaluate(
                self._other_nodes(list(self._pass_disrupted)), sets,
                pools=pools, catalogs=catalogs,
                daemon_overhead=self._daemon_overhead(pools),
            )
        else:
            verdicts = self.evaluator.evaluate(
                self._other_nodes(list(self._pass_disrupted)), sets,
            )
        return {c.claim.metadata.name: v for c, v in zip(eligible, verdicts)}

    def _device_replacement_cheaper(self, c: Candidate, v) -> bool:
        """Price gate over the device verdict, mirroring
        _replacement_cheaper's spot-to-spot feature gating."""
        price = v.replace_price
        if c.claim.capacity_type == wk.CAPACITY_TYPE_SPOT and not self.feature_gates.get(
            "SpotToSpotConsolidation"
        ):
            price = v.replace_od_price
        return price < c.price

    def _drift_reason(self, c: Candidate) -> Optional[str]:
        if c.nodepool is None:
            # standalone claim: only the cloud-side drift kinds apply
            # (incl. the nodeclass static hash the lifecycle controller
            # stamps); there is no pool to drift against
            try:
                return self.cloud_provider.is_drifted(c.claim)
            except CloudError:
                return None
        # nodepool static drift via stamped hash
        pool_hash = c.claim.metadata.annotations.get(wk.NODEPOOL_HASH_ANNOTATION)
        if pool_hash is not None and pool_hash != c.nodepool.static_hash():
            return "NodePoolDrifted"
        # dynamic requirement drift (the upstream NodeRequirement kind):
        # requirements are deliberately OUTSIDE the static hash -- a pool
        # whose requirements changed only drifts the claims whose concrete
        # labels the CURRENT requirements no longer admit. Same machinery
        # and absence semantics as scheduling compatibility everywhere
        # else: only well-known labels may be undefined on the claim side,
        # so a newly demanded custom label drifts pre-existing nodes.
        from karpenter_tpu_torch.scheduling import Requirements

        labels = {**c.claim.metadata.labels, **c.node.metadata.labels}
        if not Requirements.from_labels(labels).compatible(
            c.nodepool.requirements(), allow_undefined=wk.WELL_KNOWN_LABELS
        ):
            return "NodeRequirementDrifted"
        try:
            return self.cloud_provider.is_drifted(c.claim)
        except CloudError:
            return None

    def _replacement_cheaper(self, cands, groups) -> bool:
        """Replacement must be strictly cheaper than the candidate set's
        aggregate price; spot->spot consolidation is feature-gated
        (reference gates SpotToSpotConsolidation). Accepts one Candidate or
        a list (multi-node consolidation compares against the sum)."""
        if isinstance(cands, Candidate):
            cands = [cands]
        if not groups:
            return True
        any_spot = any(c.claim.capacity_type == wk.CAPACITY_TYPE_SPOT for c in cands)
        od_only = any_spot and not self.feature_gates.get("SpotToSpotConsolidation")

        def group_price(g) -> tuple:
            """(price, capacity type) of the cheapest offering the group
            can actually LAUNCH: restricted to the group's narrowed
            zone/captype requirements (a group whose pods demand on-demand
            must not be priced at spot), and to on-demand under the
            spot->spot gate."""
            zreq = g.requirements.get(wk.ZONE_LABEL)
            creq = g.requirements.get(wk.CAPACITY_TYPE_LABEL)
            best = float("inf")
            best_ct = None
            for it in g.instance_types:
                for o in it.available_offerings():
                    if zreq is not None and not zreq.matches(o.zone):
                        continue
                    if creq is not None and not creq.matches(o.capacity_type):
                        continue
                    if od_only and o.capacity_type != wk.CAPACITY_TYPE_ON_DEMAND:
                        continue
                    if o.price < best:
                        best = o.price
                        best_ct = o.capacity_type
            return best, best_ct

        priced = [group_price(g) for g in groups]
        if any(p == float("inf") for p, _ in priced):
            return False  # a group with no launchable offering cannot be priced
        total_new = sum(p for p, _ in priced)
        budget = sum(c.price for c in cands)
        # the SUM of the replacement groups' launch prices must beat the
        # candidate set's aggregate -- comparing only the cheapest group
        # against the full budget (the pre-r4 check) let a multi-group
        # replacement whose total exceeded the candidates' pass (ADVICE
        # round 3)
        if total_new >= budget:
            return False
        if any_spot and not od_only:
            # spot->spot: EVERY group whose cheapest launchable offering is
            # spot must keep >= 15 cheaper launchable spot options, or the
            # savings buy re-interruption churn; one well-diversified group
            # must not ungate its siblings. "Cheaper" is judged against the
            # group's RESIDUAL budget (candidate-set price minus what the
            # other groups cost), not the aggregate -- for single-node
            # consolidation this is exactly the candidate node's price.
            # Groups launching on-demand are exempt.
            def cheaper_spot_types(g, target: float) -> int:
                zreq = g.requirements.get(wk.ZONE_LABEL)
                creq = g.requirements.get(wk.CAPACITY_TYPE_LABEL)
                n = 0
                for it in g.instance_types:
                    for o in it.available_offerings():
                        if o.capacity_type != wk.CAPACITY_TYPE_SPOT:
                            continue
                        if creq is not None and not creq.matches(o.capacity_type):
                            continue
                        if zreq is not None and not zreq.matches(o.zone):
                            continue
                        if o.price < target:
                            n += 1
                            break
                return n

            for g, (price, ct) in zip(groups, priced):
                if ct != wk.CAPACITY_TYPE_SPOT:
                    continue  # spot -> on-demand: gate does not apply
                residual = budget - (total_new - price)
                if cheaper_spot_types(g, residual) < MIN_TYPES_SPOT_TO_SPOT:
                    return False
        return True

    # -- execution ----------------------------------------------------------
    def _disrupt(self, c: Candidate, reason: str, disrupting: Dict[str, int]) -> None:
        from karpenter_tpu_torch import metrics

        self.cluster.delete(NodeClaim, c.claim.metadata.name)
        self._pass_disrupted.append(c.node.metadata.name)
        pool_name = c.nodepool.name if c.nodepool is not None else "<standalone>"
        disrupting[pool_name] = disrupting.get(pool_name, 0) + 1
        self.last_decisions.append((c.claim.metadata.name, reason))
        metrics.DISRUPTION_DECISIONS.inc(reason=reason)
        if self.recorder is not None:
            # the core publishes a Disrupted event per acted candidate
            # (events.Recorder through the disruption controller)
            self.recorder.publish(
                c.claim, "Disrupted",
                f"disrupting via {reason} ({len(c.pods)} pods reschedule)",
            )
        self.log.info(
            "disrupting node",
            nodeclaim=c.claim.metadata.name,
            nodepool=pool_name,
            reason=reason,
            pods=len(c.pods),
        )

    def _replace_then_disrupt(self, cands, groups, reason: str, disrupting: Dict[str, int]) -> None:
        """Launch the replacement before draining (consolidation.md: delete
        the expensive node only 'when [the replacement] is ready'). If the
        replacement launch fails (e.g. ICE at fleet time), the old nodes are
        KEPT -- disrupting without a live replacement is the capacity gap
        this ordering exists to prevent. Accepts one Candidate or a list
        (multi-node consolidation drains the whole set behind one launch)."""
        from karpenter_tpu_torch.controllers.provisioner import Provisioner
        from karpenter_tpu_torch.solver.oracle import SchedulingResult

        from karpenter_tpu_torch import failpoints

        if isinstance(cands, Candidate):
            cands = [cands]
        prov = Provisioner(self.cluster, self.cloud_provider)
        result = SchedulingResult()
        result.new_groups = list(groups)
        prov._launch(result)
        if result.unschedulable:
            return  # replacement did not materialize; try again next tick
        # chaos site: a crash HERE is the half-applied verdict -- the
        # replacement launched (journaled through the provisioner's
        # intent path) but no victim deleted yet. The crash soak asserts
        # the next incarnation's recovery sweep + consolidation passes
        # converge with no pod lost, no orphan instance, and no node
        # disrupted twice (tests/test_chaos.py).
        failpoints.eval("crash.disruption.apply")
        for c in cands:
            self._disrupt(c, reason, disrupting)
