"""Provisioning controller: pending pods -> NodeClaims -> launched capacity.

Rebuilds the core provisioner reconcile (SURVEY.md section 3.1): snapshot
pending pods and cluster capacity, run the scheduling simulation (oracle or
TPU solver), create one NodeClaim per simulated node group, and call
CloudProvider.Create. In-flight NodeClaims participate in the next
simulation as virtual nodes so repeated ticks don't double-provision.

Copy of karpenter_tpu/controllers/provisioner.py, imports rewritten to the port's.
The provisioner hands the port's own `Pod` and `Scheduler` to
`TorchSolver` (`schedule_begin`/`schedule_finish`, `schedule`). One
addition: `PodBinder`'s first-fit cursors per grouping signature, which
skip nodes a same-shape pod was already refused by in the same reconcile
(decisions unchanged; a 10,000-pod wave waiting for new nodes otherwise
rescans every full node per pod).
"""
from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from itertools import chain, islice
from typing import Dict, List, Optional

import time

from karpenter_tpu_torch.apis import NodeClaim, NodePool, Node, labels as wk
from karpenter_tpu_torch import events, metrics, tracing
from karpenter_tpu_torch.logging import get_logger
from karpenter_tpu_torch.apis.nodeclass import HASH_ANNOTATION, HASH_VERSION, HASH_VERSION_ANNOTATION, TPUNodeClass
from karpenter_tpu_torch.apis.objects import generate_name
from karpenter_tpu_torch.cloudprovider import CloudProvider
from karpenter_tpu_torch.errors import CloudError
from karpenter_tpu_torch.kwok.cluster import Cluster
from karpenter_tpu_torch.scheduling import Resources
from karpenter_tpu_torch.scheduling import resources as res
from karpenter_tpu_torch.solver.oracle import ExistingNode, NewNodeGroup, Scheduler, SchedulingResult

MAX_TYPES_PER_CLAIM = 60  # mirror of the launch truncation for claim size


def launch_all(cloud_provider, claims, max_workers: int):
    """Shared cloud-launch fan-out: returns one outcome (None | CloudError)
    per claim, in order. The launch-window expectation announces the wave
    size to the fleet batcher so identical requests rendezvous into one
    merged fleet call; it is capped at the worker-pool size because only
    that many calls can be in flight at once, and an expectation the pool
    cannot satisfy would stall every wave on the batcher's idle timeout
    (pkg/batcher/createfleet.go:36-46). Used by the provisioner AND the
    standalone nodeclaim lifecycle -- one copy of the protocol."""
    # fan-out workers inherit the dispatching thread's span context, so
    # the coalesced fleet calls' batcher spans land under the tick's
    # launch span instead of vanishing on the pool threads
    parent_span = tracing.TRACER.current()

    def launch_one(claim):
        with tracing.TRACER.attach(parent_span):
            try:
                cloud_provider.create(claim)
                return None
            except CloudError as e:
                return e
            except Exception as e:  # noqa: BLE001
                # a failure OUTSIDE the cloud-error taxonomy (a batcher
                # executor bug, an injected fault) must cost its one claim,
                # not escape the pool.map and kill the whole launch fan-out
                return CloudError(f"{type(e).__name__}: {e}")

    if len(claims) == 1:
        return [launch_one(claims[0])]
    expected = min(len(claims), max_workers)
    with cloud_provider.launch_window(expected):
        with ThreadPoolExecutor(max_workers=max_workers) as pool:
            return list(pool.map(launch_one, claims))


class _PodRef:
    """Event-target shim: unschedulable reasons are keyed by pod NAME in
    SchedulingResult (the pod object may be an effective volume copy)."""

    KIND = "Pod"

    def __init__(self, name: str):
        self.name = name

TERMINATION_FINALIZER = "karpenter.sh/termination"
# virtual-capacity pseudo-node prefix: launched-but-not-ready claims join
# the scheduling snapshot under this name (never a real node; k8s node
# names cannot contain '/'). Shared by the snapshot construction and the
# binder-hint strip below.
INFLIGHT_PREFIX = "inflight/"


class Provisioner:
    log = get_logger("provisioner")

    def __init__(
        self, cluster: Cluster, cloud_provider: CloudProvider, solver=None,
        recorder=None, pipeline: Optional[bool] = None, journal=None,
        admission_max_pods: int = 0, launch_max_groups: int = 0,
    ):
        self.cluster = cluster
        self.cloud_provider = cloud_provider
        self.solver = solver  # optional TPU solver; None = oracle
        self.recorder = recorder  # optional events.Recorder
        # optional IntentJournal (karpenter_tpu_torch/journal.py): every launch
        # writes a durable intent BEFORE the cloud call and resolves it
        # after the claim status commit -- the crash-consistency protocol
        self.journal = journal
        self.last_result: Optional[SchedulingResult] = None
        # pod name -> claim name from the last scheduling decisions: the
        # binder tries the DECIDED node first instead of re-searching the
        # whole fleet per pod (round 5: the generic scan was O(pods x
        # nodes) per tick at 50k scale). Purely a fast path -- every hint
        # is re-validated by the same fit/affinity/spread checks, and a
        # failed hint falls back to the full scan.
        self._assignment_hints: Dict[str, str] = {}
        # double-buffered tick (the pipelined PRODUCTION path): under
        # SUSTAINED load the solver's device dispatch for tick N stays in
        # flight across the rest of the controller sweep, and tick N+1
        # drains it FIRST (launching its claims), then snapshots and
        # dispatches the next batch -- so the device round trip overlaps
        # everything between two provisioner reconciles instead of
        # blocking inside one. Drain-before-snapshot keeps every solve's
        # input consistent (no two in-flight batches can double-book
        # existing capacity), which is what makes each batch's decision
        # bit-identical to a synchronous solve of the same snapshot.
        # The pipeline engages only from the SECOND consecutive tick with
        # pending pods (cold ticks run the synchronous path: a single
        # burst still gets its decision the same tick).
        self.pipeline = pipeline if pipeline is not None else True
        # (ticket, vol_blocked, host_s, n_pods, dispatched_at) -- the
        # dispatch timestamp feeds the overlap-fraction attribution at
        # the next tick's drain barrier
        self._inflight = None
        self._sustained = False
        # bounded admission (overload tentpole, karpenter_tpu_torch/overload.py):
        # admission_max_pods caps how many pending pods one tick may solve
        # (0 = unbounded); launch_max_groups caps the launch fan-out in
        # whole decision groups (0 = unbounded). Over the caps, the tick
        # solves a deterministic priority/age-ordered PREFIX and defers
        # the rest -- see _admit.
        self.admission_max_pods = int(admission_max_pods)
        self.launch_max_groups = int(launch_max_groups)
        # EWMA of the per-pod solve cost (seconds/pod), fed by
        # _apply_decision: the deadline-budget admission sizing divides
        # the tick's solve budget by this to size the admitted prefix
        self._solve_cost_ewma = 0.0
        # last logged shed shape, so a sustained storm logs level changes
        # rather than one line per tick
        self._last_shed_logged: Optional[tuple] = None

    # -- snapshot -----------------------------------------------------------
    def _existing_nodes(self) -> List[ExistingNode]:
        from karpenter_tpu_torch.apis.storage import VolumeIndex

        out = []
        vol_index = VolumeIndex.from_cluster(self.cluster)
        live = [
            n for n in self.cluster.list(Node)
            if not n.deleting and not n.unschedulable and n.ready
        ]
        usage = self.cluster.node_usage_map(
            [n.metadata.name for n in live], vol_index)
        for node in live:
            out.append(
                ExistingNode(
                    name=node.metadata.name,
                    labels=dict(node.metadata.labels),
                    allocatable=node.allocatable,
                    taints=list(node.taints),
                    used=usage[node.metadata.name],
                )
            )
        # launched-but-not-YET-ready claims are virtual capacity
        for claim in self.cluster.list(NodeClaim):
            if claim.deleting or not claim.launched():
                continue
            node = self.cluster.node_for_nodeclaim(claim)
            if node is not None and node.ready:
                continue  # already counted above
            if claim.initialized() and node is not None:
                # the node initialized and LOST readiness: an unhealthy node
                # awaiting repair, not in-flight capacity. Counting it as an
                # empty virtual node wedges provisioning -- pending pods
                # simulate onto it every tick while the binder (correctly)
                # refuses to bind to a NotReady node.
                continue
            labels = dict(claim.metadata.labels)
            labels.update(claim.requirements.labels())
            out.append(
                ExistingNode(
                    name=INFLIGHT_PREFIX + claim.metadata.name,
                    labels=labels,
                    allocatable=claim.allocatable,
                    taints=list(claim.taints),  # startup taints excluded: they lift before pods land
                    used=Resources(),
                )
            )
        return out

    def _pods_by_node(self) -> Dict[str, List]:
        out: Dict[str, List] = {}
        from karpenter_tpu_torch.apis import Pod

        for p in self.cluster.list(Pod):
            if p.node_name:
                out.setdefault(p.node_name, []).append(p)
        return out

    # -- reconcile ----------------------------------------------------------
    def reconcile(self) -> SchedulingResult:
        with tracing.span("provisioner"):
            return self._reconcile()

    def _reconcile(self) -> SchedulingResult:
        from karpenter_tpu_torch import failpoints
        from karpenter_tpu_torch.apis.storage import VolumeIndex, effective_pods

        # crash site: the operator dies at the top of the provisioner
        # dispatch (nothing launched yet; restart must re-simulate cleanly)
        failpoints.eval("crash.provisioner.dispatch")
        # stall site: the tick WEDGES here (before any solver dispatch) --
        # the stuck-tick watchdog's escalation drill
        failpoints.eval("stall.provisioner.solve")
        # pipeline barrier FIRST: the decision dispatched last tick lands
        # and its claims launch before this tick snapshots, so the new
        # snapshot sees that capacity in flight (drain-before-snapshot --
        # see __init__) and no two batches ever overlap
        prev = self._drain_pipeline()
        pods = self._admit(self.cluster.pending_pods())
        result = SchedulingResult()
        if not pods:
            self._sustained = False
            self.last_result = prev if prev is not None else result
            return self.last_result
        # lower volume claims into solver vocabulary (attach counts on the
        # attachable-volumes axis, bound zones as selector pins); pods
        # whose claims cannot resolve are unschedulable this tick
        # (apis/storage module docstring; the reference core's volume
        # topology translation does the same lowering)
        pods, vol_blocked = effective_pods(pods, VolumeIndex.from_cluster(self.cluster))
        result.unschedulable.update(vol_blocked)
        if not pods:
            self._sustained = False
            metrics.IGNORED_PODS.set(len(result.unschedulable))
            self._publish_unschedulable(result)
            self.last_result = result
            return result
        with tracing.span("snapshot") as snap_sp:
            nodepools = [p for p in self.cluster.list(NodePool) if not p.deleting]
            catalogs: Dict[str, List] = {}
            zones = set()
            for pool in nodepools:
                try:
                    items = self.cloud_provider.get_instance_types(pool)
                except CloudError:
                    items = []
                catalogs[pool.name] = items
                for it in items:
                    for o in it.available_offerings():
                        zones.add(o.zone)
            from karpenter_tpu_torch.apis import DaemonSet
            from karpenter_tpu_torch.apis.daemonset import overhead_by_pool

            scheduler = Scheduler(
                nodepools=nodepools,
                instance_types=catalogs,
                existing_nodes=self._existing_nodes(),
                pods_by_node=self._pods_by_node(),
                nodepool_usage={p.name: self.cluster.nodepool_usage(p.name) for p in nodepools},
                zones=zones,
                # fresh nodes reserve the daemonsets that will land on them
                # (apis/daemonset; the reference core sizes simulated nodes
                # the same way)
                daemon_overhead=overhead_by_pool(self.cluster.list(DaemonSet), nodepools),
            )
            snap_sp.set(pods=len(pods), nodepools=len(nodepools))
        t0 = time.perf_counter()
        sustained = self._sustained
        self._sustained = True
        if (
            self.pipeline and sustained and self.solver is not None
            and hasattr(self.solver, "schedule_begin")
            # degraded wire (solver breaker open): tick SYNCHRONOUSLY.
            # The CPU fallback leaves nothing remote in flight to overlap,
            # and a synchronous tick applies its decision immediately --
            # no decision rides a barrier into a tick that may degrade
            # differently (solver/breaker.py)
            and getattr(self.solver, "wire_healthy", lambda: True)()
        ):
            # sustained load: dispatch this batch and let the device round
            # trip ride under the rest of the sweep; the barrier lands at
            # the top of the next reconcile. Batches that route off the
            # plain device path come back already completed (nothing in
            # flight to overlap) and apply immediately below.
            with tracing.span("dispatch", mode="pipelined") as disp_sp:
                ticket = self.solver.schedule_begin(scheduler, pods)
                disp_sp.set(completed_at_begin=ticket.completed)
                self._annotate_group_stats(disp_sp)
            if not ticket.completed:
                metrics.SOLVER_PIPELINE_TICKS.inc(mode="pipelined")
                self._inflight = (
                    ticket, vol_blocked, time.perf_counter() - t0, len(pods),
                    time.perf_counter(),
                )
                self.last_result = prev if prev is not None else result
                return self.last_result
            decision = ticket.done
        elif self.solver is not None:
            with tracing.span("dispatch", mode="synchronous") as disp_sp:
                decision = self.solver.schedule(scheduler, pods)
                self._annotate_group_stats(disp_sp)
        else:
            with tracing.span("dispatch", mode="oracle"):
                decision = scheduler.schedule(pods)
        metrics.SOLVER_PIPELINE_TICKS.inc(mode="synchronous")
        return self._apply_decision(
            decision, vol_blocked, time.perf_counter() - t0, len(pods)
        )

    # bounded-admission progress floor: even a fully blown deadline budget
    # admits this many pods, so a storm can never starve provisioning
    MIN_ADMIT = 8

    def _admit(self, pods: List) -> List:
        """Bounded admission with priority-aware shedding (the overload
        tentpole): when the pending set exceeds what this tick can solve
        -- the explicit admission cap, or what the tick-deadline budget
        can afford at the EWMA per-pod solve cost -- solve a
        deterministic priority/age-ordered PREFIX and defer the rest.
        Deferred pods simply stay pending and re-enter next tick's
        ordering, so nothing is lost, only delayed; as placed pods leave
        the pending set, the FIFO-within-priority order guarantees every
        deferred pod eventually admits.

        The prefix is a pure function of the pod set -- priority desc,
        creation asc, name asc, with creation stamps from the injectable
        cluster clock -- so sim replays shed identically on every
        backend, and the admitted prefix's decision is bit-identical to
        an unloaded solve of those same pods (it flows through exactly
        the same solve)."""
        from karpenter_tpu_torch import overload

        n = len(pods)
        limit, reason = n, ""
        if 0 < self.admission_max_pods < limit:
            limit, reason = self.admission_max_pods, "admission-cap"
        budget = overload.current()
        if budget is not None and self._solve_cost_ewma > 0.0:
            afford = max(
                self.MIN_ADMIT, int(budget.solve_budget() / self._solve_cost_ewma)
            )
            if afford < limit:
                limit, reason = afford, "deadline"
        if limit >= n:
            metrics.OVERLOAD_DEFERRED.set(0.0)
            self._last_shed_logged = None
            return pods
        admitted = sorted(
            pods,
            key=lambda p: (
                -p.priority, p.metadata.creation_timestamp, p.metadata.name,
            ),
        )[:limit]
        shed = n - limit
        metrics.OVERLOAD_SHED.inc(shed, reason=reason)
        metrics.OVERLOAD_DEFERRED.set(float(shed))
        tracing.annotate(admitted=limit, shed=shed, shed_reason=reason)
        if self._last_shed_logged != (limit, reason):
            self._last_shed_logged = (limit, reason)
            self.log.info(
                "overload: admission shed", admitted=limit, shed=shed,
                reason=reason,
            )
        return admitted

    def _annotate_group_stats(self, sp) -> None:
        """Surface the solver's dirty-tracking grouping stats (incremental
        tick engine) on the dispatch span: how much of the pending set
        actually churned since the last tick is the number that explains
        why a warm tick was cheap (or was not)."""
        st = getattr(self.solver, "last_group_stats", None)
        if not st:
            return
        sp.set(
            group_classes=st.get("classes", 0),
            group_dirty=st.get("dirty_classes", 0),
            group_dirty_fraction=round(st.get("dirty_fraction", 1.0), 4),
        )

    def _drain_pipeline(self) -> Optional[SchedulingResult]:
        """The explicit pipeline barrier: complete the decision dispatched
        last tick (fetch + decode via the solver's schedule_finish, which
        handles mid-flight catalog changes and wire degrades) and launch
        its claims. Returns None when nothing was in flight."""
        infl = self._inflight
        if infl is None:
            return None
        self._inflight = None
        ticket, vol_blocked, host_s, n_pods, dispatched_at = infl
        with tracing.span("drain", pods=n_pods) as sp:
            t0 = time.perf_counter()
            decision = self.solver.schedule_finish(ticket)
            barrier_s = time.perf_counter() - t0
            # overlap fraction: how much of the decision's device+wire
            # round trip was HIDDEN under the sweep between dispatch and
            # this barrier. hidden = dwell between dispatch return and the
            # barrier (the fetch streamed through it); barrier = the wait
            # this tick actually paid. 1.0 = the device time cost the
            # controller nothing; -> 0 = the pipeline hid nothing.
            hidden_s = max(0.0, t0 - dispatched_at)
            round_trip = hidden_s + barrier_s
            overlap = hidden_s / round_trip if round_trip > 0 else 1.0
            metrics.PIPELINE_OVERLAP.observe(overlap)
            sp.set(
                overlap_fraction=round(overlap, 4),
                hidden_ms=round(hidden_s * 1e3, 3),
                barrier_ms=round(barrier_s * 1e3, 3),
            )
            # decision latency = host stages at dispatch + the barrier's own
            # work; the deliberate overlap dwell between ticks is not decision
            # time (the fetch was streaming through it)
            return self._apply_decision(
                decision, vol_blocked, host_s + barrier_s, n_pods
            )

    def _apply_decision(
        self, result: SchedulingResult, vol_blocked: Dict[str, str],
        duration_s: float, n_pods: int,
    ) -> SchedulingResult:
        result.unschedulable.update(vol_blocked)
        metrics.SCHEDULING_DURATION.observe(duration_s)
        if n_pods > 0 and duration_s > 0:
            # per-pod solve cost EWMA: the deadline-budget admission
            # sizing's denominator (_admit). Alpha 0.3: reactive enough to
            # track a degrading sidecar within a few ticks, smooth enough
            # that one outlier tick does not collapse admission.
            per_pod = duration_s / n_pods
            self._solve_cost_ewma = (
                per_pod if self._solve_cost_ewma <= 0.0
                else 0.7 * self._solve_cost_ewma + 0.3 * per_pod
            )
        metrics.IGNORED_PODS.set(len(result.unschedulable))
        self._publish_unschedulable(result)
        # existing-node decisions hint the binder directly (node names).
        # A still-pending pod re-decided onto IN-FLIGHT virtual capacity
        # ("inflight/<claim>") hints to the claim name itself -- that is
        # the node name it will register under; hinting the pseudo-name
        # verbatim would overwrite a good hint with one that never
        # resolves and push every such pod onto the full binder scan
        # (round-5 regression: a one-tick readiness lag made 50k binds
        # quadratic again).
        for pod_name, node_name in result.existing_assignments.items():
            if node_name.startswith(INFLIGHT_PREFIX):
                node_name = node_name[len(INFLIGHT_PREFIX):]
            self._assignment_hints[pod_name] = node_name
        if result.new_groups or result.unschedulable:
            self.log.info(
                "scheduling decision",
                pods=n_pods,
                new_groups=len(result.new_groups),
                bound_existing=len(result.existing_assignments),
                unschedulable=len(result.unschedulable),
            )
        self._launch(result)
        self.last_result = result
        return result

    def _publish_unschedulable(self, result: SchedulingResult) -> None:
        """Per-pod FailedScheduling events with the decision's reason (the
        core publishes the same through its events.Recorder); the
        recorder's window dedups repeats across ticks."""
        if self.recorder is None:
            return
        for pod_name, reason in result.unschedulable.items():
            self.recorder.publish(
                _PodRef(pod_name), "FailedScheduling", reason, type=events.WARNING,
            )

    # -- NodeClaim creation + launch ---------------------------------------
    # worker parallelism for cloud launches, mirroring the reference's
    # MaxConcurrentReconciles: 10 (SURVEY.md section 2.4 row 1). Running
    # launches concurrently is also what makes the fleet batching window
    # effective: identical requests land in the same bucket before the
    # first waiter's flush fires (pkg/batcher/createfleet.go:36-46)
    MAX_CONCURRENT_LAUNCHES = 10

    def _launch(self, result: SchedulingResult) -> None:
        from karpenter_tpu_torch import failpoints

        # stall site: the launch fan-out WEDGES before any cloud call
        # (watchdog escalation drill; nothing is in flight yet)
        failpoints.eval("stall.launch")
        groups = result.new_groups
        if not groups:
            return
        if 0 < self.launch_max_groups < len(groups):
            # bounded launch fan-out (overload tentpole): whole decision
            # groups past the bound are DEFERRED -- their claims are never
            # created, their pods simply stay pending and re-solve next
            # tick. The launched prefix's decision is untouched.
            deferred = groups[self.launch_max_groups:]
            groups = groups[: self.launch_max_groups]
            n_deferred = sum(len(g.pods) for g in deferred)
            metrics.OVERLOAD_SHED.inc(n_deferred, reason="launch-bound")
            self.log.info(
                "overload: launch fan-out bound",
                launched_groups=len(groups), deferred_groups=len(deferred),
                deferred_pods=n_deferred,
            )
        with tracing.span("launch", groups=len(groups)):
            self._launch_groups(result, groups)

    def _launch_groups(self, result: SchedulingResult, groups) -> None:
        from karpenter_tpu_torch.providers.instance.provider import INTENT_TOKEN_ANNOTATION

        claims = []
        intents = []
        for group in groups:
            claim = self._to_nodeclaim(group)
            self.cluster.create(claim)
            # write-ahead intent AFTER the claim exists but BEFORE any
            # cloud call: the durable record a restart replays, its token
            # threaded to the fleet call via the claim annotation
            intent = None
            if self.journal is not None:
                intent = self.journal.begin_launch(claim)
                claim.metadata.annotations[INTENT_TOKEN_ANNOTATION] = intent.token
            claims.append(claim)
            intents.append(intent)
        # cloud calls fan out via the shared protocol (launch_all above);
        # cluster mutations stay on this thread
        outcomes = launch_all(self.cloud_provider, claims, self.MAX_CONCURRENT_LAUNCHES)
        for group, claim, intent, err in zip(groups, claims, intents, outcomes):
            if err is None:
                self.cluster.update(claim)
                if intent is not None:
                    # status committed: the intent has served its purpose
                    self.journal.resolve(intent, "committed")
                metrics.NODECLAIMS_CREATED.inc(nodepool=group.nodepool.name)
                for pod in group.pods:
                    self._assignment_hints[pod.metadata.name] = claim.metadata.name
            else:
                # ICE already recorded by the instance provider; drop the
                # claim so the next tick re-simulates around it
                for pod in group.pods:
                    result.unschedulable[pod.metadata.name] = str(err)
                claim.metadata.finalizers = []
                self.cluster.delete(NodeClaim, claim.metadata.name)
                # the intent stays OPEN: a CloudError does not prove no
                # instance was minted (a post-mint failure inside the
                # launch path, a misdealt merged batch). GC's stale-intent
                # janitor replays it THIS sweep -- no instance found means
                # a cheap "dropped"; a minted-but-unowned one is
                # terminated immediately instead of leaking until grace

    def _to_nodeclaim(self, group: NewNodeGroup) -> NodeClaim:
        pool = group.nodepool
        nodeclass = self.cluster.try_get(TPUNodeClass, pool.template.node_class_ref.name)
        from karpenter_tpu_torch.scheduling import Operator, Requirement

        reqs = group.requirements.copy()
        from karpenter_tpu_torch.scheduling.requirements import truncate_preserving_min_values

        by_price = sorted(group.instance_types, key=lambda i: i.cheapest_price())
        kept = truncate_preserving_min_values(reqs, by_price, MAX_TYPES_PER_CLAIM)
        reqs.add(Requirement(wk.INSTANCE_TYPE_LABEL, Operator.IN, [it.name for it in kept]))
        claim = NodeClaim(
            name=generate_name(f"{pool.name}-"),
            requirements=list(reqs),
            resources_requested=group.requested,
            node_class_ref=pool.template.node_class_ref,
            taints=list(pool.template.taints),
            startup_taints=list(pool.template.startup_taints),
            expire_after=pool.template.expire_after,
        )
        claim.metadata.labels = {
            **pool.template.labels,
            wk.NODEPOOL_LABEL: pool.name,
            wk.LABEL_NODECLASS: pool.template.node_class_ref.name,
        }
        claim.metadata.annotations = {
            **pool.template.annotations,
            wk.NODEPOOL_HASH_ANNOTATION: pool.static_hash(),
            wk.NODEPOOL_HASH_VERSION_ANNOTATION: HASH_VERSION,
        }
        if nodeclass is not None:
            claim.metadata.annotations[HASH_ANNOTATION] = nodeclass.static_hash()
            claim.metadata.annotations[HASH_VERSION_ANNOTATION] = HASH_VERSION
        claim.metadata.finalizers.append(TERMINATION_FINALIZER)
        claim.termination_grace_period = pool.template.termination_grace_period
        return claim


class PodBinder:
    """kube-scheduler stand-in for the kwok cluster: binds pending pods onto
    ready compatible nodes, first fit (the reference relies on the real
    kube-scheduler for this; the kwok rig needs it in-process)."""

    def __init__(self, cluster: Cluster, assignment_hints: Optional[Dict[str, str]] = None):
        self.cluster = cluster
        # shared with the Provisioner (operator wiring): pod name -> node/
        # claim name from the scheduling decision; see Provisioner's
        # _assignment_hints docstring
        self._assignment_hints: Dict[str, str] = (
            assignment_hints if assignment_hints is not None else {}
        )

    def reconcile(self) -> int:
        with tracing.span("bind") as sp:
            bound = self._reconcile()
            sp.set(bound=bound)
            return bound

    def _reconcile(self) -> int:
        from karpenter_tpu_torch import failpoints
        from karpenter_tpu_torch.apis.storage import VolumeIndex
        from karpenter_tpu_torch.scheduling import tolerates_all

        # crash site: the operator dies before binding (claims launched and
        # committed, pods still pending; restart must just bind, not
        # relaunch)
        failpoints.eval("crash.bind")
        bound = 0
        nodes = [n for n in self.cluster.list(Node) if n.ready and not n.unschedulable and not n.deleting]
        # per-(topology key, selector) domain counts, built on first use per
        # reconcile (one cluster scan per distinct constraint) and updated
        # incrementally on each bind -- kube-scheduler's skew bookkeeping
        counts_cache: Dict[tuple, Dict[str, int]] = {}
        node_by_name = {n.metadata.name: n for n in nodes}
        node_index = {n.metadata.name: i for i, n in enumerate(nodes)}
        from karpenter_tpu_torch.solver.spread import soft_zone_tsc

        # built once per reconcile: node_usage consults it for bound pods'
        # attachments in the per-(pod, node) loop below
        vol_index = VolumeIndex.from_cluster(self.cluster)
        # incremental usage accounting (round 5): calling node_usage per
        # (pod, candidate node) try re-summed every bound pod's requests
        # -- quadratic at 50k pods (the full-loop E2E spent >80% of its
        # wall there). ONE snapshot per reconcile, O(1) add per bind.
        usage: Dict[str, Resources] = self.cluster.node_usage_map(
            [n.metadata.name for n in nodes], vol_index)
        # first-fit cursors (the port's own, decisions unchanged): for a
        # pod with no spread, pod (anti-)affinity, preferred terms or
        # volume claims, every check of the scan below is either static
        # (tolerations, node requirements) or only ever turns false within
        # one reconcile (usage grows with each bind). So a node that
        # refused one pod refuses every pod of the same grouping signature
        # for the rest of this reconcile, and the scan for the next such
        # pod starts where the last one stopped. Without it a wave of
        # pods waiting for new nodes rescans every full node per pod.
        cursors: Dict[tuple, int] = {}
        for pod in self.cluster.pending_pods():
            needed = pod.requests + Resources.from_base_units({res.PODS: 1})
            vol_zone = None
            if pod.volume_claims:
                # claims charge the node's attach budget and, once bound,
                # pin the zone (apis/storage); unresolvable claims leave
                # the pod pending for a later tick
                n_vols, vol_zone, blocked = vol_index.lookup(pod)
                if blocked is not None:
                    continue
                needed = needed + Resources.from_base_units(
                    {res.ATTACHABLE_VOLUMES: float(n_vols)}
                )
            tscs = self._matching_spread(pod)
            spread_counts = [
                (tsc, self._counts_for(tsc, nodes, node_by_name, counts_cache))
                for tsc in tscs
            ]
            # preferences are SCORED, not filtered, exactly as
            # kube-scheduler does (PodTopologySpread scoring for
            # ScheduleAnyway, InterPodAffinity scoring for weighted
            # (anti-)affinity): among feasible nodes prefer the one with
            # the highest satisfied preference weight, least-loaded zone
            # as the tie-break (the decision layer already honored these;
            # scoring at bind time keeps the assignment from drifting)
            soft = soft_zone_tsc(pod)
            soft_counts = (
                self._counts_for(soft, nodes, node_by_name, counts_cache)
                if soft is not None else None
            )
            # soft HOSTNAME spread is also scored here (kube-scheduler
            # does); the decision plane cannot express a per-node
            # preference for NEW nodes, so bind time is where it lives
            soft_host = [
                (t, self._counts_for(t, nodes, node_by_name, counts_cache))
                for t in pod.topology_spread
                if not t.hard() and t.topology_key == wk.HOSTNAME_LABEL
                and all(pod.metadata.labels.get(k) == v for k, v in t.label_selector.items())
            ]
            prefs = pod.preferred_affinity_terms
            pref_zone_counts = {
                id(term): self._pref_zone_counts(term, node_by_name, counts_cache)
                for _, term in prefs
                if term.topology_key == wk.ZONE_LABEL
            }
            chosen = None
            chosen_key = None
            # decision-hint fast path: try the node the scheduling decision
            # assigned FIRST (claim names double as kwok node names). Only
            # for pods with no scoring pass -- scored pods must still see
            # every candidate. A hint that fails any check falls through
            # to the full scan below.
            hinted = (
                node_by_name.get(self._assignment_hints.get(pod.metadata.name, ""))
                if soft is None and not prefs and not soft_host else None
            )
            shape = (
                pod.grouping_signature()
                if not (pod.topology_spread or pod.affinity_terms or prefs
                        or pod.volume_claims or soft is not None or soft_host)
                else None
            )
            start = cursors.get(shape, 0) if shape is not None else 0
            scan = nodes if start == 0 else islice(nodes, start, None)
            # chain, not list-concat: copying the full node list per hinted
            # pod would cost O(nodes) allocations at 50k scale
            candidates = scan if hinted is None else chain((hinted,), scan)
            for node in candidates:
                if not tolerates_all(pod.tolerations, node.taints):
                    continue
                if not any(alt.matches_labels(node.metadata.labels) for alt in pod.scheduling_requirements()):
                    continue
                if vol_zone is not None and node.metadata.labels.get(wk.ZONE_LABEL) != vol_zone:
                    continue
                used = usage[node.metadata.name]
                if not (used + needed).fits(node.allocatable):
                    continue
                if not self._anti_affinity_ok(pod, node):
                    continue
                if not self._spread_ok(node, spread_counts):
                    continue
                if soft is None and not prefs and not soft_host:
                    chosen = node
                    break
                if soft is not None:
                    z = node.metadata.labels.get(soft.topology_key)
                    # a node lacking the topology key scores WORST, as in
                    # kube-scheduler's PodTopologySpread (outside every
                    # domain); still eligible when nothing else fits
                    c = soft_counts.get(z, 0) if z is not None else float("inf")
                else:
                    c = 0
                h = sum(
                    counts.get(node.metadata.name, 0) for _, counts in soft_host
                )
                # higher satisfied preference weight wins; fewer same-
                # selector pods in the zone, then on the node, break ties;
                # then first-fit
                key = (-self._preference_score(pod, node, prefs, pref_zone_counts), c, h)
                if chosen is None or key < chosen_key:
                    chosen, chosen_key = node, key
            if shape is not None:
                if chosen is None:
                    cursors[shape] = len(nodes)
                elif chosen is not hinted:
                    # the scan stopped here: the nodes before it refused
                    cursors[shape] = node_index[chosen.metadata.name]
            if chosen is None:
                continue
            self.cluster.bind_pod(pod, chosen)
            usage[chosen.metadata.name] = usage[chosen.metadata.name] + needed
            self._assignment_hints.pop(pod.metadata.name, None)
            if pod.volume_claims:
                # first-consumer binding: the landing zone binds the pod's
                # still-unbound WaitForFirstConsumer claims (the PV
                # controller's job upstream)
                vol_index.bind_on_schedule(
                    pod, chosen.metadata.labels.get(wk.ZONE_LABEL), self.cluster
                )
            # ONE cache update covers every consumer: a bound pod counts
            # toward EVERY cached (topology key / preferred-affinity)
            # selector it matches -- kube-scheduler's bookkeeping counts
            # pods by selector regardless of the bound pod's own
            # constraints, and the per-list updates this replaces went
            # stale exactly when a matching pod WITHOUT the constraint
            # bound mid-reconcile (round-4 review). The spread/soft/pref
            # lists above alias these same cached dicts.
            node_labels = chosen.metadata.labels
            for (kind, sel), counts in counts_cache.items():
                if not all(pod.metadata.labels.get(k) == v for k, v in sel):
                    continue
                dkey = wk.ZONE_LABEL if kind == "prefzone" else kind
                d = (
                    chosen.metadata.name
                    if dkey == wk.HOSTNAME_LABEL and dkey not in node_labels
                    else node_labels.get(dkey)
                )
                if d is not None:
                    counts[d] = counts.get(d, 0) + 1
            bound += 1
        if bound:
            metrics.PODS_BOUND.inc(bound)
        # stale-hint purge: keep only hints for pods that are still
        # pending (bounded by the pending set; a vanished pod's hint
        # would otherwise live forever). IN PLACE: this dict is shared
        # with the Provisioner by reference (operator wiring) -- a
        # reassignment would sever it and silently kill the fast path
        # (round-5 review finding).
        if self._assignment_hints:
            pending = {p.metadata.name for p in self.cluster.pending_pods()}
            for stale in [k for k in self._assignment_hints if k not in pending]:
                del self._assignment_hints[stale]
        metrics.NODES_READY.set(float(len(nodes)))
        return bound

    @staticmethod
    def _matching_spread(pod):
        return [
            t
            for t in pod.topology_spread
            if t.hard()
            and all(pod.metadata.labels.get(k) == v for k, v in t.label_selector.items())
        ]

    def _counts_for(self, tsc, nodes, node_by_name, cache):
        """Per-domain pod counts for one constraint, cached per reconcile
        (domain universe = the ready nodes' domains)."""
        from karpenter_tpu_torch.apis import Pod

        key = (tsc.topology_key, tuple(sorted(tsc.label_selector.items())))
        counts = cache.get(key)
        if counts is not None:
            return counts
        counts = cache[key] = {}
        for n in nodes:
            d = n.metadata.labels.get(tsc.topology_key)
            if d is not None:
                counts.setdefault(d, 0)
        for other in self.cluster.list(Pod):
            if not other.node_name:
                continue
            if not all(other.metadata.labels.get(k) == v for k, v in tsc.label_selector.items()):
                continue
            onode = node_by_name.get(other.node_name) or self.cluster.try_get(Node, other.node_name)
            if onode is None:
                continue
            d = onode.metadata.labels.get(tsc.topology_key)
            if d is not None:
                counts[d] = counts.get(d, 0) + 1
        return counts

    @staticmethod
    def _spread_ok(node, spread_counts) -> bool:
        """Adding the pod to this node's domain must keep skew <= max_skew."""
        for tsc, counts in spread_counts:
            domain = node.metadata.labels.get(tsc.topology_key)
            if domain is None:
                return False
            global_min = min(counts.values(), default=0)
            if counts.get(domain, 0) + 1 - global_min > tsc.max_skew:
                return False
        return True

    def _pref_zone_counts(self, term, node_by_name, cache):
        """Per-zone count of bound pods matching a preferred-affinity
        term's selector: ONE cluster scan per distinct selector per
        reconcile (same pattern as _counts_for; a per-candidate-node scan
        would be O(pods x nodes) -- round-4 review), updated on bind."""
        from karpenter_tpu_torch.apis import Pod as _Pod

        key = ("prefzone", tuple(sorted(term.label_selector.items())))
        counts = cache.get(key)
        if counts is not None:
            return counts
        counts = cache[key] = {}
        for p in self.cluster.list(_Pod):
            if not p.node_name:
                continue
            if not all(p.metadata.labels.get(k) == v for k, v in term.label_selector.items()):
                continue
            pn = node_by_name.get(p.node_name) or self.cluster.try_get(Node, p.node_name)
            if pn is None:
                continue
            z = pn.metadata.labels.get(wk.ZONE_LABEL)
            if z is not None:
                counts[z] = counts.get(z, 0) + 1
        return counts

    def _preference_score(self, pod, node, prefs, zone_counts) -> int:
        """Total weight of the pod's preferred (anti-)affinity terms a bind
        to `node` would satisfy -- kube-scheduler's InterPodAffinity
        scoring over the hostname and zone topology keys. `zone_counts`
        maps id(term) -> the term's per-zone matched-pod counts
        (_pref_zone_counts, cached per reconcile)."""
        if not prefs:
            return 0
        score = 0
        node_zone = node.metadata.labels.get(wk.ZONE_LABEL)
        for w, term in prefs:
            if term.topology_key == wk.HOSTNAME_LABEL:
                matched = any(
                    all(o.metadata.labels.get(k) == v for k, v in term.label_selector.items())
                    for o in self.cluster.pods_on_node(node.metadata.name)
                )
            elif term.topology_key == wk.ZONE_LABEL and node_zone is not None:
                matched = zone_counts[id(term)].get(node_zone, 0) > 0
            else:
                continue
            if matched != term.anti:
                score += w
        return score

    def _anti_affinity_ok(self, pod, node) -> bool:
        on_node = self.cluster.pods_on_node(node.metadata.name)
        for term in pod.affinity_terms:
            if not term.anti or term.topology_key != wk.HOSTNAME_LABEL:
                continue
            for other in on_node:
                if all(other.metadata.labels.get(k) == v for k, v in term.label_selector.items()):
                    return False
        return True
