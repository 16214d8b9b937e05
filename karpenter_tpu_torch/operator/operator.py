"""Operator: the dependency-injection root.

Rebuilds pkg/operator/operator.go:96-212 + options.go:36-56: constructs every
provider with its dedicated caches, wires the CloudProvider and controllers,
and exposes one handle the binary (and every test) builds the world from --
the role pkg/test/environment.go:101-211 plays for the reference's suites.

Copy of karpenter_tpu/operator/operator.py, imports rewritten to the port's.
The decision plane is the port's: `solver=TorchSolver(...)` and
`consolidation_evaluator=ConsolidationEvaluator(solver=...)` (or the
`DisruptEngine` it names), so the provisioner runs kernel A (and kernel B
for its existing-node pass) and the disruption sweep runs kernel B. The
coordination bus is the in-memory kwok store by default, or the port's
`kube.KubeCluster` over a real apiserver (`cluster=`). Cut: the
per-jit-entry dispatch probes (`jitstats.install()`, which wait for the
port's cold-start work).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from karpenter_tpu_torch.cache.ttl import Clock, FakeClock
from karpenter_tpu_torch.cache.unavailable_offerings import UnavailableOfferings
from karpenter_tpu_torch.cloudprovider import CloudProvider
from karpenter_tpu_torch.controllers.disruption import DisruptionController
from karpenter_tpu_torch.controllers.garbagecollection import GarbageCollectionController
from karpenter_tpu_torch.controllers.interruption import InterruptionController
from karpenter_tpu_torch.controllers.nodeclaim_lifecycle import NodeClaimLifecycleController
from karpenter_tpu_torch.controllers.nodeclass import NodeClassController
from karpenter_tpu_torch.batcher.batcher import BatchOptions
from karpenter_tpu_torch.batcher.cloud import CloudBatchers
from karpenter_tpu_torch.controllers.metrics_controller import MetricsController
from karpenter_tpu_torch.controllers.providers import (
    CapacityReservationExpirationController,
    CapacityTypeController,
    DiscoveredCapacityController,
    ImageCacheInvalidationController,
    InstanceTypeRefreshController,
    PricingRefreshController,
    VersionController,
)
from karpenter_tpu_torch.controllers.provisioner import PodBinder, Provisioner
from karpenter_tpu_torch.controllers.repair import NodeRepairController
from karpenter_tpu_torch.controllers.tagging import TaggingController
from karpenter_tpu_torch.controllers.termination import TerminationController
import threading
import time

from karpenter_tpu_torch.apis import NodeClaim, Pod
from karpenter_tpu_torch.events import Recorder
from karpenter_tpu_torch.kwok.cloud import FakeCloud
from karpenter_tpu_torch.kwok.cluster import Cluster
from karpenter_tpu_torch.kwok.lifecycle import NodeLifecycle
from karpenter_tpu_torch.providers.capacityreservation import CapacityReservationProvider
from karpenter_tpu_torch.providers.image import ImageProvider
from karpenter_tpu_torch.providers.instanceprofile import InstanceProfileProvider
from karpenter_tpu_torch.providers.params import ParamStoreProvider
from karpenter_tpu_torch.providers.queue import QueueProvider
from karpenter_tpu_torch.providers.version import VersionProvider
from karpenter_tpu_torch.providers.instance import InstanceProvider
from karpenter_tpu_torch.providers.instancetype import gen_catalog
from karpenter_tpu_torch.providers.instancetype.offerings import OfferingsBuilder
from karpenter_tpu_torch.providers.instancetype.provider import InstanceTypeProvider
from karpenter_tpu_torch.providers.instancetype.types import Resolver
from karpenter_tpu_torch.providers.launchtemplate import LaunchTemplateProvider
from karpenter_tpu_torch.providers.pricing import PricingProvider
from karpenter_tpu_torch.providers.securitygroup import SecurityGroupProvider
from karpenter_tpu_torch.providers.subnet import SubnetProvider


@dataclass
class Options:
    """Injectable flags (reference: pkg/operator/options/options.go:36-56)."""

    cluster_name: str = "kwok-cluster"
    region: str = gen_catalog.REGION
    vm_memory_overhead_percent: float = 0.075
    interruption_queue: str = ""
    reserved_nics: int = 0
    isolated_network: bool = False
    batch_max_duration: float = 1.0
    batch_idle_duration: float = 0.035
    # double-buffered provisioner tick (controllers/provisioner.py): under
    # sustained load the device solve stays in flight across the sweep and
    # the next tick drains it -- the production default; False pins every
    # tick to the synchronous dispatch+barrier path
    pipelined_scheduling: bool = True
    # scheduling-tick tracing (karpenter_tpu_torch/tracing.py): span trees per
    # sweep + the slow-tick flight recorder behind /debug/traces. Default
    # ON with sampling -- the no-op path is one attribute check per span
    # site, and overhead at full sampling measures <2% (bench.py
    # tracing_overhead_pct), so sampled-on is safe as a default.
    tracing: bool = True
    tracing_sample: float = 0.2
    # flight-recorder knobs: retain span trees whose root (one full sweep)
    # ran longer than tracing_slow_ms, up to tracing_capacity trees
    tracing_slow_ms: float = 1000.0
    tracing_capacity: int = 32
    # determinism root (sim subsystem): when set, EVERY RNG on the replay
    # path derives from this one seed -- generated object names (NodeClaim
    # suffixes -> kwok node names), the failpoint registry's per-site
    # schedules, and the trace sampler. The breaker's backoff jitter is
    # seeded by whoever constructs the breaker (__main__/sim.replay pass a
    # seed-derived rng). The kwok lifecycle, batcher, and spread tie-breaks
    # are RNG-free by construction (audited: tests/test_sim.py asserts two
    # replays of one trace produce byte-identical decision logs). None
    # (production default) leaves names on uuid4.
    seed: Optional[int] = None
    # overload control (karpenter_tpu_torch/overload.py). tick_deadline > 0 arms
    # the per-tick deadline budget (decomposed into stage budgets on the
    # trace span boundaries), the brownout ladder (EWMA of tick overrun
    # sheds disruption sweeps, then trace sampling, then delta staging,
    # recovering hysteretically), and the stuck-tick watchdog (a tick
    # wedged past N x deadline escalates cancel -> breaker-open ->
    # OperatorCrashed). 0 (the default) disables all three -- behavior is
    # bit-identical to the pre-overload tree.
    tick_deadline: float = 0.0
    # bounded admission: at most this many pending pods admitted per
    # provisioner tick; over the cap, a deterministic priority/age prefix
    # solves and the rest defer (0 = unbounded). Deterministic -- the sim
    # corpus pins storm digests through it.
    admission_max_pods: int = 0
    # bounded launch fan-out: at most this many decision groups launch
    # per tick; deferred groups' pods stay pending (0 = unbounded)
    launch_max_groups: int = 0
    # device performance observatory (karpenter_tpu_torch/obs/): per-tick HBM
    # accounting, the always-on flight-data ring (/debug/flightdata +
    # the crash-flushed JSONL black box), profiler tick bracketing, and
    # the per-jit-entry cost table. Default ON: the per-tick cost is a
    # record build + a rate-limited memory_stats poll, measured <1% of
    # the warm tick (bench observatory_overhead_pct). False = none of it
    # runs (the pre-observatory tick, bit-identical).
    observatory: bool = True
    # flight-data ring depth: how many ticks the black box retains
    # (postmortems start with these; 256 covers ~4 minutes at the 1s
    # default cadence)
    flight_capacity: int = 256
    feature_gates: dict = field(default_factory=lambda: {"ReservedCapacity": True, "SpotToSpotConsolidation": False})


class Operator:
    def __init__(
        self,
        cloud: Optional[FakeCloud] = None,
        clock: Optional[Clock] = None,
        options: Optional[Options] = None,
        solver=None,
        consolidation_evaluator=None,
        identity: str = "",
        cluster=None,
    ):
        self.clock = clock or Clock()
        self.options = options or Options()
        # the process-global tracer mirrors the metrics registry: one
        # sampled span tree per sweep, slow trees retained by the flight
        # recorder (served at /debug/traces). Tracer config is PROCESS
        # policy, not per-operator state: the last-constructed Operator's
        # Options win (same as the one /metrics registry), and stopping
        # an operator does not restore prior settings -- tests that need
        # specific tracer state configure TRACER explicitly after
        # building their Operator.
        from karpenter_tpu_torch import tracing

        tracing.TRACER.configure(
            enabled=self.options.tracing,
            sample=self.options.tracing_sample,
            slow_ms=self.options.tracing_slow_ms,
            capacity=self.options.tracing_capacity,
        )
        if self.options.seed is not None:
            # seed discipline (Options.seed): one seed fans out to every
            # process-global RNG a replay can observe (karpenter_tpu_torch/
            # seeding.py owns the list). Like the tracer config above,
            # PROCESS policy -- the last seeded Operator wins, which is
            # exactly what sequential replay runs need (each run re-seeds
            # before its first tick).
            from karpenter_tpu_torch import seeding

            seeding.apply(self.options.seed)
        self.cloud = cloud or FakeCloud(clock=self.clock)
        # the decision plane handle, kept for observability wiring: the
        # binary points /healthz + /debug/breaker at
        # solver.breaker.describe when the wire topology is configured
        self.solver = solver
        # overload-control subsystem (karpenter_tpu_torch/overload.py), armed by
        # Options.tick_deadline > 0: the brownout ladder observes every
        # tick's budget overrun, and the watchdog escalates a wedged tick
        # (cancel the wire -> force the breaker open -> OperatorCrashed,
        # handing the restart recovery sweep the cleanup). The watchdog's
        # background thread is the BINARY's concern (__main__ starts it);
        # deterministic rigs drive check_now() themselves.
        from karpenter_tpu_torch import overload

        self.brownout = None
        self.watchdog = None
        if self.options.tick_deadline > 0:
            self.brownout = overload.BrownoutController(self.options.tick_deadline)
            client = getattr(solver, "client", None) if solver is not None else None
            # cancel must be OUT-OF-BAND (cancel_inflight): the wedged
            # tick thread holds the client lock across its blocking read,
            # so a lock-taking close() would block the watchdog itself --
            # a client without cancel_inflight gets NO cancel rung (the
            # breaker-open and crash escalations still fire) rather than
            # one that wedges the watchdog
            cancel = (
                getattr(client, "cancel_inflight", None)
                if client is not None else None
            )
            self.watchdog = overload.StuckTickWatchdog(
                self.options.tick_deadline,
                cancel=cancel,
                breaker=getattr(solver, "breaker", None) if solver is not None else None,
            )
        # process policy, like the tracer config above: the last
        # constructed Operator's brownout (or None) is what module-level
        # consumers -- the solver client's delta shed -- observe
        overload.install_brownout(self.brownout)
        # device performance observatory (karpenter_tpu_torch/obs/): the
        # flight-data ring is process-global like the tracer; the last
        # Operator's capacity wins
        if self.options.observatory:
            from karpenter_tpu_torch.obs import flight

            flight.RECORDER.configure(capacity=self.options.flight_capacity)
        # the coordination bus: the in-memory store by default; pass a
        # karpenter_tpu_torch.kube.KubeCluster to run against a real apiserver
        # (the reference's kwok topology: real bus, emulated cloud)
        self.cluster = cluster if cluster is not None else Cluster(clock=self.clock)

        self.recorder = Recorder(self.clock)

        # crash-consistency layer: the write-ahead intent journal lives on
        # the coordination bus (it must survive THIS process), the fence
        # carries the leadership epoch every cloud mutation is stamped
        # with, and the recovery sweep (constructed after the providers
        # below) replays open intents on every election win
        from karpenter_tpu_torch.fencing import Fence
        from karpenter_tpu_torch.journal import IntentJournal

        self.fence = Fence(self.cluster)
        self.journal = IntentJournal(self.cluster, fence=self.fence)

        # providers, each with its dedicated caches (operator.go:126-186)
        self.unavailable = UnavailableOfferings(self.clock)
        self.pricing = PricingProvider(self.cloud, self.cloud, self.options.region)
        self.subnets = SubnetProvider(self.cloud, self.clock)
        self.security_groups = SecurityGroupProvider(self.cloud, self.clock)
        self.params = ParamStoreProvider(self.cloud, self.clock)
        self.images = ImageProvider(self.cloud, self.params, self.clock)
        self.capacity_reservations = CapacityReservationProvider(self.cloud, self.clock)
        self.instance_profiles = InstanceProfileProvider(
            self.cloud, self.options.cluster_name, self.options.region
        )
        self.queue = QueueProvider(self.cloud)
        self.version = VersionProvider(self.cloud, self.clock)
        zone_ids = {z.name: z.zone_id for z in self.cloud.describe_zones()}
        self.offerings = OfferingsBuilder(
            self.pricing, self.unavailable, zone_ids, self.capacity_reservations
        )
        self.resolver = Resolver(self.options.region, self.options.vm_memory_overhead_percent)
        self.instance_types = InstanceTypeProvider(
            self.cloud, self.resolver, self.offerings, self.unavailable, self.clock
        )
        self.launch_templates = LaunchTemplateProvider(
            self.cloud, self.cloud, self.images, self.security_groups, self.options.cluster_name
        )
        self.batchers = CloudBatchers(
            self.cloud,
            options=BatchOptions(
                idle_seconds=self.options.batch_idle_duration,
                max_seconds=self.options.batch_max_duration,
            ),
            clock=self.clock,
            fence=self.fence,
        )
        self.instances = InstanceProvider(
            self.cloud, self.subnets, self.launch_templates, self.unavailable,
            capacity_reservations=self.capacity_reservations,
            cluster_name=self.options.cluster_name,
            batchers=self.batchers,
            fence=self.fence,
        )
        self.cloud_provider = CloudProvider(self.cluster, self.instance_types, self.instances)

        # controllers (the NewControllers bundle, controllers.go:65-110)
        self.nodeclass_controller = NodeClassController(
            self.cluster, self.cloud, self.cloud, self.subnets, self.security_groups,
            self.images, self.launch_templates, self.clock,
            capacity_reservations=self.capacity_reservations,
            instance_profiles=self.instance_profiles,
        )
        self.provisioner = Provisioner(
            self.cluster, self.cloud_provider, solver=solver, recorder=self.recorder,
            pipeline=self.options.pipelined_scheduling, journal=self.journal,
            admission_max_pods=self.options.admission_max_pods,
            launch_max_groups=self.options.launch_max_groups,
        )
        self.nodeclaim_lifecycle = NodeClaimLifecycleController(
            self.cluster, self.cloud_provider, recorder=self.recorder,
            journal=self.journal,
        )
        self.binder = PodBinder(
            self.cluster, assignment_hints=self.provisioner._assignment_hints
        )
        self.lifecycle = NodeLifecycle(self.cluster, self.cloud)
        self.termination = TerminationController(
            self.cluster, self.cloud_provider, recorder=self.recorder,
            journal=self.journal,
        )
        # convex-tier solvers bring the global repack oracle along: the
        # disruption sweep's stage 6 judges its fleet-wide nominations
        # through the same simulate/price differential as stages 1-5
        repack = None
        if solver is not None and getattr(solver, "tier", "ffd") == "convex":
            from karpenter_tpu_torch.solver.convex.repack import RepackOracle

            repack = RepackOracle()
        self.disruption = DisruptionController(
            self.cluster, self.cloud_provider, self.pricing, self.options.feature_gates,
            evaluator=consolidation_evaluator, recorder=self.recorder,
            brownout=self.brownout, repack=repack,
        )
        # instance-id field index for interruption lookups, registered
        # exactly when the interruption queue is configured (reference
        # gates its status.instanceID indexers the same way,
        # pkg/operator/operator.go:188-191, 284-305)
        if self.options.interruption_queue:
            from karpenter_tpu_torch.utils import nodeclaim_instance_id

            self.cluster.add_field_index(NodeClaim, "status.instanceID", nodeclaim_instance_id)
        self.interruption = InterruptionController(
            self.cluster, self.queue, self.unavailable, self.recorder
        )
        self.garbage_collection = GarbageCollectionController(
            self.cluster, self.cloud_provider, journal=self.journal
        )
        self.repair = NodeRepairController(self.cluster, self.cloud_provider, self.recorder)
        self.tagging = TaggingController(self.cluster, self.cloud_provider)
        self.instance_type_refresh = InstanceTypeRefreshController(self.instance_types, self.clock)
        self.pricing_refresh = PricingRefreshController(self.pricing, self.clock)
        self.discovered_capacity = DiscoveredCapacityController(self.cluster, self.instance_types)
        self.version_controller = VersionController(self.version, self.clock)
        self.image_invalidation = ImageCacheInvalidationController(self.images, self.cloud)
        self.capacity_type_controller = CapacityTypeController(
            self.cluster, self.capacity_reservations
        )
        self.reservation_expiration = CapacityReservationExpirationController(
            self.cluster, self.capacity_reservations
        )
        self.metrics_controller = MetricsController(self.cluster)

        # restart recovery: replay the intent journal's open records back
        # to a safe state -- adopt uncommitted launches, terminate
        # half-launches, resume interrupted terminations
        from karpenter_tpu_torch.controllers.recovery import RecoverySweepController

        self.recovery = RecoverySweepController(
            self.cluster, self.cloud_provider, self.journal, recorder=self.recorder
        )
        # GC's stale-intent janitor shares the recovery replay logic
        # (constructed above after the provider graph GC already holds)
        self.garbage_collection.recovery = self.recovery

        # leader election: a single active replica runs the sweep; cache
        # hydration AND the recovery sweep fire on EVERY election win
        # (reference: controller-runtime election + hydration gated on
        # op.Elected()). Hook order matters: the fence observes the won
        # epoch FIRST (recovery's cloud mutations must carry it), caches
        # hydrate, then recovery replays the journal -- all before the
        # first controller sweep of the new reign.
        from karpenter_tpu_torch.operator.election import LeaderElector

        self.elector = LeaderElector(self.cluster, identity) if identity else None
        if self.elector is not None:
            self.elector.on_elected.append(
                lambda: self.fence.observe(self.elector.won_epoch))
            self.elector.on_elected.append(self.launch_templates.hydrate)
            self.elector.on_elected.append(self.recovery.sweep)
            self._recovery_pending = False
        else:
            # elector-less deployments (tests, the kwok rig's default
            # single replica) still recover: one sweep before the first
            # controller sweep covers the restart-over-shared-state case
            self._recovery_pending = True

    # -- convenience loop for tests/rig -------------------------------------
    def tick(self) -> bool:
        """One controller-manager sweep; True when it actually ran (False
        on a standby replica, so callers like the health heartbeat only
        count REAL sweeps). Order mirrors the reconcile flow:
        status resolution -> events -> provisioning -> node lifecycle ->
        binding -> post-launch bookkeeping -> drain/teardown -> GC."""
        if self.elector is not None and not self.elector.tick():
            return False  # standby replica: watch-only until the lease is won
        if self._recovery_pending:
            # elector-less path: the election-win hook never fires, so the
            # journal replay runs once before the first sweep instead. The
            # fence adopts the bus's CURRENT epoch first -- an elector-less
            # restart over a bus that still carries an election lease
            # (epoch >= 1) would otherwise have every cloud mutation
            # rejected forever. Safe here by construction: without an
            # elector there is no contention window between read and use
            # (a later elector-ful replica bumping the epoch fences this
            # one out exactly as intended).
            self._recovery_pending = False
            self.fence.observe(self.fence.current())
            self.recovery.sweep()
        from karpenter_tpu_torch import overload, tracing

        # tick deadline budget (overload subsystem): built per sweep and
        # threaded thread-locally so deep layers -- the solver client's
        # read-timeout clamp, the provisioner's admission sizing -- shed
        # work EARLY instead of timing out late. None when disabled.
        budget = (
            overload.TickBudget(self.options.tick_deadline)
            if self.options.tick_deadline > 0 else None
        )
        obs_on = self.options.observatory
        if obs_on:
            # profiler tick bracketing (obs/profiler.py): a lock-free
            # int check when nothing is armed; an armed /debug/profile
            # or --profile-ticks request starts its trace here
            from karpenter_tpu_torch.obs import profiler as obs_profiler

            obs_profiler.PROFILER.on_tick_start()
        if self.watchdog is not None:
            self.watchdog.tick_started()
        root_sp = None
        tick_t0 = time.monotonic()
        crashed = False
        try:
            # the sweep is the trace ROOT: every controller's spans (the
            # provisioner's drain/snapshot/dispatch/launch, the binder's
            # bind, the disruption pass, batcher windows, solver + wire
            # stages) nest under one "tick" tree, and the flight recorder
            # judges slowness against the whole sweep
            with overload.active(budget), tracing.trace("tick") as root_sp:
                self.nodeclass_controller.reconcile_all()
                self.instance_type_refresh.reconcile()
                self.pricing_refresh.reconcile()
                self.version_controller.reconcile()
                self.capacity_type_controller.reconcile_all()
                self.reservation_expiration.reconcile_all()
                self.interruption.reconcile()
                self.repair.reconcile()
                self.provisioner.reconcile()
                self.nodeclaim_lifecycle.reconcile_all()
                self.lifecycle.step()
                self.binder.reconcile()
                self.tagging.reconcile_all()
                self.discovered_capacity.reconcile_all()
                self.disruption.reconcile()
                self.termination.reconcile_all()
                self.garbage_collection.reconcile()
                self.metrics_controller.reconcile_all()
        except BaseException as e:
            # OperatorCrashed (a crash failpoint or the watchdog's async
            # raise) is the postmortem trigger: the finally below records
            # this tick and flushes the black box before it propagates
            from karpenter_tpu_torch.failpoints import OperatorCrashed

            crashed = isinstance(e, OperatorCrashed)
            raise
        finally:
            # the watchdog stands down and the brownout ladder sees the
            # tick's overrun even when the sweep died mid-flight (a crash
            # failpoint, the watchdog's own OperatorCrashed escalation)
            if self.watchdog is not None:
                self.watchdog.tick_finished()
            if budget is not None and self.brownout is not None:
                self.brownout.observe(budget.elapsed())
            if obs_on:
                self._observe_tick(root_sp, tick_t0, crashed)
        return True

    def _observe_tick(self, root_sp, t0: float, crashed: bool) -> None:
        """One flight-data record per sweep, EVERY sweep -- brownout rung
        or not (obs/flight.py is the black box; the ticks that caused a
        brownout must stay visible). The record itself is built by
        flight.build_tick_record -- the SAME function bench's
        observatory-overhead measurement drives, so the <1% contract
        bounds exactly this work. A crashed tick records
        ``crashed: true`` and flushes the JSONL black box before the
        exception propagates."""
        from karpenter_tpu_torch.obs import flight
        from karpenter_tpu_torch.obs import profiler as obs_profiler

        obs_profiler.PROFILER.on_tick_end()
        try:
            flight.record(flight.build_tick_record(
                root_sp, t0, solver=self.solver, brownout=self.brownout,
                disruption=self.disruption, crashed=crashed,
            ))
            if crashed:
                flight.flush_blackbox(reason="operator-crashed")
        except Exception:  # noqa: BLE001 -- the observatory must never fail a tick
            from karpenter_tpu_torch import metrics

            metrics.HANDLED_ERRORS.inc(site="operator.observe_tick")

    def describe_overload(self) -> dict:
        """Overload-control state document for /debug/overload: the
        configured bounds plus live brownout/watchdog state."""
        doc: dict = {
            "tick_deadline_s": self.options.tick_deadline,
            "admission_max_pods": self.options.admission_max_pods,
            "launch_max_groups": self.options.launch_max_groups,
            "enabled": self.options.tick_deadline > 0,
        }
        if self.brownout is not None:
            doc["brownout"] = self.brownout.describe()
        if self.watchdog is not None:
            doc["watchdog"] = self.watchdog.describe()
        return doc

    def settle(self, max_ticks: int = 20, step_seconds: float = 3.0) -> int:
        """Tick until no pending pods or budget exhausted; returns ticks."""
        for i in range(max_ticks):
            self.tick()
            if not self.cluster.pending_pods():
                return i + 1
            if isinstance(self.clock, FakeClock):
                self.clock.step(step_seconds)
        return max_ticks

    # -- event-driven tick trigger ------------------------------------------
    def watch_pods(self) -> None:
        """Arm the wall-clock run loop's pod-arrival wake-up: a watch
        handler sets an event on every Pod ADDED, so wait_for_work can cut
        an idle sleep short and batch the burst. Separate from the
        deterministic tick()/settle() test path, which never blocks."""
        if getattr(self, "pod_wake", None) is not None:
            return
        self.pod_wake = threading.Event()

        def _on_event(event: str, obj) -> None:
            if event == "ADDED" and isinstance(obj, Pod):
                self.pod_wake.set()

        self.cluster.on_event(_on_event)

    def wait_for_work(self, tick_interval: float) -> None:
        """Block until the next tick should run: at most tick_interval, but
        a pod arrival wakes the loop early and the batching window (idle /
        max durations from Options, the reference's 35 ms / 1 s request
        batcher shape -- pkg/batcher/batcher.go:84-160) lets the rest of
        the burst accumulate so one solve sees the whole pods x types
        matrix (SURVEY.md section 2.4)."""
        if getattr(self, "pod_wake", None) is None:
            time.sleep(tick_interval)
            return
        if not self.pod_wake.wait(timeout=tick_interval):
            return
        deadline = time.monotonic() + self.options.batch_max_duration
        while time.monotonic() < deadline:
            self.pod_wake.clear()
            if not self.pod_wake.wait(timeout=self.options.batch_idle_duration):
                break
        self.pod_wake.clear()
