"""Replay engine: drive the real operator stack from a trace.

Each replay builds a FRESH production-shaped world -- FakeCloud,
in-memory cluster, the full controller sweep -- under FakeClock, seeded
through `Options(seed=...)` so every run of the same trace is
bit-identical, then applies the trace's events in order. One canonical
decision line is logged per tick (events applied, claims created/removed,
nodes appearing with their realized instance type/zone/capacity-type,
binds/unbinds, pending count); the sha256 of the log is the run's
decision digest, the value the golden corpus pins.

Three backends exercise the three production decision paths:

    host      -- TorchSolver in-process (the breaker's in-process rung),
                 synchronous tick
    wire      -- TorchSolver behind the port's RPC sidecar
                 (`SolverServer`) on a UNIX socket, synchronous tick
    pipelined -- the sidecar plus the double-buffered provisioner tick
                 (the deployed default)

Differential mode replays one trace through all three and asserts
bit-identical final placements (pod -> node/instance-type/zone/capacity),
plus identical decision digests for the two synchronous backends (the
pipelined tick legally shifts decisions one tick later, so its per-tick
log differs; its placements must not).

The chaos invariants hold every tick: bound pods point at live nodes, no
two claims share a provider id, usage fits allocatable; and at the end of
the drain phase: no pod lost, no orphan instance. A violation raises
InvariantViolation -- the shrinker minimizes the trace that caused it.

Copy of karpenter_tpu/sim/replay.py, imports rewritten to the port's.
Every engine the replay builds is the port's: `TorchSolver` and
`DisruptEngine` on `device` (`replay(..., device=)`; None, the default,
is the card -- without CUDA they raise -- and the tests pass "cpu"), and
for the wire backends the port's `SolverServer` on the same device with
the port's `SolverClient` and `CircuitBreaker`. Backends: `host`,
`convex`, `pipelined`, `wire`, `delta` and `tcp` as in the JAX package;
`packed` is the host path, since the port's masks are always bit-packed
(solver/packing.py); `mesh` is the host path with the solve sharded over
8 shards of the replay's device (`make_mesh(8, devices=[device] * 8)`,
the shape of the JAX package's CI mesh), where the trace's
`device_lost`/`device_returned` events reach the engine. A wire engine built with `server_path=` and `tenant=` is one
tenant of a shared coalescing sidecar (sim/fleet.py) instead of starting
its own.
"""
from __future__ import annotations

import hashlib
import json
import math
import os
import tempfile
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from karpenter_tpu_torch.sim.trace import pod_from_spec, validate_event

BACKENDS = ("host", "wire", "pipelined")
# extra named backends accepted by replay()/the CLI (not part of the
# default differential trio):
# - "delta": the wire sidecar with delta class shipping and incremental
#   grouping FORCED on regardless of environment -- the corpus gate
#   replays one scenario through it and fails on any digest divergence
#   from the committed host golden (the delta path's decisions must be
#   bit-identical to a full encode);
# - "tcp": the wire sidecar with the shared-memory ring transport FORCED
#   off (wire backends on a UNIX socket negotiate shm by default since
#   wire v2, so the trio already exercises the ring; this backend pins
#   the socket path, proving shm == tcp == host decision digests);
# - "mesh": TorchSolver in-process with the production solve sharded over
#   8 shards of the replay's device (fleet/shard.py; the JAX package's CI
#   runs 8 virtual devices) -- the corpus gate replays scenarios through
#   it, and mesh-device-loss's device events reshard it;
# - "packed": the host path (the port's open/join masks are always
#   bit-packed, solver/packing.py), kept so the JAX package's backend
#   names all resolve;
# - "convex": TorchSolver in-process with the convex global-solve tier
#   (solver/convex/: LP relaxation + deterministic rounding beside every
#   FFD solve, never-worse differential at the finish barrier) -- the
#   corpus gate replays the binpack-adversarial scenario through it and
#   asserts the convex decisions beat the host golden on fleet $/pod-hour
#   while staying byte-deterministic across replays.
EXTRA_BACKENDS = ("delta", "tcp", "mesh", "packed", "convex")

DEFAULT_TICK_SECONDS = 3.0
MAX_SETTLE_TICKS = 80
DRAIN_TICKS = 10
DRAIN_STEP_SECONDS = 10.0


class InvariantViolation(AssertionError):
    def __init__(self, message: str, tick: int = -1):
        super().__init__(f"tick {tick}: {message}" if tick >= 0 else message)
        self.tick = tick


@dataclass
class DifferentialDivergence:
    kind: str          # "digest" | "placements" | "invariant"
    backends: Tuple[str, str]
    detail: str


@dataclass
class ReplayResult:
    backend: str
    seed: int
    decision_log: List[str]
    placements: Dict[str, dict]      # pod -> {node, instance_type, zone, capacity_type}
    kpis: dict
    ticks: int
    events_applied: int

    @property
    def digest(self) -> str:
        return hashlib.sha256(
            "\n".join(self.decision_log).encode()
        ).hexdigest()


def _percentile(samples: List[float], q: float) -> float:
    """Nearest-rank percentile, the same formula as metrics.Histogram
    .percentile (ceil, not round: round(+0.5) overshoots one rank exactly
    when q*n/100 lands on an integer -- p50 of 2 samples must be s[0])."""
    if not samples:
        return 0.0
    s = sorted(samples)
    idx = min(len(s) - 1, max(0, math.ceil(q / 100.0 * len(s)) - 1))
    return s[idx]


class _Engine:
    def __init__(self, backend: str, seed: int, tmpdir: Optional[str] = None,
                 options_overrides: Optional[dict] = None,
                 device=None, server_path: Optional[str] = None,
                 tenant: Optional[str] = None):
        if backend not in BACKENDS + EXTRA_BACKENDS:
            raise ValueError(
                f"unknown backend {backend!r} (want one of {BACKENDS + EXTRA_BACKENDS})"
            )
        self.backend = backend
        self.seed = seed
        # the engines' device: None = the card (no fallback), "cpu" runs
        # the kernels' plain versions
        self.device = device
        self._tmpdir = tmpdir
        # fleet replay (sim/fleet.py): connect to a SHARED sidecar at
        # `server_path` under this tenant id instead of spawning one --
        # close() then tears down only the client; the shared server's
        # owner stops it
        self._server_path = server_path
        self._tenant = tenant
        # trace-header Options overrides, applied in build() through an
        # explicit WHITELIST (the overload knobs): a trace must not be
        # able to flip arbitrary process policy
        self._overrides = dict(options_overrides or {})
        # failpoint sites armed by `failpoint` events, disarmed at close()
        # so a trace's fault schedule cannot leak into the next replay of
        # a differential run (list, not set: disarm order stays stable)
        self._armed_sites: List[str] = []
        self._own_tmpdir = None
        self._server = None
        self._client = None
        self._breaker = None
        self._global_snapshot = None
        self.op = None
        self._options = None
        # operator incarnation counter: `crash`/`operator_restart` events
        # rebuild the Operator over the surviving world under a NEW
        # identity, so the lease must expire, the fencing epoch bumps, and
        # the recovery sweep runs on the win -- the real restart flow
        self._generation = 0
        self.restarts = 0

    # -- world construction --------------------------------------------------
    def build(self):
        from karpenter_tpu_torch import seeding
        from karpenter_tpu_torch.apis import NodePool, TPUNodeClass
        from karpenter_tpu_torch.cache.ttl import FakeClock
        from karpenter_tpu_torch.operator import Operator, Options
        from karpenter_tpu_torch.solver.breaker import CircuitBreaker
        from karpenter_tpu_torch.solver.service import TorchSolver

        # the Operator's seed fan-out mutates PROCESS-GLOBAL policy (name
        # RNG, failpoint seed, tracer config); snapshot it so close()
        # restores the embedding process -- bench stages and test suites
        # running after a replay must not inherit seeded determinism
        self._global_snapshot = seeding.snapshot()
        options = Options(
            seed=self.seed,
            pipelined_scheduling=(self.backend == "pipelined"),
            interruption_queue="interruption-queue",
            tracing=False,
        )
        for key, val in self._overrides.items():
            # COUNT-based overload knobs only: both shed a pure function
            # of the pod set, so digests stay machine-independent.
            # tick_deadline is deliberately NOT accepted -- its shedding
            # is sized from wall-clock EWMAs (per-pod solve cost, tick
            # overrun), so a trace carrying it would shed a host-speed-
            # dependent prefix and break byte-determinism.
            if key in ("admission_max_pods", "launch_max_groups"):
                setattr(options, key, int(val))
        self._options = options
        breaker_rng = seeding.seeded_rng("breaker", self.seed).random
        from karpenter_tpu_torch.solver.disrupt import DisruptEngine

        if self.backend in ("host", "packed"):
            # "packed": the port's open/join masks are always bit-packed
            # (solver/packing.py), so the packed backend IS the host path
            solver = TorchSolver(g_max=64, device=self.device)
        elif self.backend == "convex":
            # the convex global-solve tier through the whole in-process
            # path (solver/convex/): the FFD rung keeps decisions
            # never-worse, so the corpus gate asserts cost DOMINANCE on
            # the adversarial scenario rather than digest equality
            solver = TorchSolver(g_max=64, tier="convex", device=self.device)
        elif self.backend == "mesh":
            # the sharded production solve over 8 positional shards of the
            # replay's device: in-process like "host", every dispatch
            # through the mesh engine -- digest equality with the host
            # golden IS the sharded == unsharded differential
            from karpenter_tpu_torch.parallel.mesh import make_mesh
            from karpenter_tpu_torch.solver.service import resolve_device

            dev = resolve_device(self.device)
            solver = TorchSolver(g_max=64, mesh=make_mesh(8, devices=[dev] * 8))
        else:
            from karpenter_tpu_torch.solver.rpc import SolverClient, SolverServer

            if self._server_path is not None:
                # fleet replay: the shared coalescing sidecar already
                # listens here; this engine is one tenant of it
                sock = self._server_path
            else:
                if self._tmpdir is None:
                    self._own_tmpdir = tempfile.TemporaryDirectory(prefix="karpenter-sim-")
                    self._tmpdir = self._own_tmpdir.name
                sock = os.path.join(self._tmpdir, f"solver-{self.backend}.sock")
                self._server = SolverServer(path=sock, device=self.device).start()
            # the delta backend forces delta class shipping on (wire and
            # pipelined inherit the environment default, which is also on
            # -- the trio therefore exercises the delta path in CI, and
            # this backend pins it even under KARPENTER_TPU_DELTA=0)
            self._client = SolverClient(
                path=sock, timeout=30.0, connect_timeout=0.5,
                delta=True if self.backend == "delta" else None,
                # "tcp" pins the socket transport; everything else takes
                # the environment default (shm ring on a UNIX socket)
                shm=False if self.backend == "tcp" else None,
                tenant=self._tenant,
            )
            self._breaker = CircuitBreaker(
                failure_threshold=2, backoff_base=1000.0, rng=breaker_rng
            )
            solver = TorchSolver(g_max=64, client=self._client, breaker=self._breaker,
                                 device=self.device)
        # identity-based election: replay runs the REAL leadership flow
        # (lease, fencing epoch, recovery-on-win) so crash/restart events
        # drive crash -> re-elect -> recover through the production stack.
        # The consolidation engine rides the backend: host replays run the
        # in-process kernels, wire/pipelined replays dispatch the
        # solve_disrupt op through the same solver client -- so the
        # corpus's digest equality IS the host == wire == device verdict
        # differential for every consolidation decision in the trace.
        self.op = Operator(
            clock=FakeClock(100_000.0), solver=solver, options=options,
            consolidation_evaluator=DisruptEngine(solver=solver),
            identity=f"replay-{self.backend}-0",
        )
        self.op.cluster.create(TPUNodeClass("default"))
        self.op.cluster.create(NodePool("default"))
        return self.op

    def _restart_operator(self):
        """Abandon the current operator (its in-flight state dies with it)
        and build a fresh incarnation over the SAME cluster/cloud/clock --
        the supervisor-restart a crashed controller pod gets. The solver
        (and for wire backends the sidecar connection) survives: the
        sidecar is a separate process that outlives controller restarts.

        The minted-name and intent-token streams are preserved across the
        rebuild: re-seeding them (Operator re-applies Options.seed) would
        rewind into names already live on the bus -- a real restart's
        fresh uuid4 stream cannot collide, so under a seed the stream must
        continue instead."""
        from karpenter_tpu_torch.apis import objects
        from karpenter_tpu_torch.operator import Operator

        old = self.op
        self._generation += 1
        self.restarts += 1
        name_rng, token_rng = objects._name_rng, objects._token_rng
        self.op = Operator(
            cloud=old.cloud, clock=old.clock, options=self._options,
            solver=old.solver, cluster=old.cluster,
            consolidation_evaluator=old.disruption.evaluator,
            identity=f"replay-{self.backend}-{self._generation}",
        )
        objects._name_rng, objects._token_rng = name_rng, token_rng

    # every crash site a trace may arm (failpoints.py action table); close()
    # disarms them so an armed-but-unfired site cannot leak into the next
    # replay of a differential run (the registry is process-global)
    CRASH_SITES = (
        "crash.provisioner.dispatch", "crash.launch", "crash.bind",
        "crash.termination", "crash.recovery", "crash.disruption.apply",
    )

    def close(self):
        from karpenter_tpu_torch.failpoints import FAILPOINTS

        for site in self.CRASH_SITES:
            FAILPOINTS.disarm(site)
        for site in self._armed_sites:
            FAILPOINTS.disarm(site)
        if self._breaker is not None:
            self._breaker.stop()
        if self._client is not None:
            self._client.close()
        if self._server is not None:
            self._server.stop()
        if self._own_tmpdir is not None:
            self._own_tmpdir.cleanup()
        if self._global_snapshot is not None:
            from karpenter_tpu_torch import seeding

            seeding.restore(self._global_snapshot)
            self._global_snapshot = None

    # -- replay --------------------------------------------------------------
    def run(self, events: List[dict]) -> ReplayResult:
        from karpenter_tpu_torch import metrics
        from karpenter_tpu_torch.apis import Node, NodeClaim, Pod, TPUNodeClass, labels as wk
        from karpenter_tpu_torch.obs import quality as obs_quality
        from karpenter_tpu_torch.utils import parse_instance_id

        op = self.op if self.op is not None else self.build()
        cluster, cloud, clock = op.cluster, op.cloud, op.clock

        tick_seconds = DEFAULT_TICK_SECONDS
        log: List[str] = []
        tick_i = 0
        applied = 0
        pending_events: List[dict] = []

        # KPI accumulators
        created_at: Dict[str, float] = {}
        latencies: List[float] = []
        fleet_cost = 0.0
        pod_hours = 0.0
        churn = 0
        nodes_peak = 0
        # trough shape (the consolidation KPI): the hourly fleet price at
        # its per-tick peak vs at convergence -- a fleet still paying the
        # day's peak through the night shows final ~= peak
        fleet_price_peak = 0.0
        fleet_price_final = 0.0
        deleted_pods: set = set()
        # solution-quality observatory (obs/quality.py): per-tick
        # optimality gaps against the host-side reference bound, plus the
        # final fleet's waste attribution. KPI-only -- the decision log
        # (and therefore every golden digest) never sees any of it.
        gaps: List[float] = []
        gap_final = 0.0

        # per-tick diff state
        prev_pod_node: Dict[str, str] = {}
        prev_claims: set = set()
        prev_nodes: set = set()

        def node_price(node) -> float:
            itype = node.metadata.labels.get(wk.INSTANCE_TYPE_LABEL, "")
            zone = node.metadata.labels.get(wk.ZONE_LABEL, "")
            ct = node.metadata.labels.get(wk.CAPACITY_TYPE_LABEL, "")
            if ct == wk.CAPACITY_TYPE_SPOT:
                p, ok = self.op.pricing.spot_price(itype, zone)
            else:
                p, ok = self.op.pricing.on_demand_price(itype)
            return p if ok else 0.0

        def check_tick_invariants():
            nodes = {n.metadata.name: n for n in cluster.list(Node)}
            for p in cluster.list(Pod):
                if p.node_name and p.node_name not in nodes:
                    raise InvariantViolation(
                        f"pod {p.metadata.name} bound to ghost node {p.node_name}",
                        tick_i,
                    )
            pids = [c.provider_id for c in cluster.list(NodeClaim) if c.provider_id]
            if len(pids) != len(set(pids)):
                raise InvariantViolation("duplicate provider ids (double launch)", tick_i)
            if nodes:
                usage = cluster.node_usage_map(list(nodes))
                for name, node in nodes.items():
                    if not usage[name].fits(node.allocatable):
                        raise InvariantViolation(f"node {name} over-committed", tick_i)

        def replay_catalog():
            """The provider's current catalog list for the reference
            bound, or None (quality is observe-only: never raises)."""
            try:
                ncs = cluster.list(TPUNodeClass)
                return op.instance_types.list(ncs[0]) if ncs else None
            except Exception:  # noqa: BLE001 -- quality must never fail a tick
                metrics.HANDLED_ERRORS.inc(site="sim.quality_catalog")
                return None

        def do_tick(dt: float):
            nonlocal tick_i, fleet_cost, pod_hours, churn, nodes_peak
            nonlocal fleet_price_peak, fleet_price_final, gap_final
            nonlocal prev_pod_node, prev_claims, prev_nodes
            from karpenter_tpu_torch.failpoints import OperatorCrashed

            clock.step(dt)
            crashed = ""
            try:
                self.op.tick()
            except OperatorCrashed as e:
                # the operator died mid-sweep at an armed crash site:
                # abandon it (whatever was in flight stays exactly as the
                # crash left it on the bus/cloud) and bring up the next
                # incarnation -- which must wait out the lease, win with a
                # bumped fencing epoch, and run the recovery sweep
                crashed = str(e)
                self._restart_operator()
            metrics.SIM_TICKS.inc(backend=self.backend)
            # KPI integration over this tick's dt
            nodes = cluster.list(Node)
            fleet_price = sum(node_price(n) for n in nodes)
            fleet_price_peak = max(fleet_price_peak, fleet_price)
            fleet_price_final = fleet_price
            fleet_cost += fleet_price * dt / 3600.0
            bound = [p for p in cluster.list(Pod) if p.node_name]
            pod_hours += len(bound) * dt / 3600.0
            nodes_peak = max(nodes_peak, len(nodes))
            # per-tick optimality gap: realized hourly fleet price over
            # the fractional bound of hosting the currently-bound pods
            # (obs/quality.py fleet_bound -- sound, so gap >= 1 except
            # transiently around a price event before the catalog
            # refreshes, which is why the corpus gate pins upper bounds)
            if bound and fleet_price > 0.0:
                catalog = replay_catalog()
                if catalog:
                    b = obs_quality.fleet_bound(bound, catalog)
                    if b > 0.0:
                        gap_final = fleet_price / b
                        gaps.append(gap_final)
            # decision-log diff
            pod_node = {p.metadata.name: p.node_name for p in cluster.list(Pod)}
            claims = {c.metadata.name for c in cluster.list(NodeClaim)}
            node_names = {n.metadata.name for n in nodes}
            binds = sorted(
                f"{p}->{n}" for p, n in pod_node.items()
                if n and prev_pod_node.get(p, "") != n
            )
            unbinds = sorted(
                p for p, n in prev_pod_node.items()
                if n and not pod_node.get(p, "")
            )
            nodes_add = sorted(
                "{}:{}:{}:{}".format(
                    n.metadata.name,
                    n.metadata.labels.get(wk.INSTANCE_TYPE_LABEL, "?"),
                    n.metadata.labels.get(wk.ZONE_LABEL, "?"),
                    n.metadata.labels.get(wk.CAPACITY_TYPE_LABEL, "?"),
                )
                for n in nodes if n.metadata.name not in prev_nodes
            )
            nodes_gone = sorted(prev_nodes - node_names)
            churn += len(nodes_add) + len(nodes_gone)
            for b in binds:
                pod = b.split("->", 1)[0]
                if pod in created_at:
                    latencies.append(clock.now() - created_at.pop(pod))
            line = {
                "i": tick_i,
                "t": round(clock.now(), 3),
                "events": [
                    {k: v for k, v in ev.items() if k != "node"}
                    for ev in pending_events
                ],
                **({"crashed": crashed} if crashed else {}),
                "claims+": sorted(claims - prev_claims),
                "claims-": sorted(prev_claims - claims),
                "nodes+": nodes_add,
                "nodes-": nodes_gone,
                "binds": binds,
                "unbinds": unbinds,
                "pending": len(cluster.pending_pods()),
            }
            log.append(json.dumps(line, sort_keys=True, separators=(",", ":")))
            pending_events.clear()
            prev_pod_node, prev_claims, prev_nodes = pod_node, claims, node_names
            check_tick_invariants()
            tick_i += 1

        def pick_node(pick: int):
            from karpenter_tpu_torch.sim.trace import ranked_victims

            ranked = ranked_victims(cluster)
            return ranked[pick % len(ranked)] if ranked else None

        def apply(ev: dict):
            nonlocal tick_seconds
            kind = ev["ev"]
            metrics.SIM_EVENTS.inc(ev=kind)
            if kind == "header":
                tick_seconds = float(ev.get("tick_seconds", tick_seconds))
                return
            if kind == "advance":
                do_tick(float(ev["dt"]))
                return
            pending_events.append(ev)
            if kind == "pod_add":
                pod = pod_from_spec(ev["pod"])
                cluster.create(pod)
                created_at[pod.metadata.name] = clock.now()
            elif kind == "pod_delete":
                # only count a delete that hit a live pod: a no-op delete
                # (unknown name, or sorted ahead of its arrival) must not
                # inflate pods_total in the KPIs
                if cluster.try_get(Pod, ev["name"]) is not None:
                    created_at.pop(ev["name"], None)
                    deleted_pods.add(ev["name"])
                    cluster.delete(Pod, ev["name"])
            elif kind == "kill_node":
                node = pick_node(int(ev["pick"]))
                if node is not None:
                    cloud.kill_instance(parse_instance_id(node.provider_id))
            elif kind == "interruption":
                node = pick_node(int(ev["pick"]))
                if node is not None:
                    # envelope triple from the parser registry's own
                    # constants: a drifted literal would degrade to a
                    # no-op message and silently stop killing nodes
                    from karpenter_tpu_torch.controllers.interruption_messages import (
                        DETAIL_SPOT_INTERRUPTION, SOURCE_COMPUTE,
                    )

                    iid = parse_instance_id(node.provider_id)
                    cloud.send(json.dumps({
                        "version": "0", "source": SOURCE_COMPUTE,
                        "detail-type": DETAIL_SPOT_INTERRUPTION,
                        "id": f"evt-{iid}", "region": "us-central-1",
                        "detail": {"instance-id": iid, "instance-action": "terminate"},
                    }))
            elif kind == "ice":
                cloud.set_capacity(
                    ev["instance_type"], ev["zone"], ev["capacity_type"],
                    int(ev["count"]),
                )
            elif kind == "price":
                cloud.set_price_factor(ev["instance_type"], float(ev["factor"]))
                self.op.pricing.update_on_demand_pricing()
                self.op.pricing.update_spot_pricing()
            elif kind == "crash":
                # arm a one-shot crash at the named production site; the
                # tick that reaches it dies there (do_tick restarts)
                from karpenter_tpu_torch.failpoints import FAILPOINTS

                FAILPOINTS.arm(ev["site"], "crash", times=1)
            elif kind == "failpoint":
                # arm a fault schedule mid-trace (the overload family's
                # slow-sidecar windows). Wall-clock-only faults never
                # touch decisions, so digests stay backend-identical;
                # close() disarms every site named here.
                from karpenter_tpu_torch.failpoints import FAILPOINTS

                FAILPOINTS.arm_spec(ev["spec"])
                for pair in filter(None, (p.strip() for p in ev["spec"].split(";"))):
                    site = pair.partition("=")[0].strip()
                    if site and site not in self._armed_sites:
                        self._armed_sites.append(site)
            elif kind == "operator_restart":
                # clean restart between ticks (kill -9 while idle)
                self._restart_operator()
            elif kind in ("device_lost", "device_returned"):
                # mesh fault tolerance: a device leaves/rejoins the
                # solver's device mesh. Only the `mesh` backend carries
                # an engine; every other backend takes the event as a
                # decision-log entry alone -- which is exactly the
                # differential contract: decisions (and so digests) must
                # be bit-identical whether the solve resharded or never
                # had a mesh at all.
                engine = getattr(self.op.solver, "mesh_engine", None)
                if engine is not None:
                    if kind == "device_lost":
                        engine.mark_device_lost(int(ev["device"]), reason="sim")
                    else:
                        engine.mark_device_returned(int(ev["device"]))

        for ev in events:
            apply(validate_event(ev))
            applied += 1

        # settle: tick until the fleet converges (no pending pods, nothing
        # mid-pipeline) or the budget is blown -- non-convergence IS the
        # invariant violation the shrinker minimizes
        for _ in range(MAX_SETTLE_TICKS):
            if not cluster.pending_pods() and self.op.provisioner._inflight is None:
                break
            do_tick(tick_seconds)
        else:
            raise InvariantViolation(
                f"no convergence after {MAX_SETTLE_TICKS} settle ticks "
                f"({len(cluster.pending_pods())} pods pending)", tick_i,
            )
        # placements are captured AT CONVERGENCE: this is the scheduler's
        # decision surface, the thing the differential contract pins
        # bit-identical across backends. The drain below intentionally
        # keeps consolidating the now-quiet fleet, and those decisions
        # depend on node AGE -- which legally trails one tick on the
        # pipelined backend -- so drain-phase churn is checked against the
        # invariants (no pod lost / no orphan), not against other backends.
        placements = self._placements()
        # drain: long ticks so termination/GC complete. Disruption may
        # legally evict pods DURING the drain (consolidating the fleet the
        # scenario built), so re-settle before the end-state invariants
        # (the chaos contract's "no pod lost / no orphan") -- a pod is
        # only lost if it stays unbound once the fleet goes quiet.
        for _ in range(DRAIN_TICKS):
            do_tick(DRAIN_STEP_SECONDS)
        for _ in range(MAX_SETTLE_TICKS):
            if not cluster.pending_pods() and self.op.provisioner._inflight is None:
                break
            do_tick(tick_seconds)
        else:
            raise InvariantViolation(
                f"no re-convergence after drain ({len(cluster.pending_pods())} "
                "pods pending)", tick_i,
            )
        for p in cluster.list(Pod):
            if not p.node_name:
                raise InvariantViolation(
                    f"pod {p.metadata.name} lost (never bound)", tick_i)
        claimed = {c.provider_id for c in cluster.list(NodeClaim) if c.provider_id}
        for inst in cloud.describe_instances():
            if inst.state == "running" and inst.provider_id not in claimed:
                raise InvariantViolation(f"orphan instance {inst.id}", tick_i)

        # final-fleet waste attribution (obs/quality.py): stranded
        # capacity + fragmentation of the converged fleet, from the same
        # usage map shape the invariant check builds
        final_nodes = cluster.list(Node)
        waste = obs_quality.fleet_waste(
            final_nodes,
            cluster.node_usage_map([n.metadata.name for n in final_nodes]),
        )
        n_final = len(cluster.list(Pod))
        kpis = {
            "cost_per_pod_hour": round(fleet_cost / pod_hours, 6) if pod_hours else 0.0,
            "fleet_cost_total": round(fleet_cost, 6),
            "pod_hours": round(pod_hours, 4),
            "pending_latency_p50_s": round(_percentile(latencies, 50), 3),
            "pending_latency_p99_s": round(_percentile(latencies, 99), 3),
            "node_churn": churn,
            "nodes_peak": nodes_peak,
            "fleet_price_peak_per_h": round(fleet_price_peak, 6),
            "fleet_price_final_per_h": round(fleet_price_final, 6),
            "pods_total": n_final + len(deleted_pods),
            "pods_bound_final": n_final,
            "sim_seconds": round(clock.now() - 100_000.0, 3),
            # solution-quality KPIs (observe-only; gated by
            # tests/golden/scenarios/quality.json in `make sim-corpus`)
            "optimality_gap_p50": round(_percentile(gaps, 50), 6),
            "optimality_gap_final": round(gap_final, 6),
            "stranded_cpu_fraction": waste["stranded_cpu_fraction"],
            "stranded_memory_fraction": waste["stranded_memory_fraction"],
            "fragmentation_index": waste["fragmentation_index"],
        }
        return ReplayResult(
            backend=self.backend, seed=self.seed, decision_log=log,
            placements=placements, kpis=kpis, ticks=tick_i,
            events_applied=applied,
        )

    def _placements(self) -> Dict[str, dict]:
        from karpenter_tpu_torch.apis import Pod, labels as wk

        return {
            p.metadata.name: {
                "node": p.node_name,
                "instance_type": self._node_label(p.node_name, wk.INSTANCE_TYPE_LABEL),
                "zone": self._node_label(p.node_name, wk.ZONE_LABEL),
                "capacity_type": self._node_label(p.node_name, wk.CAPACITY_TYPE_LABEL),
            }
            for p in self.op.cluster.list(Pod)
        }

    def _node_label(self, node_name: str, label: str) -> str:
        from karpenter_tpu_torch.apis import Node

        node = self.op.cluster.try_get(Node, node_name)
        return node.metadata.labels.get(label, "?") if node is not None else "?"


def _header_options(events: List[dict]) -> Optional[dict]:
    """The trace header's Options overrides, if any (sim/trace.py)."""
    for ev in events:
        if ev.get("ev") == "header":
            opts = ev.get("options")
            return opts if isinstance(opts, dict) else None
    return None


def replay(events: List[dict], backend: str = "host", seed: int = 0,
           tmpdir: Optional[str] = None, device=None) -> ReplayResult:
    """Replay `events` on one backend; raises InvariantViolation when the
    chaos contract breaks. Builds and tears down a fresh world; its
    engines run on `device` (None: the card)."""
    engine = _Engine(backend, seed, tmpdir,
                     options_overrides=_header_options(events), device=device)
    try:
        engine.build()
        return engine.run(events)
    finally:
        engine.close()


@dataclass
class DifferentialResult:
    results: Dict[str, ReplayResult] = field(default_factory=dict)
    divergences: List[DifferentialDivergence] = field(default_factory=list)
    errors: Dict[str, str] = field(default_factory=dict)

    @property
    def ok(self) -> bool:
        return not self.divergences and not self.errors


def differential(events: List[dict], seed: int = 0,
                 backends: Tuple[str, ...] = BACKENDS,
                 tmpdir: Optional[str] = None, device=None) -> DifferentialResult:
    """Replay one trace through every backend and compare:

    - final placements must be bit-identical everywhere (the decision
      contract: host FFD fallback, the wire sidecar, and the pipelined
      tick are three routes to ONE decision function);
    - decision digests must match between the synchronous backends (the
      pipelined tick may shift decisions a tick later, so only its
      placements are compared).

    An InvariantViolation inside any backend is reported as a divergence
    of kind "invariant" rather than raised, so the caller (and the
    shrinker) sees the whole comparison.
    """
    from karpenter_tpu_torch import metrics

    out = DifferentialResult()
    for b in backends:
        try:
            out.results[b] = replay(events, backend=b, seed=seed, tmpdir=tmpdir,
                                    device=device)
        except InvariantViolation as e:
            out.errors[b] = str(e)
            out.divergences.append(
                DifferentialDivergence("invariant", (b, b), str(e)))
            metrics.SIM_DIVERGENCES.inc(kind="invariant")
    done = [b for b in backends if b in out.results]
    sync_done = [b for b in done if b != "pipelined"]
    for a, b in zip(sync_done, sync_done[1:]):
        ra, rb = out.results[a], out.results[b]
        if ra.digest != rb.digest:
            detail = _first_log_diff(ra.decision_log, rb.decision_log)
            out.divergences.append(DifferentialDivergence("digest", (a, b), detail))
            metrics.SIM_DIVERGENCES.inc(kind="digest")
    for a, b in zip(done, done[1:]):
        ra, rb = out.results[a], out.results[b]
        if ra.placements != rb.placements:
            detail = _first_placement_diff(ra.placements, rb.placements)
            out.divergences.append(
                DifferentialDivergence("placements", (a, b), detail))
            metrics.SIM_DIVERGENCES.inc(kind="placements")
    return out


def _first_log_diff(a: List[str], b: List[str]) -> str:
    for i, (la, lb) in enumerate(zip(a, b)):
        if la != lb:
            return f"line {i}: {la} != {lb}"
    return f"log lengths differ: {len(a)} vs {len(b)}"


def _first_placement_diff(a: Dict[str, dict], b: Dict[str, dict]) -> str:
    for pod in sorted(set(a) | set(b)):
        if a.get(pod) != b.get(pod):
            return f"pod {pod}: {a.get(pod)} != {b.get(pod)}"
    return "placements differ"
