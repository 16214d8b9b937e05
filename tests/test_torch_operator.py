"""The port's Operator against the JAX package's, tick by tick, on the CPU.

The JAX `Operator` with `TPUSolver` and its `DisruptEngine`, and the
port's `Operator` with `TorchSolver(device="cpu")` and its
`DisruptEngine` (kernel A's and kernel B's plain versions), each tick the
same seeded FakeClock world, built in each package from one script. After
every tick the two must agree exactly, by name: the NodeClaims (nodepool,
instance type, zone, capacity type, deleting), the nodes, the pod -> node
bindings and the recorder's events (kind, name, type, reason, message).
After the world the shared registry families must have moved alike:
every counter's and every histogram's sample count by label (the kernel
dispatch family summed over its implementation label, which names
pallas/xla in one package and cuda/plain in the other), and the fleet
gauges the metrics controller sets every tick; not the cloud batcher's
two families, whose batch counts follow the launch threads' wall-clock
timing in either package. The per-entry dispatch counter (obs/jitstats,
installed by both Operators) compares on the entries both packages
register, by module path below the package; its seconds, compile and
compile-cache families are host timing and each runtime's own build
work, and stay out. Decisions are exact: no tolerance anywhere.

Worlds: tests/test_e2e_provisioning.py's (bin packing, fan-out, pool
requirements, a zonal selector, taints, a GPU pod, zone spread, preferred
anti-affinity, an ICE'd zone, pool limits; waves of pods waiting for new
nodes while the old ones are full) and tests/test_disruption.py's
(an emptied node, underutilized nodes, do-not-disrupt, expiry, drift),
a ramp-down that the consolidation engine judges, a pipelined world
(the double-buffered provisioner tick) and a convex world (the convex
tier, whose disruption sweep brings the repack oracle along).
"""
import types

import jax  # noqa: F401  -- both frameworks in one process; data crosses as plain specs
import pytest
import torch

import karpenter_tpu.apis as japis
import karpenter_tpu.scheduling as jsched
import karpenter_tpu_torch.apis as tapis
import karpenter_tpu_torch.scheduling as tsched
from karpenter_tpu import metrics as jmetrics
from karpenter_tpu import seeding as jseeding
from karpenter_tpu.apis import labels as jlabels
from karpenter_tpu.cache.ttl import FakeClock as JClock
from karpenter_tpu.controllers.disruption import MIN_NODE_LIFETIME
from karpenter_tpu.operator import Operator as JOperator
from karpenter_tpu.operator import Options as JOptions
from karpenter_tpu.solver.disrupt import DisruptEngine as JEngine
from karpenter_tpu.solver.service import TPUSolver
from karpenter_tpu_torch import metrics as tmetrics
from karpenter_tpu_torch import seeding as tseeding
from karpenter_tpu_torch.apis import labels as tlabels
from karpenter_tpu_torch.cache.ttl import FakeClock as TClock
from karpenter_tpu_torch.operator import Operator as TOperator
from karpenter_tpu_torch.operator import Options as TOptions
from karpenter_tpu_torch.solver.disrupt import DisruptEngine as TEngine
from karpenter_tpu_torch.solver.service import TorchSolver

# small tensors: one intra-op thread per test worker (several workers share the cores)
torch.set_num_threads(1)

G = 64
SEED = 11
STEP = 3.0


def _pkg(apis, sched, metrics, seeding, wk, clock, operator, options, solver, engine):
    return types.SimpleNamespace(
        apis=apis, sched=sched, metrics=metrics, seeding=seeding, wk=wk, Clock=clock,
        Operator=operator, Options=options, solver=solver, engine=engine)


PKG = {
    "jax": _pkg(japis, jsched, jmetrics, jseeding, jlabels, JClock, JOperator, JOptions,
                lambda tier: TPUSolver(g_max=G, tier=tier), lambda s: JEngine(solver=s)),
    "torch": _pkg(tapis, tsched, tmetrics, tseeding, tlabels, TClock, TOperator, TOptions,
                  lambda tier: TorchSolver(device="cpu", g_max=G, tier=tier),
                  lambda s: TEngine(solver=s)),
}


# -- one tick's state, by name ----------------------------------------------------------


def snapshot(k, op):
    wk = k.wk

    def labels(obj):
        m = obj.metadata.labels
        return (m.get(wk.NODEPOOL_LABEL, ""), m.get(wk.INSTANCE_TYPE_LABEL, ""),
                m.get(wk.ZONE_LABEL, ""), m.get(wk.CAPACITY_TYPE_LABEL, ""))

    return {
        "claims": sorted((c.metadata.name, *labels(c), c.deleting)
                         for c in op.cluster.list(k.apis.NodeClaim)),
        "nodes": sorted((n.metadata.name, *labels(n)) for n in op.cluster.list(k.apis.Node)),
        "bindings": sorted((p.metadata.name, p.node_name or "") for p in op.cluster.list(k.apis.Pod)),
        "events": [(e.kind, e.name, e.type, e.reason, e.message) for e in op.recorder.events],
    }


# -- the registry families both packages have -------------------------------------------

# gauges the metrics controller and the journal set on every tick
FLEET_GAUGES = ("karpenter_nodes_ready_count", "karpenter_journal_open_intents",
                "karpenter_ignored_pod_count")
DISPATCHES = "karpenter_solver_kernel_dispatches_total"
# how many batches the cloud batcher cut depends on how the launch
# fan-out's threads met its wall-clock window, in either package
TIMING = ("karpenter_cloud_batcher_batch_size", "karpenter_cloud_batcher_batch_time_seconds")
# the per-entry table: dispatch counts compare per shared entry; the rest is
# host timing or the runtime's own compiles (jit traces / library loads)
JIT_DISPATCHES = "karpenter_jit_entry_dispatches_total"
JIT_COST = ("karpenter_jit_entry_dispatch_seconds_total", "karpenter_jit_entry_compiles_total",
            "karpenter_jit_entry_compile_seconds_total",
            "karpenter_jit_entry_aot_compiles_total",
            "karpenter_jit_entry_aot_compile_seconds_total",
            "karpenter_compile_cache_hits_total", "karpenter_compile_cache_misses_total",
            "karpenter_compile_cache_bytes")


def _shared_entries():
    from karpenter_tpu.analysis.checkers.jax_discipline import JIT_ENTRY_FUNCTIONS as jentries
    from karpenter_tpu_torch.obs.jitstats import JIT_ENTRY_FUNCTIONS as tentries

    def names(reg, pkg):
        return {f"{mod[len(pkg) + 1:]}.{fn}" for mod, fns in reg.items() for fn in fns}

    # the JAX ffd_solve_fused calls ffd_solve_compact inside its trace, so
    # the JAX probe counts that entry once per trace, not per dispatch
    return (names(jentries, "karpenter_tpu") & names(tentries, "karpenter_tpu_torch")) - {
        "solver.ffd.ffd_solve_compact"}


SHARED_ENTRIES = _shared_entries()


def samples(metrics):
    out = {}
    for name, m in list(metrics.REGISTRY._metrics.items()):
        if name in TIMING or name in JIT_COST:
            continue
        if isinstance(m, metrics.Counter):
            vals = dict(m._values)
            if name == JIT_DISPATCHES:
                # the entry's module path below its package
                vals = {(entry.split(".", 1)[1],): v for (entry,), v in vals.items()
                        if entry.split(".", 1)[1] in SHARED_ENTRIES}
            if name == DISPATCHES:
                # entry x impl: impl is pallas|xla in the JAX package and
                # cuda|plain in the port -- compare per entry
                summed = {}
                for (entry, _impl), v in vals.items():
                    summed[(entry,)] = summed.get((entry,), 0.0) + v
                vals = summed
            out[name] = vals
        elif isinstance(m, metrics.Histogram):
            out[name] = dict(m._totals)
        elif name in FLEET_GAUGES:
            out[name] = dict(m._values)
    return out


def moved(before, after):
    """Counter and histogram moves during the world, nonzero ones only;
    the fleet gauges as they stand after it."""
    out = {}
    for name, vals in after.items():
        if name in FLEET_GAUGES:
            out[name] = vals
            continue
        prev = before.get(name, {})
        delta = {key: v - prev.get(key, 0) for key, v in vals.items() if v != prev.get(key, 0)}
        if delta:
            out[name] = delta
    return out


# -- the driver --------------------------------------------------------------------------


def run(which, world, pipelined=False, tier="ffd"):
    """Tick `world` in one package; returns (per-tick snapshots, registry
    moves). The seeded streams the Operator fans out are restored after."""
    k = PKG[which]
    saved = k.seeding.snapshot()
    before = samples(k.metrics)
    solver = k.solver(tier)
    op = k.Operator(
        clock=k.Clock(100_000.0), solver=solver, consolidation_evaluator=k.engine(solver),
        options=k.Options(seed=SEED, pipelined_scheduling=pipelined, tracing=False,
                          interruption_queue="interruption-queue"),
    )
    ticks = []
    try:
        op.cluster.create(k.apis.TPUNodeClass("default"))
        op.cluster.create(k.apis.NodePool("default"))
        for n_ticks in world(k, op):
            for _ in range(n_ticks):
                op.clock.step(STEP)
                op.tick()
                ticks.append(snapshot(k, op))
    finally:
        k.seeding.restore(saved)
    return ticks, moved(before, samples(k.metrics))


def assert_same(world, **kw):
    want_ticks, want_reg = run("jax", world, **kw)
    got_ticks, got_reg = run("torch", world, **kw)
    # the families both registries hold (lazy imports register some)
    shared = set(tmetrics.REGISTRY._metrics) & set(jmetrics.REGISTRY._metrics)
    want_reg = {n: v for n, v in want_reg.items() if n in shared}
    got_reg = {n: v for n, v in got_reg.items() if n in shared}
    assert len(got_ticks) == len(want_ticks)
    for i, (got, want) in enumerate(zip(got_ticks, want_ticks)):
        for key in want:
            assert got[key] == want[key], f"tick {i}: {key} differ"
    assert got_reg == want_reg
    return got_ticks, got_reg


# -- worlds ------------------------------------------------------------------------------


def pods(k, n, cpu="500m", memory="1Gi", prefix="pod", **kw):
    return [k.apis.Pod(f"{prefix}-{i}", requests=k.sched.Resources({"cpu": cpu, "memory": memory}),
                       **kw) for i in range(n)]


def create(op, objs):
    for o in objs:
        op.cluster.create(o)


def update_pool(k, op, fn):
    pool = op.cluster.get(k.apis.NodePool, "default")
    fn(pool)
    op.cluster.update(pool)


def w_binpack(k, op):
    create(op, pods(k, 20, cpu="100m", memory="128Mi"))
    yield 6


def w_fanout(k, op):
    create(op, pods(k, 4, cpu="3", memory="12Gi"))
    yield 6


def w_pool_requirements(k, op):
    s = k.sched

    def fn(pool):
        pool.template.requirements = [
            s.Requirement(k.wk.ARCH_LABEL, s.Operator.IN, ["arm64"]),
            s.Requirement(k.wk.CAPACITY_TYPE_LABEL, s.Operator.IN, ["on-demand"]),
        ]
    update_pool(k, op, fn)
    create(op, pods(k, 3))
    yield 5


def w_zonal_and_taints(k, op):
    update_pool(k, op, lambda pool: setattr(
        pool.template, "taints", [k.sched.Taint("dedicated", value="team-a")]))
    zone = op.cloud.describe_zones()[1].name
    tol = [k.sched.Toleration(key="dedicated", value="team-a")]
    create(op, [
        k.apis.Pod("zonal", requests=k.sched.Resources({"cpu": "1"}),
                   node_selector={k.wk.ZONE_LABEL: zone}, tolerations=tol),
        k.apis.Pod("tolerant", requests=k.sched.Resources({"cpu": "1"}), tolerations=tol),
        pods(k, 1, prefix="intolerant")[0],
    ])
    yield 6


def w_gpu(k, op):
    want = {"cpu": "2", "memory": "4Gi", k.sched.resources.GPU: 1}
    create(op, [k.apis.Pod("gpu", requests=k.sched.Resources(want),
                           tolerations=[k.sched.Toleration(operator="Exists")]),
                pods(k, 1, prefix="plain")[0]])
    yield 5


def w_zone_spread(k, op):
    tsc = k.apis.TopologySpreadConstraint(max_skew=1, topology_key=k.wk.ZONE_LABEL,
                                          label_selector={"app": "web"})
    create(op, [k.apis.Pod(f"web-{i}", requests=k.sched.Resources({"cpu": "3"}),
                           labels={"app": "web"}, topology_spread=[tsc]) for i in range(6)])
    yield 6


def w_anti_affinity(k, op):
    anchor = k.apis.Pod("anchor", requests=k.sched.Resources({"cpu": "500m", "memory": "1Gi"}),
                        labels={"app": "spready"},
                        node_selector={k.wk.ZONE_LABEL: "us-central-1a"})
    repelled = k.apis.Pod(
        "repelled", requests=k.sched.Resources({"cpu": "250m", "memory": "512Mi"}),
        labels={"app": "spready"},
        preferred_affinity_terms=[(10, k.apis.PodAffinityTerm(
            label_selector={"app": "spready"}, topology_key=k.wk.ZONE_LABEL, anti=True))])
    create(op, [anchor, repelled])
    yield 6


def w_ice(k, op):
    dead = op.cloud.describe_zones()[0].name
    for t in op.cloud.describe_instance_types():
        op.cloud.set_capacity(t.name, dead, "spot", 0)
        op.cloud.set_capacity(t.name, dead, "on-demand", 0)
    create(op, pods(k, 3))
    yield 8


def w_limits(k, op):
    update_pool(k, op, lambda pool: setattr(pool, "limits", k.sched.Resources({"cpu": "2"})))
    create(op, pods(k, 8, cpu="1500m", memory="1Gi"))
    yield 5


def w_empty_node(k, op):
    create(op, pods(k, 1, cpu="1", memory="1Gi"))
    yield 5
    op.cluster.delete(k.apis.Pod, "pod-0")
    op.clock.step(MIN_NODE_LIFETIME + 60)
    yield 10


def w_underutilized(k, op):
    create(op, pods(k, 1, cpu="1500m", memory="2Gi", prefix="a"))
    yield 5
    create(op, pods(k, 1, cpu="1500m", memory="2Gi", prefix="b"))
    yield 5
    op.clock.step(MIN_NODE_LIFETIME + 60)
    yield 10


def w_do_not_disrupt_and_when_empty(k, op):
    update_pool(k, op, lambda pool: setattr(
        pool.disruption, "consolidation_policy", k.apis.CONSOLIDATION_WHEN_EMPTY))
    create(op, pods(k, 2, cpu="200m", prefix="p"))
    create(op, [k.apis.Pod("protected", requests=k.sched.Resources({"cpu": "200m"}),
                           annotations={"karpenter.sh/do-not-disrupt": "true"})])
    yield 5
    op.clock.step(MIN_NODE_LIFETIME + 60)
    yield 6


def w_expired(k, op):
    update_pool(k, op, lambda pool: setattr(pool.template, "expire_after", 600.0))
    create(op, pods(k, 3, cpu="1"))
    yield 5
    op.clock.step(700.0)
    yield 12


def w_drift(k, op):
    create(op, pods(k, 4, cpu="1"))
    yield 5
    nc = op.cluster.get(k.apis.TPUNodeClass, "default")
    nc.tags = {**nc.tags, "team": "b"}
    op.cluster.update(nc)
    op.clock.step(MIN_NODE_LIFETIME + 60)
    yield 12


def w_rampdown(k, op):
    """A fleet of mixed pods, then 3 of every 4 deleted: the disruption
    sweep judges its candidate sets through the consolidation engine."""
    sizes = [("250m", "512Mi"), ("500m", "1Gi"), ("1", "2Gi"), ("2", "4Gi")]
    create(op, [k.apis.Pod(f"r-{i}", requests=k.sched.Resources(
        {"cpu": sizes[i % 4][0], "memory": sizes[i % 4][1]})) for i in range(40)])
    yield 3
    create(op, [k.apis.Pod(f"s-{i}", requests=k.sched.Resources(
        {"cpu": sizes[(i + 1) % 4][0], "memory": sizes[(i + 1) % 4][1]})) for i in range(40)])
    yield 4
    for i in range(40):
        for prefix in ("r", "s"):
            if i % 4:
                op.cluster.delete(k.apis.Pod, f"{prefix}-{i}")
    op.clock.step(MIN_NODE_LIFETIME + 60)
    yield 14


def w_waves(k, op):
    for wave in range(3):
        create(op, pods(k, 12, cpu=("250m", "1", "2")[wave], memory="1Gi", prefix=f"w{wave}"))
        yield 3
    yield 4


def w_convex(k, op):
    """binpack-adversarial's shape: a few large pods among many small ones,
    then a ramp-down for the repack oracle (stage 6) to judge."""
    create(op, pods(k, 6, cpu="3", memory="6Gi", prefix="big")
           + pods(k, 30, cpu="300m", memory="700Mi", prefix="small"))
    yield 5
    for i in range(30):
        if i % 3:
            op.cluster.delete(k.apis.Pod, f"small-{i}")
    for i in range(0, 6, 2):
        op.cluster.delete(k.apis.Pod, f"big-{i}")
    op.clock.step(MIN_NODE_LIFETIME + 60)
    yield 10


E2E = {"binpack": w_binpack, "fanout": w_fanout, "pool-requirements": w_pool_requirements,
       "zonal-and-taints": w_zonal_and_taints, "gpu": w_gpu, "zone-spread": w_zone_spread,
       "anti-affinity": w_anti_affinity, "ice": w_ice, "limits": w_limits,
       # waves of pods that wait for new nodes while the old ones are full:
       # the binder's first-fit scan over full nodes
       "waves": w_waves}
DISRUPTION = {"empty-node": w_empty_node, "underutilized": w_underutilized,
              "do-not-disrupt-and-when-empty": w_do_not_disrupt_and_when_empty,
              "expired": w_expired, "drift": w_drift, "rampdown": w_rampdown}


def placed(ticks):
    return sum(1 for _, node in ticks[-1]["bindings"] if node)


@pytest.mark.parametrize("name", sorted(E2E))
def test_provisioning_world(name):
    ticks, reg = assert_same(E2E[name])
    if name != "limits":  # a 2-cpu limit leaves every 1.5-cpu pod pending
        assert placed(ticks) > 0 and ticks[-1]["claims"]
    if name in ("binpack", "fanout", "pool-requirements", "ice", "waves"):
        # the device route decided: the port's scan ran (its plain version)
        assert reg.get(DISPATCHES, {}).get(("ffd_solve_fused",), 0) > 0


@pytest.mark.parametrize("name", sorted(DISRUPTION))
def test_disruption_world(name):
    ticks, reg = assert_same(DISRUPTION[name])
    assert any(t["claims"] for t in ticks)
    if name in ("empty-node", "expired", "drift", "rampdown"):
        # the sweep disrupted something, alike in both packages
        assert reg.get("karpenter_voluntary_disruption_decisions_total")
        assert any(e[3] == "Disrupted" for e in ticks[-1]["events"])
    if name == "rampdown":
        # the consolidation engine's repack (kernel B's plain version) judged
        # sets: one local dispatch per evaluate, counted alike in both packages
        assert reg.get("karpenter_disruption_device_dispatches_total", {}).get(("local",), 0) > 0
        assert reg.get("karpenter_disruption_device_sets_total")


def test_pipelined_world():
    ticks, reg = assert_same(w_waves, pipelined=True)
    assert placed(ticks) == 36
    assert reg["karpenter_scheduler_pipeline_ticks_total"].get(("pipelined",), 0) > 0


def test_convex_world():
    ticks, reg = assert_same(w_convex, tier="convex")
    assert placed(ticks) > 0
    assert reg.get("karpenter_convex_solves_total")
    # a convex solver brings the repack oracle (stage 6) into the sweep
    op = TOperator(clock=TClock(100_000.0), solver=TorchSolver(device="cpu", tier="convex"))
    assert op.disruption.repack is not None
    assert TOperator(clock=TClock(100_000.0), solver=TorchSolver(device="cpu")).disruption.repack is None


def test_seed_fan_out_stays_in_its_package():
    """One seed draws the same names and tokens in both packages, and an
    Operator of one package never reseeds the other's streams; each
    package's snapshot/restore brings back only its own."""
    from karpenter_tpu import failpoints as jfailpoints
    from karpenter_tpu.apis import objects as jobjects
    from karpenter_tpu_torch import failpoints as tfailpoints
    from karpenter_tpu_torch.apis import objects as tobjects

    jsaved, tsaved = jseeding.snapshot(), tseeding.snapshot()
    try:
        jseeding.apply(7)
        tseeding.apply(7)
        assert ([tobjects.generate_name("x-") for _ in range(3)]
                == [jobjects.generate_name("x-") for _ in range(3)])
        assert tobjects.generate_intent_token() == jobjects.generate_intent_token()
        assert tobjects.generate_uid() == jobjects.generate_uid()
        assert tfailpoints.FAILPOINTS.seed == jfailpoints.FAILPOINTS.seed == 7
        jrng = jobjects._name_rng
        TOperator(clock=TClock(100_000.0), options=TOptions(seed=9, tracing=False))
        assert jobjects._name_rng is jrng and jfailpoints.FAILPOINTS.seed == 7
        trng = tobjects._name_rng
        JOperator(clock=JClock(100_000.0), options=JOptions(seed=9, tracing=False))
        assert tobjects._name_rng is trng and tfailpoints.FAILPOINTS.seed == 9
        tseeding.restore(tsaved)
        assert tobjects._name_rng is tsaved[0] and jobjects._name_rng is not jsaved[0]
    finally:
        jseeding.restore(jsaved)
        tseeding.restore(tsaved)
