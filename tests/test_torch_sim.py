"""The golden sim corpus replayed through the port, on the CPU.

`karpenter_tpu.sim.replay` drives the JAX package's whole operator stack
(provisioner, disruption controller, kwok cloud) under a FakeClock and
hashes every decision into a digest; `tests/golden/scenarios/
digests.json` pins one per corpus scenario. Here the two decision
engines it builds (`replay.py` `ReplayEngine.build`) are swapped for the
port's: `TPUSolver` becomes an adapter over `TorchSolver(device="cpu",
g_max=64[, tier="convex"])` and `DisruptEngine` one over the port's
`DisruptEngine(solver=...)`. The adapters convert the JAX objects the
controllers hand over to the port's at each call and map the results
back by name, so the digest of every scenario must equal the golden one:
the 8 host-backend digests and `convex:binpack-adversarial-convex` on the
convex backend. Nothing under `karpenter_tpu/` changes; the swap is a
monkeypatch of the names `build` imports.

The provisioner builds a fresh JAX `Scheduler` every tick and keeps no
`pods_by_node` or `nodepool_usage` on it, so its name in
`karpenter_tpu.controllers.provisioner` is patched to a subclass that
keeps its constructor arguments; the port's `Scheduler` is built from
those. Catalog conversions are memoized by the identity of the JAX list
(the provider hands the same list over while the catalog is unchanged),
so the port's staged-catalog caches hit as the JAX solver's do.

`diurnal-small` and `diurnal-consolidation` run in tier-1 (as in
`tests/test_sim.py`); the other seven are marked `slow`.

The same two scenarios replay on the `wire` backend, whose digest must
equal the host golden (the host == wire contract, `replay.py`), in two
ways: the port's `SolverServer(device="cpu")` behind the JAX operator,
TPUSolver, DisruptEngine and `SolverClient` (the name `build` imports,
`karpenter_tpu.solver.rpc.SolverServer`, patched); and the whole port
behind the JAX operator -- the adapter's TorchSolver with the port's
`SolverClient` and `CircuitBreaker` (built with the JAX breaker's
settings) over the port's server.
"""
import dataclasses
import json
import os

import jax  # noqa: F401  -- both frameworks in one process; data crosses as plain objects
import pytest
import torch

import karpenter_tpu.scheduling as jsched
from karpenter_tpu.controllers import provisioner as jprovisioner
from karpenter_tpu.scheduling.requirements import Requirement as JRequirement
from karpenter_tpu.sim.replay import replay
from karpenter_tpu.sim.trace import read_trace
from karpenter_tpu.solver import disrupt as jdisrupt
from karpenter_tpu.solver import rpc as jrpc
from karpenter_tpu.solver import service as jservice
from karpenter_tpu.solver.disrupt import SetVerdict as JVerdict
from karpenter_tpu.solver.oracle import NewNodeGroup as JGroup
from karpenter_tpu.solver.oracle import Scheduler as JScheduler
from karpenter_tpu.solver.oracle import SchedulingResult as JResult
from karpenter_tpu_torch import metrics as tmetrics
from karpenter_tpu_torch.solver import breaker as tbreaker
from karpenter_tpu_torch.solver import rpc as trpc
from karpenter_tpu_torch.solver.disrupt import DisruptEngine as TEngine
from karpenter_tpu_torch.solver.oracle import Scheduler as TScheduler
from karpenter_tpu_torch.solver.service import TorchSolver
from tests.test_torch_consolidate import (
    port_catalog, port_nodes, port_pod, port_pool, port_resources,
)

# small tensors: one intra-op thread per test worker (several workers share the cores)
torch.set_num_threads(1)

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden", "scenarios")
with open(os.path.join(GOLDEN_DIR, "digests.json")) as _f:
    GOLDEN = json.load(_f)


# -- the port's objects mapped back to the JAX package's ----------------------------


def jax_requirement(r):
    out = object.__new__(JRequirement)
    for slot in JRequirement.__slots__:
        value = getattr(r, slot)
        setattr(out, slot, set(value) if slot == "values" else value)
    return out


def jax_resources(r):
    return jsched.Resources.from_base_units(dict(r.items()))


class Converter:
    """The per-replay conversion state: each JAX catalog list converted
    once (keyed by its identity, the list kept alive so the key stays
    sound), and every converted type mapped back to its JAX original."""

    def __init__(self):
        self._catalogs = {}
        self.jax_type = {}

    def catalog(self, items):
        hit = self._catalogs.get(id(items))
        if hit is None or hit[0] is not items:
            port = port_catalog(items)
            for it, jit in zip(port, items):
                self.jax_type[id(it)] = jit
            hit = self._catalogs[id(items)] = (items, port)
        return hit[1]

    def scheduler(self, js):
        """The port's Scheduler from a recorded JAX one (see RecordingScheduler)."""
        kw = js.init_kwargs
        pods_by_node = kw.get("pods_by_node")
        usage = kw.get("nodepool_usage")
        overhead = kw.get("daemon_overhead")
        return TScheduler(
            nodepools=[port_pool(p) for p in kw["nodepools"]],
            instance_types={name: self.catalog(items) for name, items in kw["instance_types"].items()},
            existing_nodes=port_nodes(kw.get("existing_nodes") or ()),
            pods_by_node=None if pods_by_node is None else {
                node: [port_pod(p) for p in pods] for node, pods in pods_by_node.items()},
            nodepool_usage=None if usage is None else {
                name: port_resources(r) for name, r in usage.items()},
            zones=None if kw.get("zones") is None else set(kw["zones"]),
            objective=kw.get("objective", "price"),
            daemon_overhead=None if overhead is None else {
                name: None if r is None else port_resources(r) for name, r in overhead.items()},
        )

    def result(self, res, jpods, jpools):
        """A port SchedulingResult as the JAX package's, by name."""
        out = JResult(existing_assignments=dict(res.existing_assignments),
                      unschedulable=dict(res.unschedulable))
        for g in res.new_groups:
            out.new_groups.append(JGroup(
                nodepool=jpools[g.nodepool.name],
                requirements=jsched.Requirements(jax_requirement(r) for r in g.requirements),
                instance_types=[self.jax_type[id(it)] for it in g.instance_types],
                taints=[jsched.Taint(t.key, t.effect, t.value) for t in g.taints],
                pods=[jpods[p.metadata.name] for p in g.pods],
                requested=jax_resources(g.requested),
            ))
        return out


class RecordingScheduler(JScheduler):
    """The JAX oracle Scheduler, keeping its constructor arguments (it
    drops `pods_by_node` and `nodepool_usage` into derived state)."""

    def __init__(self, *args, **kwargs):
        names = ("nodepools", "instance_types", "existing_nodes", "pods_by_node",
                 "nodepool_usage", "zones", "objective", "daemon_overhead")
        self.init_kwargs = {**dict(zip(names, args)), **kwargs}
        super().__init__(*args, **kwargs)


class _Ticket:
    """schedule_begin's ticket as the JAX provisioner reads it."""

    def __init__(self, pending, finish):
        self.pending, self._finish = pending, finish
        self.completed = pending.done is not None
        self.done = finish(pending) if self.completed else None


class PortSolver:
    """What the JAX operator reads of a TPUSolver, over TorchSolver on the
    CPU. Given the replay's JAX client and breaker, the TorchSolver gets
    the port's own: a `SolverClient` on the same socket and a
    `CircuitBreaker` with the same settings and rng."""

    mesh_engine = None

    def __init__(self, g_max=1024, tier="ffd", client=None, breaker=None, **unsupported):
        if unsupported:
            raise TypeError(f"the port adapter takes no {sorted(unsupported)}")
        tclient = tbrk = None
        if client is not None:
            tclient = trpc.SolverClient(path=client.path, timeout=client.timeout,
                                        connect_timeout=client.connect_timeout,
                                        delta=client.delta, shm=client.shm)
            tbrk = tbreaker.CircuitBreaker(
                failure_threshold=breaker.failure_threshold, backoff_base=breaker.backoff_base,
                backoff_max=breaker.backoff_max, rng=breaker._rng)
        self.inner = TorchSolver(g_max=g_max, device="cpu", tier=tier, client=tclient,
                                 breaker=tbrk)
        self.tier = tier
        self.conv = Converter()
        self.calls = 0

    def __getattr__(self, name):
        # last_route, last_group_stats, last_quality, last_convex,
        # staged_bytes_by_kind, and the wire: client, breaker, wire_healthy
        if name in ("last_route", "last_group_stats", "last_quality", "last_convex",
                    "staged_bytes_by_kind", "client", "breaker", "wire_healthy"):
            return getattr(self.inner, name)
        raise AttributeError(name)

    def close(self):
        if self.inner.breaker is not None:
            self.inner.breaker.stop()
        if self.inner.client is not None:
            self.inner.client.close()

    def _call(self, fn, scheduler, pods):
        self.calls += 1
        tpods = [port_pod(p) for p in pods]
        return fn(self.conv.scheduler(scheduler), tpods), {p.metadata.name: p for p in pods}, {
            p.name: p for p in scheduler.init_kwargs["nodepools"]}

    def schedule(self, scheduler, pods):
        res, jpods, jpools = self._call(self.inner.schedule, scheduler, pods)
        return self.conv.result(res, jpods, jpools)

    def schedule_begin(self, scheduler, pods):
        pending, jpods, jpools = self._call(self.inner.schedule_begin, scheduler, pods)
        return _Ticket(pending, lambda p: self.conv.result(
            p.done if p.done is not None else self.inner.schedule_finish(p), jpods, jpools))

    def schedule_finish(self, ticket):
        return ticket.done if ticket.completed else ticket._finish(ticket.pending)


class PortEngine:
    """The JAX DisruptEngine's surface over the port's, on the CPU."""

    def __init__(self, solver=None, **unsupported):
        if unsupported:
            raise TypeError(f"the port adapter takes no {sorted(unsupported)}")
        self.conv = solver.conv if solver is not None else Converter()
        self.engine = TEngine(solver=solver.inner) if solver is not None else TEngine(device="cpu")
        self.calls = 0

    @property
    def last_dispatch(self):
        return self.engine.last_dispatch

    def evaluate(self, nodes, sets, pools=(), catalogs=None, daemon_overhead=None):
        self.calls += 1
        verdicts = self.engine.evaluate(
            nodes=port_nodes(nodes),
            sets=[([port_pod(p) for p in pods], list(excluded)) for pods, excluded in sets],
            pools=[port_pool(p) for p in pools],
            catalogs=None if catalogs is None else {
                k: self.conv.catalog(v) for k, v in catalogs.items()},
            daemon_overhead=None if daemon_overhead is None else {
                k: None if v is None else port_resources(v) for k, v in daemon_overhead.items()},
        )
        return [JVerdict(**dataclasses.asdict(v)) for v in verdicts]


@pytest.fixture
def port_engines(monkeypatch):
    """Swap the replay's decision engines for the port's; yields the
    adapters each replay built."""
    built = {"solvers": [], "engines": []}

    def solver(*a, **kw):
        s = PortSolver(*a, **kw)
        built["solvers"].append(s)
        return s

    def engine(*a, **kw):
        e = PortEngine(*a, **kw)
        built["engines"].append(e)
        return e

    monkeypatch.setattr(jservice, "TPUSolver", solver)
    monkeypatch.setattr(jdisrupt, "DisruptEngine", engine)
    monkeypatch.setattr(jprovisioner, "Scheduler", RecordingScheduler)
    yield built
    for s in built["solvers"]:
        s.close()


@pytest.fixture
def port_server(monkeypatch):
    """The wire backend's sidecar swapped for the port's server on the CPU;
    yields the servers the replay started."""
    started = []

    def server(path=None, **kw):
        srv = trpc.SolverServer(path=path, device="cpu", **kw)
        started.append(srv)
        return srv

    monkeypatch.setattr(jrpc, "SolverServer", server)
    yield started
    for srv in started:
        if srv._thread is not None:
            srv._thread.join(timeout=10)
            assert not srv._thread.is_alive()


def trace_seed(events) -> int:
    """The header's seed (karpenter_tpu/sim/cli.py `_trace_seed`)."""
    for ev in events:
        if ev.get("ev") == "header" and "seed" in ev:
            return int(ev["seed"])
    return 0


def replay_through_port(key, built):
    backend, _, name = key.rpartition(":")
    events = read_trace(os.path.join(GOLDEN_DIR, f"{name}.jsonl"))
    res = replay(events, backend=backend or "host", seed=trace_seed(events))
    (solver,), (engine,) = built["solvers"], built["engines"]
    assert isinstance(solver.inner, TorchSolver) and solver.tier == (
        "convex" if backend == "convex" else "ffd")
    # the port decided every tick: the solver saw the provisioner's calls
    assert solver.calls > 0
    return res, solver, engine


TIER1 = ("diurnal-small", "diurnal-consolidation")
SCENARIOS = [pytest.param(k, marks=() if k in TIER1 else pytest.mark.slow) for k in sorted(GOLDEN)]


def plain_dispatches(entry) -> float:
    return tmetrics.SOLVER_KERNEL_DISPATCHES.value(entry=entry, impl="plain")


def engine_repacks() -> float:
    # the port's consolidation engine's kernel B runs: one per local evaluate
    return tmetrics.DISRUPTION_DEVICE_DISPATCHES.value(path="local")


@pytest.mark.parametrize("key", SCENARIOS)
def test_golden_digest_through_port(key, port_engines):
    scans, repacks = plain_dispatches("ffd_solve_fused"), engine_repacks()
    res, solver, engine = replay_through_port(key, port_engines)
    assert res.digest == GOLDEN[key], f"{key}: the port's replay drifted from the golden digest"
    # the port's device path (kernel A's plain version on the CPU) ran
    assert plain_dispatches("ffd_solve_fused") > scans
    if key == "diurnal-consolidation":
        # the port's consolidation engine judged candidate sets end to end
        # (kernel B's plain version)
        assert engine.calls > 0 and engine.last_dispatch["path"] == "local"
        assert engine_repacks() > repacks
    if key.startswith("convex:"):
        assert solver.last_convex is not None


def replay_wire(name):
    events = read_trace(os.path.join(GOLDEN_DIR, f"{name}.jsonl"))
    return replay(events, backend="wire", seed=trace_seed(events))


def served_bytes() -> float:
    return sum(tmetrics.WIRE_BYTES.value(direction="received", transport=t)
               for t in ("shm", "tcp"))


@pytest.mark.parametrize("name", TIER1)
def test_wire_digest_port_server(name, port_server):
    """The JAX operator, TPUSolver, DisruptEngine and SolverClient against
    the port's sidecar: the host golden digest."""
    before = served_bytes()
    res = replay_wire(name)
    assert res.digest == GOLDEN[name], f"{name}: the port's server drifted from the golden digest"
    assert len(port_server) == 1 and served_bytes() > before


@pytest.mark.parametrize("name", TIER1)
def test_wire_digest_port_solver_and_client(name, port_engines, port_server):
    """The adapter's TorchSolver with the port's client and breaker over
    the port's server: the host golden digest, every tick on the wire."""
    before = tmetrics.HANDLED_ERRORS.value(site="solver.wire_down")
    res = replay_wire(name)
    assert res.digest == GOLDEN[name], f"{name}: the port's wire replay drifted from the golden digest"
    (solver,), (engine,) = port_engines["solvers"], port_engines["engines"]
    assert solver.calls > 0 and isinstance(solver.inner.client, trpc.SolverClient)
    assert solver.inner.breaker.state == "closed" and solver.inner.breaker.trips == 0
    assert tmetrics.HANDLED_ERRORS.value(site="solver.wire_down") == before
    if name == "diurnal-consolidation":
        assert engine.calls > 0 and engine.last_dispatch["path"] == "wire"


def test_corpus_is_the_nine_digests():
    """The gate covers every pinned digest: 8 host scenarios and the convex one."""
    assert len(GOLDEN) == 9
    assert sum(k.startswith("convex:") for k in GOLDEN) == 1
