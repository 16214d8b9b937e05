"""The port's circuit breaker against the JAX package's, on the CPU.

- driven through the same schedule of failures, probes and clock steps
  under the same seeded rng and fake clock, both breakers pass through the
  same states, describe() the same documents and move their registries'
  breaker families by the same amounts;
- the breaker drill on a solver: a TorchSolver whose port sidecar dies
  solves each tick in process -- first behind the failed wire ladder
  (`fallback="rpc-down"`), then, once the breaker opened, without
  touching the wire (`"breaker-open"`) -- with the wire ticks' decisions,
  each tick counted once; a restarted sidecar is promoted by the probe
  and the next tick rides the wire again. TPUSolver over the JAX sidecar
  runs the same drill and counts the same.
"""
import os
import random
import shutil
import tempfile

import pytest

import jax  # noqa: F401  -- both frameworks in one process
import torch

from karpenter_tpu import metrics as jmetrics
from karpenter_tpu.solver import breaker as jbreaker
from karpenter_tpu.solver import rpc as jrpc
from karpenter_tpu.solver.service import TPUSolver
from karpenter_tpu_torch import metrics as tmetrics
from karpenter_tpu_torch import tracing as ttracing
from karpenter_tpu_torch.solver import breaker as tbreaker
from karpenter_tpu_torch.solver import rpc as trpc
from karpenter_tpu_torch.solver.service import TorchSolver
from tests.test_packing import catalog_items  # noqa: F401
from tests.test_torch_catalog import port_items  # noqa: F401
from tests.test_torch_oracle import build, fuzz_spec, result_sig, small_items  # noqa: F401

# small tensors: one intra-op thread per test worker (several workers share the cores)
torch.set_num_threads(1)

G = 64
PKG = {
    "jax": (jbreaker, jmetrics, jrpc),
    "torch": (tbreaker, tmetrics, trpc),
}


class FakeClock:
    def __init__(self, t=1_000.0):
        self.t = t

    def __call__(self):
        return self.t


def breaker_families(metrics):
    out = {f"to={s}": metrics.BREAKER_TRANSITIONS.value(to=s)
           for s in ("closed", "open", "half-open")}
    out.update({f"probe={o}": metrics.BREAKER_PROBES.value(outcome=o)
                for o in ("success", "failure")})
    out.update({f"state={s}": metrics.BREAKER_STATE.value(state=s)
                for s in ("closed", "open", "half-open")})
    return out


def delta(after, before):
    return {k: after[k] - before[k] if k.startswith(("to=", "probe=")) else after[k]
            for k in after}


def drive(which, probe_outcomes):
    """One schedule of failures, clock steps, probes and a forced trip;
    the describe() document after each step and the families' moves."""
    mod, metrics, _ = PKG[which]
    clock = FakeClock()
    outcomes = iter(probe_outcomes)
    promoted = []
    b = mod.CircuitBreaker(
        failure_threshold=3, backoff_base=0.5, backoff_max=4.0,
        probe=lambda: next(outcomes), on_promote=lambda: promoted.append(clock.t),
        clock=clock, rng=random.Random(7).random,
    )
    before = breaker_families(metrics)
    docs = []

    def step(action):
        if action == "fail":
            docs.append(("fail", b.record_failure()))
        elif action == "ok":
            b.record_success()
        elif action == "maybe":
            docs.append(("maybe", b.maybe_probe()))
        elif action == "now":
            docs.append(("now", b.probe_now()))
        elif action == "force":
            b.force_open("drill")
        else:
            clock.t += float(action)
        docs.append((b.state, b.allow(), b.describe()))

    for action in ("fail", "ok", "fail", "fail", "fail", "maybe", "0.6", "maybe", "0.1",
                   "maybe", "2.0", "maybe", "fail", "force", "0.2", "now", "fail", "fail",
                   "fail", "5", "maybe"):
        step(action)
    return docs, delta(breaker_families(metrics), before), promoted


class TestStateMachine:
    @pytest.mark.parametrize("outcomes", [
        (False, True, False, True),
        (True, True, True, True),
        (False, False, False, False),
    ])
    def test_same_states_and_metrics_as_jax(self, outcomes):
        want = drive("jax", outcomes)
        got = drive("torch", outcomes)
        assert got == want
        states = [d[0] for d in want[0] if len(d) == 3]
        assert "open" in states

    def test_backoff_is_seeded_and_capped(self):
        docs, _, _ = drive("torch", (False,) * 4)
        backoffs = [d[2]["backoff_s"] for d in docs if len(d) == 3]
        assert max(backoffs) <= 4.0 and min(backoffs) == 0.5

    def test_probe_thread_stops(self):
        b = tbreaker.CircuitBreaker(failure_threshold=1, backoff_base=0.01,
                                    probe=lambda: True, auto_probe=True)
        try:
            b.record_failure()
            for _ in range(200):
                if b.state == "closed":
                    break
                b._stop.wait(0.01)
            assert b.state == "closed" and b.promotions == 1
        finally:
            b.stop()
            b._thread.join(timeout=5)
            assert not b._thread.is_alive()


# -- the drill on a solver -------------------------------------------------------------


def wire_counters(metrics):
    out = {
        "short_circuits": metrics.BREAKER_SHORT_CIRCUITS.value(),
        "rpc_down": metrics.SOLVER_PIPELINE_FALLBACKS.value(reason="rpc-down"),
        "to_open": metrics.BREAKER_TRANSITIONS.value(to="open"),
        "to_closed": metrics.BREAKER_TRANSITIONS.value(to="closed"),
    }
    return out


def handled_errors(metrics):
    """Every `karpenter_handled_errors_total` sample, by site."""
    return {key[0]: v for key, v in list(metrics.HANDLED_ERRORS._values.items())}


def start(which, path):
    if which == "jax":
        return jrpc.SolverServer(path=path).start()
    return trpc.SolverServer(path=path, device="cpu").start()


def stop(srv):
    srv.stop()
    srv._thread.join(timeout=10)
    assert not srv._thread.is_alive()


def drill(which, small_items):  # noqa: F811
    """Ticks over a live sidecar, a dead one, and a restarted one. Returns
    per tick (result sig, fallback annotation, counter moves)."""
    mod, metrics, rpc = PKG[which]
    d = tempfile.mkdtemp(prefix="kt-")
    path = os.path.join(d, "s.sock")
    srv = start(which, path)
    client = rpc.SolverClient(path=path, timeout=30.0, connect_timeout=0.5)
    brk = mod.CircuitBreaker(failure_threshold=2, backoff_base=1000.0, clock=FakeClock(),
                             rng=random.Random(3).random)
    solver = (TPUSolver(g_max=G, client=client, breaker=brk) if which == "jax"
              else TorchSolver(device="cpu", g_max=G, client=client, breaker=brk))
    tracer = (ttracing if which == "torch" else __import__("karpenter_tpu.tracing").tracing).TRACER
    spec = fuzz_spec(2, spread=0.6, nodes=3, bound_spread=True, overhead=True)
    ticks = []
    try:
        def tick():
            w = build(which, spec, small_items)
            before, handled_before = wire_counters(metrics), handled_errors(metrics)
            with tracer.trace("tick", force=True) as root:
                sig = result_sig(solver.schedule(w.scheduler("price"), list(w.pods)))
            after, handled_after = wire_counters(metrics), handled_errors(metrics)
            handled = {site: handled_after[site] - handled_before.get(site, 0.0)
                       for site in handled_after
                       if handled_after[site] != handled_before.get(site, 0.0)}
            fallback = root.attributes.get("fallback")
            if fallback is None:
                fallback = next((c.attributes.get("fallback") for c in root.children
                                 if c.attributes.get("fallback")), None)
            ticks.append((sig, fallback, {k: after[k] - before[k] for k in after},
                          brk.state, solver.wire_healthy(), handled))

        tick()                      # the wire
        stop(srv)                   # the sidecar dies
        client.close()
        tick()                      # ladder fails -> in process (1st failure)
        tick()                      # 2nd failure -> the breaker opens
        tick()                      # breaker open: the wire is not touched
        srv = start(which, path)    # the sidecar is back
        assert brk.probe_now()
        tick()                      # promoted: the wire again
        assert solver.client.debug_info()["staged_seqnums"]
    finally:
        client.close()
        stop(srv)
        shutil.rmtree(d, ignore_errors=True)
    return ticks


_DRILLS = {}


def drills(small_items):  # noqa: F811
    """The drill through the JAX package, then through the port (run once
    per test process, shared by the tests below)."""
    if not _DRILLS:
        _DRILLS["jax"] = drill("jax", small_items)
        _DRILLS["torch"] = drill("torch", small_items)
    return _DRILLS["jax"], _DRILLS["torch"]


class TestDrill:
    def test_dead_sidecar_ticks_equal_wire_ticks_counted_once(self, small_items):  # noqa: F811
        want, got = drills(small_items)
        sig0 = got[0][0]
        assert sig0[0][0], "the wire tick opened no groups"
        assert all(t[0] == sig0 for t in got), "an in-process tick decided differently"
        assert [t[0] for t in got] == [t[0] for t in want]
        assert [t[1] for t in got] == [None, "rpc-down", "rpc-down", "breaker-open", None]
        assert [t[1] for t in got] == [t[1] for t in want]
        assert [(t[3], t[4]) for t in got] == [
            ("closed", True), ("closed", True), ("open", False), ("open", False), ("closed", True)]
        assert [(t[3], t[4]) for t in got] == [(t[3], t[4]) for t in want]
        # the JAX package's counters move alike in both registries
        shared = ("short_circuits", "rpc_down", "to_open", "to_closed")
        assert [{k: t[2][k] for k in shared} for t in got] == [t[2] for t in want]
        # each in-process tick counted once by its rung, in the JAX
        # package's counters only
        assert [(t[2]["rpc_down"], t[2]["short_circuits"]) for t in got] == [
            (0, 0), (1, 0), (1, 0), (0, 1), (0, 0)]
        assert [t[2]["to_open"] for t in got] == [0, 0, 1, 0, 0]

    def test_handled_errors_samples_equal_jax(self, small_items):  # noqa: F811
        """The drill moves `karpenter_handled_errors_total` alike in both
        registries, tick by tick: the rungs count only in the fallback and
        short-circuit families, never under a port-only site."""
        want, got = drills(small_items)
        assert [t[5] for t in got] == [t[5] for t in want]
        for t in got:
            assert not {"solver.wire_down", "solver.breaker_open"} & set(t[5])

