"""The port's fleet (fleet/coalesce.py, fleet/service.py, sim/fleet.py,
`SolverServer(coalescer=)`, `SolverClient(tenant=)`) against the JAX
package's, on the CPU.

- the coalescer's six scenarios of tests/test_tenant.py (tenant order,
  routing, breaker open and recover, deadline refusal, crash, close), run
  on each package's `DispatchCoalescer` under one FakeClock: the same
  order, outcomes and metric moves in both registries (the dispatcher is
  held behind a blocking submission while a window fills, so every
  window's contents are known);
- 3 tenants solving concurrently through the port's coalescing server
  (device="cpu") decide as each tenant alone on a plain port server and
  as the JAX `TPUSolver`, and every solve went through the coalescer
  (one `karpenter_tenant_dispatches_total{outcome="ok"}` per solve, no
  rung); one tenant's evicted staging restages that tenant only;
- the wire both ways: the JAX `SolverClient(tenant=)` against the port's
  coalescing server and the port's client against the JAX one decide
  alike; op headers are byte-equal with a tenant and without one;
- the fault drills: `fleet.dispatch` and a one-tenant corrupt frame each
  cost one tenant its rung; the tenant breaker's refusal feeds the port
  client's ladder;
- fleet sizing (tests/test_packing.py's TestFleetSizing) on the port's
  fleet/service.py;
- `replay_fleet(3, device="cpu")` equals the pinned
  multi-cluster-storm.digests.json and each tenant's isolated replay;
- a mesh enters everywhere the JAX package takes one, and an oversized
  spec (more shards than real devices) is refused there
  (tests/test_torch_mesh.py holds the mesh itself).

Every socket carries a timeout and every server stops in a fixture or a
finally; socket paths come from `tempfile.mkdtemp(prefix="kt-")`.
"""
import json
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import threading
import time
import types
from pathlib import Path

import numpy as np
import pytest

import jax  # noqa: F401  -- both frameworks in one process; data crosses as numpy
import torch

from karpenter_tpu import failpoints as jfailpoints
from karpenter_tpu import metrics as jmetrics
from karpenter_tpu.apis import NodePool as JNodePool, Pod as JPod, labels as jwk
from karpenter_tpu.fleet import coalesce as jcoalesce
from karpenter_tpu.scheduling import Resources as JResources, Toleration as JToleration
from karpenter_tpu.solver import rpc as jrpc
from karpenter_tpu.solver.service import TPUSolver
from karpenter_tpu_torch import failpoints as tfailpoints
from karpenter_tpu_torch import metrics as tmetrics
from karpenter_tpu_torch.apis import NodePool as TNodePool, Pod as TPod, labels as twk
from karpenter_tpu_torch.fleet import coalesce as tcoalesce
from karpenter_tpu_torch.fleet import service as tservice
from karpenter_tpu_torch.obs import hbm as thbm
from karpenter_tpu_torch.scheduling import Resources as TResources, Toleration as TToleration
from karpenter_tpu_torch.sim import fleet as tsimfleet
from karpenter_tpu_torch.solver import rpc as trpc
from karpenter_tpu_torch.solver.service import TorchSolver
from tests.test_packing import catalog_items  # noqa: F401
from tests.test_torch_catalog import decision_sig, port_items  # noqa: F401
from tests.test_torch_oracle import small_items  # noqa: F401

# small tensors: one intra-op thread per test worker (several workers share the cores)
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
G = 64
JOIN_S = 10.0
PKGS = {
    "jax": types.SimpleNamespace(coalesce=jcoalesce, metrics=jmetrics,
                                 failpoints=jfailpoints),
    "torch": types.SimpleNamespace(coalesce=tcoalesce, metrics=tmetrics,
                                   failpoints=tfailpoints),
}


class FakeClock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


def hist(h, **labels):
    """(observations, sum) of a histogram's series."""
    key = tuple(labels.get(n, "") for n in h.label_names)
    return h._totals.get(key, 0), h._sums.get(key, 0.0)


def tenant_metrics(m, tenants) -> dict:
    """Every tenant family's value for `tenants`, plus the window-size
    histogram and the dispatcher's handled-error site."""
    out = {}
    for t in tenants:
        for o in ("ok", "error"):
            out[f"dispatches {t} {o}"] = m.TENANT_DISPATCHES.value(tenant=t, outcome=o)
        for r in ("deadline", "breaker-open"):
            out[f"refusals {t} {r}"] = m.TENANT_REFUSALS.value(tenant=t, reason=r)
        out[f"trips {t}"] = m.TENANT_BREAKER_TRIPS.value(tenant=t)
        out[f"dispatch seconds {t}"] = hist(m.TENANT_DISPATCH_SECONDS, tenant=t)
    out["windows"] = hist(m.TENANT_WINDOW_SIZE)
    out["handled"] = m.HANDLED_ERRORS.value(site="fleet.coalesce.dispatcher")
    return out


def moved(after: dict, before: dict) -> dict:
    """The entries that changed: counter deltas, histogram (count, sum) deltas."""
    out = {}
    for k, v in after.items():
        if isinstance(v, tuple):
            d = (v[0] - before[k][0], round(v[1] - before[k][1], 9))
            if d != (0, 0.0):
                out[k] = d
        elif v != before[k]:
            out[k] = v - before[k]
    return out


def wait_for(pred, timeout=10.0):
    deadline = time.monotonic() + timeout
    while not pred():
        if time.monotonic() > deadline:
            raise AssertionError("condition not reached")
        time.sleep(0.005)


class Held:
    """A coalescer whose dispatcher is held on a blocking submission
    while a window fills: every later window's contents are then known,
    whatever the threads' timing."""

    def __init__(self, c):
        self.c = c
        self.gate = threading.Event()
        started = threading.Event()

        def block():
            started.set()
            self.gate.wait(JOIN_S)
            return "held"

        self.thread = threading.Thread(target=c.submit, args=("~hold", block))
        self.thread.start()
        assert started.wait(JOIN_S)
        self.outcomes = {}
        self._lock = threading.Lock()
        self.threads = []

    def submit(self, tenant, fn):
        def run():
            try:
                r = self.c.submit(tenant, fn)
            except BaseException as e:  # noqa: BLE001 - the assert target
                r = e
            with self._lock:
                self.outcomes[tenant] = r

        th = threading.Thread(target=run)
        th.start()
        self.threads.append(th)

    def release(self, queued: int):
        wait_for(lambda: self.c.describe()["queued"] == queued)
        self.gate.set()
        for th in [self.thread, *self.threads]:
            th.join(JOIN_S)
            assert not th.is_alive()


def outcome(r):
    if isinstance(r, BaseException):
        return f"{type(r).__name__}: {r}"
    return r


# -- the coalescer's policy, both packages alike -----------------------------------


@pytest.mark.parametrize("pkg", ["jax", "torch"])
class TestCoalescerPolicy:
    TENANTS = ("alpha", "mid", "zeta", "a", "b", "c", "sick", "healthy", "~hold")

    def run(self, pkg, scenario):
        p = PKGS[pkg]
        before = tenant_metrics(p.metrics, self.TENANTS)
        got = scenario(p)
        return got, moved(tenant_metrics(p.metrics, self.TENANTS), before)

    def test_batch_runs_in_deterministic_tenant_order(self, pkg):
        def scenario(p):
            c = p.coalesce.DispatchCoalescer(window_s=0.0, clock=FakeClock())
            held, order = Held(c), []
            for t in ("zeta", "alpha", "mid"):
                held.submit(t, lambda t=t: order.append(t) or t)
            held.release(queued=3)
            window = dict(c.last_window)
            c.close()
            return order, window, {t: outcome(r) for t, r in sorted(held.outcomes.items())}

        (order, window, outs), m = self.run(pkg, scenario)
        assert order == ["alpha", "mid", "zeta"]
        assert window == {"batch": 3, "tenants": 3}
        assert outs == {"alpha": "alpha", "mid": "mid", "zeta": "zeta"}
        assert m == {"dispatches alpha ok": 1, "dispatches mid ok": 1, "dispatches zeta ok": 1,
                     "dispatches ~hold ok": 1, "dispatch seconds alpha": (1, 0.0),
                     "dispatch seconds mid": (1, 0.0), "dispatch seconds zeta": (1, 0.0),
                     "dispatch seconds ~hold": (1, 0.0), "windows": (2, 4.0)}

    def test_result_and_error_routing(self, pkg):
        def scenario(p):
            c = p.coalesce.DispatchCoalescer(window_s=0.0, clock=FakeClock())
            r = c.submit("a", lambda: 41 + 1)
            with pytest.raises(ValueError, match="boom") as e:
                c.submit("a", lambda: (_ for _ in ()).throw(ValueError("boom")))
            open_ = c.tenant_open("a")
            c.close()
            return r, str(e.value), open_

        got, m = self.run(pkg, scenario)
        assert got == (42, "boom", False)
        assert m == {"dispatches a ok": 1, "dispatches a error": 1,
                     "dispatch seconds a": (2, 0.0), "windows": (2, 2.0)}

    def test_per_tenant_breaker_opens_and_recovers(self, pkg):
        def scenario(p):
            clock = FakeClock()
            c = p.coalesce.DispatchCoalescer(window_s=0.0, breaker_threshold=3,
                                             breaker_cooldown_s=5.0, clock=clock)

            def bad():
                raise ConnectionError("sick cluster")

            steps = []
            for _ in range(3):
                with pytest.raises(ConnectionError):
                    c.submit("sick", bad)
            with pytest.raises(p.coalesce.TenantRefusal, match="breaker open") as e:
                c.submit("sick", lambda: "never runs")
            steps.append(str(e.value))
            steps.append(c.submit("healthy", lambda: "ok"))
            steps.append((c.tenant_open("sick"), c.tenant_open("healthy"),
                          p.metrics.TENANT_BREAKER_STATE.value(tenant="sick")))
            clock.t += 6.0
            steps.append(c.submit("sick", lambda: "recovered"))
            steps.append((c.tenant_open("sick"),
                          p.metrics.TENANT_BREAKER_STATE.value(tenant="sick")))
            c.close()
            return steps

        got, m = self.run(pkg, scenario)
        assert got == ["tenant sick refused: breaker open", "ok", (True, False, 1.0),
                       "recovered", (False, 0.0)]
        assert m == {"dispatches sick error": 3, "dispatches sick ok": 1,
                     "refusals sick breaker-open": 1, "trips sick": 1,
                     "dispatches healthy ok": 1, "dispatch seconds sick": (4, 0.0),
                     "dispatch seconds healthy": (1, 0.0), "windows": (5, 5.0)}

    def test_deadline_blown_while_queued_refuses(self, pkg):
        """Tenant "a" sorts first in the window and burns 5 fake seconds
        of device time, blowing "b"'s 1 s budget: "b" is refused at
        dispatch, and its breaker stays closed (load shedding, not
        dispatch evidence)."""
        def scenario(p):
            clock = FakeClock()
            c = p.coalesce.DispatchCoalescer(window_s=0.0, budget_s=1.0, clock=clock)
            held = Held(c)

            def slow_first():
                clock.t += 5.0
                return "a-done"

            held.submit("a", slow_first)
            held.submit("b", lambda: "b-done")
            held.release(queued=2)
            open_ = c.tenant_open("b")
            after = c.submit("b", lambda: "b-after")
            c.close()
            return ({t: outcome(r) for t, r in sorted(held.outcomes.items())}, open_, after,
                    type(held.outcomes["b"]) is p.coalesce.TenantRefusal)

        (outs, open_, after, typed), m = self.run(pkg, scenario)
        assert outs == {"a": "a-done", "b": "TenantRefusal: tenant b refused: deadline blown "
                        "while queued"}
        assert typed and not open_ and after == "b-after"
        assert m == {"dispatches a ok": 1, "dispatches b ok": 1, "dispatches ~hold ok": 1,
                     "refusals b deadline": 1, "dispatch seconds a": (1, 5.0),
                     "dispatch seconds b": (2, 0.0), "dispatch seconds ~hold": (1, 0.0),
                     "windows": (3, 4.0)}

    def test_crash_fails_window_and_closes_without_wedging(self, pkg):
        """An OperatorCrashed inside a dispatch terminates the coalescer
        at its sanctioned crash terminal (_loop): the crashed submission
        and its batch-mate unblock with typed refusals, later submissions
        refuse fast, the crash is counted once."""
        def scenario(p):
            c = p.coalesce.DispatchCoalescer(window_s=0.0, clock=FakeClock())
            held = Held(c)

            def crash():
                raise p.failpoints.OperatorCrashed("watchdog escalation")

            held.submit("a", crash)
            held.submit("b", lambda: "b-done")
            held.release(queued=2)
            with pytest.raises(p.coalesce.TenantRefusal, match="closed") as e:
                c.submit("c", lambda: "never")
            wait_for(lambda: p.metrics.HANDLED_ERRORS.value(
                site="fleet.coalesce.dispatcher") > before_handled[pkg])
            return {t: outcome(r) for t, r in sorted(held.outcomes.items())}, str(e.value)

        before_handled = {k: PKGS[k].metrics.HANDLED_ERRORS.value(
            site="fleet.coalesce.dispatcher") for k in PKGS}
        (outs, closed), m = self.run(pkg, scenario)
        assert outs == {"a": "TenantRefusal: tenant a refused: dispatcher crashed: "
                        "OperatorCrashed",
                        "b": "TenantRefusal: tenant b refused: dispatcher crashed mid-window"}
        assert closed == "tenant c refused: coalescer closed"
        assert m == {"dispatches a error": 1, "dispatches ~hold ok": 1,
                     "dispatch seconds a": (1, 0.0), "dispatch seconds ~hold": (1, 0.0),
                     "windows": (2, 3.0), "handled": 1}

    def test_close_unblocks_queued_submissions(self, pkg):
        def scenario(p):
            c = p.coalesce.DispatchCoalescer(window_s=0.0, clock=FakeClock())
            held = Held(c)
            held.submit("a", lambda: "late")
            wait_for(lambda: c.describe()["queued"] == 1)
            c.close()
            th = held.threads[0]
            th.join(JOIN_S)
            described = c.describe()
            held.gate.set()
            held.thread.join(JOIN_S)
            return outcome(held.outcomes["a"]), described["queued"]

        got, m = self.run(pkg, scenario)
        assert got == ("TenantRefusal: tenant a refused: coalescer closed", 0)
        assert m == {"dispatches ~hold ok": 1, "dispatch seconds ~hold": (1, 0.0),
                     "windows": (1, 1.0)}


# -- the coalescing sidecar: N tenants, one server ------------------------------------


def mixed_pods(pkg: str, seed: int, n: int, salt: int):
    """tests/test_fleet.py's mixed_pods in either package."""
    Pod, Resources, Toleration, wk = (
        (JPod, JResources, JToleration, jwk) if pkg == "jax" else
        (TPod, TResources, TToleration, twk))
    shapes = [
        ("250m", "512Mi", None, ()),
        ("500m", "1Gi", None, ()),
        ("1", "2Gi", {wk.CAPACITY_TYPE_LABEL: wk.CAPACITY_TYPE_ON_DEMAND}, ()),
        ("2", "4Gi", {wk.ARCH_LABEL: "arm64"}, ()),
        ("500m", "2Gi", None, ((Toleration(key="dedicated", operator="Exists"),))),
    ]
    rng = np.random.default_rng(seed)
    pods = []
    for i in range(n):
        cpu, mem, sel, tol = shapes[int(rng.integers(0, len(shapes)))]
        pods.append(Pod(
            f"fleet-{salt}-{i}", requests=Resources({"cpu": cpu, "memory": mem}),
            node_selector=dict(sel) if sel else {}, tolerations=list(tol),
        ))
    return pods


def tenant_pods(pkg: str, i: int):
    return mixed_pods(pkg, 1000 + i, 35, 7000 + i)


@pytest.fixture(scope="module")
def sockdir():
    d = tempfile.mkdtemp(prefix="kt-")
    yield d
    shutil.rmtree(d, ignore_errors=True)


def stop_server(srv):
    srv.stop()
    srv._thread.join(timeout=JOIN_S)
    assert not srv._thread.is_alive(), "the server thread did not stop"


@pytest.fixture
def fleet_server(sockdir):
    """A started port coalescing sidecar on the CPU (build_fleet_server)."""
    path = os.path.join(sockdir, f"f{time.monotonic_ns() % 10**9}.sock")
    srv = tservice.build_fleet_server(path=path, mesh=False, device="cpu")
    yield srv
    stop_server(srv)


@pytest.fixture(scope="module")
def host_sigs(small_items):  # noqa: F811
    """Each tenant's decision from the JAX TPUSolver in process."""
    pool = JNodePool("default")
    solver = TPUSolver(g_max=G)
    return {i: decision_sig(solver.solve(pool, small_items["jax"], tenant_pods("jax", i)))
            for i in range(3)}


def port_tenant(srv, tenant, **kw):
    kw.setdefault("timeout", 120.0)
    client = trpc.SolverClient(path=srv.path, tenant=tenant, track_transport=False,
                               connect_timeout=5.0, **kw)
    return client, TorchSolver(g_max=G, client=client, breaker=False, device="cpu")


def answers_ping(path) -> bool:
    probe = trpc.SolverClient(path=path, timeout=5.0, connect_timeout=1.0, shm=False,
                              track_transport=False)
    try:
        return probe.ping()
    except OSError:
        return False
    finally:
        probe.close()


def rung_count():
    return tmetrics.SOLVER_PIPELINE_FALLBACKS.value(reason="rpc-down")


class TestMultiTenant:
    def test_concurrent_tenants_equal_isolated_and_tpusolver(self, fleet_server, sockdir,
                                                             small_items, host_sigs):  # noqa: F811
        items, pool = small_items["torch"], TNodePool("default")
        isolated = {}
        for i in range(3):
            srv = trpc.SolverServer(path=os.path.join(sockdir, f"iso{i}.sock"),
                                    device="cpu").start()
            try:
                client, solver = port_tenant(srv, None)
                isolated[i] = decision_sig(solver.solve(pool, items, tenant_pods("torch", i)))
                client.close()
            finally:
                stop_server(srv)
        tenants = [port_tenant(fleet_server, f"cluster-{i}") for i in range(3)]
        try:
            # a sequential warm pass stages each tenant's catalog first
            for i, (_, solver) in enumerate(tenants):
                solver.solve(pool, items, tenant_pods("torch", i))
            ok0 = [tmetrics.TENANT_DISPATCHES.value(tenant=f"cluster-{i}", outcome="ok")
                   for i in range(3)]
            rung0 = rung_count()
            shared, lock = {}, threading.Lock()

            def run(i):
                res = tenants[i][1].solve(pool, items, tenant_pods("torch", i))
                with lock:
                    shared[i] = decision_sig(res)

            threads = [threading.Thread(target=run, args=(i,)) for i in range(3)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(120)
            assert shared == isolated == host_sigs
            # one coalesced dispatch a solve, none on a rung: the dispatcher's
            # bookkeeping runs just after the reply unblocks the client
            wait_for(lambda: all(
                tmetrics.TENANT_DISPATCHES.value(tenant=f"cluster-{i}", outcome="ok") > ok0[i]
                for i in range(3)))
            assert [tmetrics.TENANT_DISPATCHES.value(tenant=f"cluster-{i}", outcome="ok") - ok0[i]
                    for i in range(3)] == [1, 1, 1]
            assert rung_count() == rung0
            doc = tenants[0][0].debug_info()["coalescer"]
            assert sorted(doc["tenants"]) == ["cluster-0", "cluster-1", "cluster-2"]
            assert not any(t["breaker_open"] for t in doc["tenants"].values())
        finally:
            for client, _ in tenants:
                client.close()

    def test_one_tenants_eviction_restages_that_tenant_only(self, fleet_server, small_items,
                                                             host_sigs):  # noqa: F811
        """Staging keys are per tenant (each solver's seqnums carry its own
        random prefix): the sidecar dropping cluster-E's catalog and class
        epochs -- what its LRU does under pressure -- costs cluster-E one
        full re-stage and cluster-F nothing; neither takes a rung."""
        items, pool = small_items["torch"], TNodePool("default")
        (ce, se), (cf, sf) = port_tenant(fleet_server, "cluster-E"), port_tenant(
            fleet_server, "cluster-F")
        try:
            for i, s in enumerate((se, sf)):
                s.solve(pool, items, tenant_pods("torch", i))
            f_seqnums = set(cf._staged_seqnums)
            with fleet_server._lock:
                for seq in ce._staged_seqnums:
                    fleet_server._staged.pop(seq)
                for epoch, _ in ce._epoch_bases.values():
                    fleet_server._epochs.pop(epoch)
            before = tenant_metrics(tmetrics, ("cluster-E", "cluster-F"))
            stale0 = {r: tmetrics.SOLVER_PIPELINE_FALLBACKS.value(reason=r)
                      for r in ("stale-epoch", "stale-seqnum")}
            rung0 = rung_count()
            got, lock = {}, threading.Lock()

            def run(i, s):
                res = decision_sig(s.solve(pool, items, tenant_pods("torch", i)))
                with lock:
                    got[i] = res

            threads = [threading.Thread(target=run, args=(i, s)) for i, s in enumerate((se, sf))]
            for t in threads:
                t.start()
            for t in threads:
                t.join(120)
            assert got == {i: host_sigs[i] for i in range(2)}
            assert rung_count() == rung0
            m = moved(tenant_metrics(tmetrics, ("cluster-E", "cluster-F")), before)
            assert not any(k.endswith(" error") or k.startswith(("refusals", "trips"))
                           for k in m), m
            assert m["dispatches cluster-F ok"] == 1
            assert sum(tmetrics.SOLVER_PIPELINE_FALLBACKS.value(reason=r) - n
                       for r, n in stale0.items()) == 1
            assert set(cf._staged_seqnums) == f_seqnums
            assert set(ce._staged_seqnums) <= set(fleet_server._staged)
        finally:
            ce.close()
            cf.close()

    def test_ping_advertises_coalesce(self, fleet_server):
        client = trpc.SolverClient(path=fleet_server.path, track_transport=False,
                                   connect_timeout=5.0)
        try:
            assert "coalesce" in client.features()
        finally:
            client.close()

    def test_binary_coalesces_two_tenants(self, sockdir, small_items, host_sigs):  # noqa: F811
        path = os.path.join(sockdir, "bin.sock")
        proc = subprocess.Popen(
            [sys.executable, "-m", "karpenter_tpu_torch.solver.rpc", "--socket", path,
             "--device", "cpu", "--coalesce", "--tenant-budget", "2.0"],
            cwd=str(REPO), stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
            env=dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1"))
        try:
            srv = types.SimpleNamespace(path=path)
            wait_for(lambda: answers_ping(path), timeout=120)
            tenants = [port_tenant(srv, f"bin-{i}") for i in range(2)]
            assert "coalesce" in tenants[0][0].features()
            pool = TNodePool("default")
            got = {i: decision_sig(s.solve(pool, small_items["torch"], tenant_pods("torch", i)))
                   for i, (_, s) in enumerate(tenants)}
            doc = tenants[0][0].debug_info()["coalescer"]
            for client, _ in tenants:
                client.close()
            assert got == {i: host_sigs[i] for i in range(2)}
            assert sorted(doc["tenants"]) == ["bin-0", "bin-1"]
        finally:
            proc.terminate()
            proc.wait(timeout=30)


# -- the wire between the packages -----------------------------------------------------


HEADER_OPS = (
    dict(op="solve", seqnum="s1", g_max=64, objective="price"),
    dict(op="solve_compact", seqnum="s1", g_max=64, nnz_max=512, objective="price"),
    dict(op="solve_convex", seqnum="s1", g_max=64, objective="price", iters=48),
    dict(op="solve_disrupt", depoch="e1"),
    dict(op="solve_disrupt", depoch="e1", seqnum="s1"),
)


def framed(mod, header) -> bytes:
    a, b = socket.socketpair()
    try:
        b.settimeout(10)
        mod._send_frame(a, header)
        a.close()
        return b.recv(1 << 16)
    finally:
        b.close()


class TestWire:
    @pytest.mark.parametrize("tenant", [None, "cluster-7"])
    @pytest.mark.parametrize("fields", HEADER_OPS, ids=lambda f: "+".join(sorted(f)))
    def test_op_headers_byte_equal(self, tenant, fields):
        jc = jrpc.SolverClient(path="/nonexistent", tenant=tenant)
        tc = trpc.SolverClient(path="/nonexistent", tenant=tenant)
        hj, ht = jc._op_header(**fields), tc._op_header(**fields)
        assert ("tenant" in ht) == (tenant is not None)
        assert framed(jrpc, hj) == framed(trpc, ht)

    def test_every_solve_frame_carries_the_tenant(self, fleet_server, small_items,
                                                  monkeypatch):  # noqa: F811
        sent = []
        send = trpc._send_frame

        def recording(sock, header, tensors=()):
            if str(header.get("op", "")).startswith("solve"):
                sent.append(header.get("tenant"))
            return send(sock, header, tensors)

        monkeypatch.setattr(trpc, "_send_frame", recording)
        pool = TNodePool("default")
        for tenant in ("cluster-7", None):
            client, solver = port_tenant(fleet_server, tenant)
            solver.solve(pool, small_items["torch"], tenant_pods("torch", 0))
            client.close()
        assert sent and set(sent) == {"cluster-7", None}
        assert sent.index(None) == len(sent) - sent[::-1].index("cluster-7")

    def test_jax_tenants_on_the_port_server(self, fleet_server, small_items,
                                            host_sigs):  # noqa: F811
        ok0 = tmetrics.TENANT_DISPATCHES.value(tenant="jax-0", outcome="ok")
        clients = [jrpc.SolverClient(path=fleet_server.path, tenant=f"jax-{i}",
                                     track_transport=False, timeout=120.0, connect_timeout=5.0)
                   for i in range(2)]
        try:
            pool = JNodePool("default")
            got = {i: decision_sig(TPUSolver(g_max=G, client=c, breaker=False).solve(
                pool, small_items["jax"], tenant_pods("jax", i))) for i, c in enumerate(clients)}
            doc = clients[0].debug_info()["coalescer"]
        finally:
            for c in clients:
                c.close()
        assert got == {i: host_sigs[i] for i in range(2)}
        assert sorted(doc["tenants"]) == ["jax-0", "jax-1"]
        wait_for(lambda: tmetrics.TENANT_DISPATCHES.value(tenant="jax-0", outcome="ok") > ok0)

    def test_port_tenants_on_the_jax_server(self, sockdir, small_items, host_sigs):  # noqa: F811
        srv = jrpc.SolverServer(path=os.path.join(sockdir, "jaxco.sock"),
                                coalescer=jcoalesce.DispatchCoalescer()).start()
        ok0 = jmetrics.TENANT_DISPATCHES.value(tenant="port-0", outcome="ok")
        try:
            tenants = [port_tenant(srv, f"port-{i}") for i in range(2)]
            assert "coalesce" in tenants[0][0].features()
            pool = TNodePool("default")
            got = {i: decision_sig(s.solve(pool, small_items["torch"], tenant_pods("torch", i)))
                   for i, (_, s) in enumerate(tenants)}
            doc = tenants[0][0].debug_info()["coalescer"]
            for client, _ in tenants:
                client.close()
        finally:
            stop_server(srv)
        assert got == {i: host_sigs[i] for i in range(2)}
        assert sorted(doc["tenants"]) == ["port-0", "port-1"]
        assert jmetrics.TENANT_DISPATCHES.value(tenant="port-0", outcome="ok") > ok0


# -- one sick tenant never poisons another --------------------------------------------


class TestTenantChaos:
    def test_dispatch_fault_isolates_to_one_tenant(self, fleet_server, small_items,
                                                   host_sigs):  # noqa: F811
        """fleet.dispatch armed once: the first dispatch dies; that
        tenant's solve takes its in-process rung, the other's runs clean
        on the wire; the fault is counted once."""
        pool = TNodePool("default")
        tenants = ("chaos-0", "chaos-1")
        err0 = sum(tmetrics.TENANT_DISPATCHES.value(tenant=t, outcome="error") for t in tenants)
        rung0 = rung_count()
        tfailpoints.FAILPOINTS.arm("fleet.dispatch", "error", "ConnectionError", times=1)
        try:
            got = {}
            for i, t in enumerate(tenants):
                client, solver = port_tenant(fleet_server, t)
                got[i] = decision_sig(solver.solve(pool, small_items["torch"],
                                                   tenant_pods("torch", i)))
                client.close()
            fires = tfailpoints.FAILPOINTS.fires("fleet.dispatch")
        finally:
            tfailpoints.FAILPOINTS.reset()
        assert got == {i: host_sigs[i] for i in range(2)}
        assert fires == 1
        assert rung_count() - rung0 == 1
        assert sum(tmetrics.TENANT_DISPATCHES.value(tenant=t, outcome="error")
                   for t in tenants) - err0 == 1

    def test_one_tenant_corrupt_frame_no_cross_drift(self, fleet_server, small_items,
                                                     host_sigs):  # noqa: F811
        """rpc.frame.corrupt armed once: the corrupted tenant's stream
        dies (crc-detected) and its ladder recovers; the other tenant's
        decision is untouched."""
        pool = TNodePool("default")
        tfailpoints.FAILPOINTS.arm("rpc.frame.corrupt", "corrupt", times=1)
        try:
            got = {}
            for i in range(2):
                client, solver = port_tenant(fleet_server, f"crc-{i}")
                got[i] = decision_sig(solver.solve(pool, small_items["torch"],
                                                   tenant_pods("torch", i)))
                client.close()
            fires = tfailpoints.FAILPOINTS.fires("rpc.frame.corrupt")
        finally:
            tfailpoints.FAILPOINTS.reset()
        assert got == {i: host_sigs[i] for i in range(2)}
        assert fires == 1

    def test_tenant_breaker_refusal_feeds_client_ladder(self, fleet_server, small_items,
                                                        host_sigs):  # noqa: F811
        """Four dispatch faults trip cluster-X's breaker (one coalesced
        dispatch a solve); the fifth solve is refused at the sidecar
        without a dispatch; every solve lands on the client's in-process
        rung with the JAX decision; a neighbour solves on the wire."""
        pool, items = TNodePool("default"), small_items["torch"]
        before = tenant_metrics(tmetrics, ("cluster-X", "cluster-Y"))
        rung0 = rung_count()
        client, solver = port_tenant(fleet_server, "cluster-X")
        tfailpoints.FAILPOINTS.arm("fleet.dispatch", "error", "ConnectionError", times=4)
        try:
            got = [decision_sig(solver.solve(pool, items, tenant_pods("torch", 0)))
                   for _ in range(5)]
        finally:
            tfailpoints.FAILPOINTS.reset()
            client.close()
        neighbour, nsolver = port_tenant(fleet_server, "cluster-Y")
        try:
            ngot = decision_sig(nsolver.solve(pool, items, tenant_pods("torch", 1)))
            wait_for(lambda: tmetrics.TENANT_DISPATCHES.value(
                tenant="cluster-Y", outcome="ok") > before["dispatches cluster-Y ok"])
        finally:
            neighbour.close()
        assert got == [host_sigs[0]] * 5 and ngot == host_sigs[1]
        assert rung_count() - rung0 == 5
        m = moved(tenant_metrics(tmetrics, ("cluster-X", "cluster-Y")), before)
        m.pop("windows")
        assert {k: (v[0] if isinstance(v, tuple) else v) for k, v in m.items()} == {
            "dispatches cluster-X error": 4, "trips cluster-X": 1,
            "refusals cluster-X breaker-open": 1, "dispatch seconds cluster-X": 4,
            "dispatches cluster-Y ok": 1, "dispatch seconds cluster-Y": 1}
        assert tmetrics.TENANT_BREAKER_STATE.value(tenant="cluster-X") == 1.0
        assert fleet_server._coalescer.tenant_open("cluster-X")
        assert not fleet_server._coalescer.tenant_open("cluster-Y")


# -- fleet sizing: tests/test_packing.py's TestFleetSizing on the port --------------------


class _FakeLedgerSolver:
    def __init__(self, kinds):
        self._kinds = kinds

    def staged_bytes_by_kind(self):
        if isinstance(self._kinds, Exception):
            raise self._kinds
        return dict(self._kinds)


class TestFleetSizing:
    def test_fallback_without_solver_or_ledger(self):
        fb = tservice.TENANT_STAGED_BYTES_FALLBACK
        assert tservice.tenant_staged_bytes(None) == fb
        assert tservice.tenant_staged_bytes(_FakeLedgerSolver({})) == fb
        assert tservice.tenant_staged_bytes(_FakeLedgerSolver(RuntimeError("no ledger"))) == fb

    def test_live_ledger_doubles_resident_bytes(self):
        mb = 1024 * 1024
        s = _FakeLedgerSolver({"catalog": 4 * mb, "class_masks": 1 * mb,
                               "solve_temporaries": 1 * mb,
                               "class_masks_full_equiv": 8 * mb})
        # full_equiv is a reference figure, not resident -- excluded
        assert tservice.tenant_staged_bytes(s) == 2 * 6 * mb

    def test_live_measurement_never_undercuts_fallback(self):
        s = _FakeLedgerSolver({"catalog": 1024, "class_masks": 512})
        assert tservice.tenant_staged_bytes(s) == tservice.TENANT_STAGED_BYTES_FALLBACK

    def test_headroom_arithmetic(self):
        mb = 1024 * 1024
        assert tservice.max_tenants_for_headroom(
            headroom_bytes=128 * mb, per_tenant_bytes=4 * mb, reserve_fraction=0.5) == 16
        assert tservice.max_tenants_for_headroom(
            headroom_bytes=128 * mb, per_tenant_bytes=4 * mb, reserve_fraction=0.0) == 32
        # headroom below one tenant clamps to zero, never negative
        assert tservice.max_tenants_for_headroom(
            headroom_bytes=1 * mb, per_tenant_bytes=4 * mb) == 0

    def test_headroom_sized_from_live_solver(self):
        mb = 1024 * 1024
        s = _FakeLedgerSolver({"catalog": 6 * mb, "class_masks": 2 * mb})
        # per-tenant = 2 * 8 MB; usable = 256 MB / 2 -> 8 tenants
        assert tservice.max_tenants_for_headroom(headroom_bytes=256 * mb, solver=s) == 8

    def test_real_solver_ledger_feeds_sizing(self, port_items):  # noqa: F811
        """End to end: a real solve's ledger drives the sizing -- the
        result is at least the fallback floor and finite."""
        s = TorchSolver(g_max=G, device="cpu")
        s.solve(TNodePool("default"), port_items, mixed_pods("torch", 31, 40, 31))
        per = tservice.tenant_staged_bytes(s)
        assert per >= tservice.TENANT_STAGED_BYTES_FALLBACK
        n = tservice.max_tenants_for_headroom(
            headroom_bytes=64 * tservice.TENANT_STAGED_BYTES_FALLBACK, solver=s)
        assert 0 < n <= 32

    def test_headroom_from_the_device_ledger(self):
        """With no explicit headroom the device ledger (obs/hbm.poll)
        decides: None where no device was polled (the CPU), the
        tightest device's free bytes otherwise."""
        mb = 1024 * 1024
        thbm.set_stats_provider(lambda: None)
        try:
            assert tservice.max_tenants_for_headroom(per_tenant_bytes=4 * mb) is None
            thbm.set_stats_provider(lambda: {
                "cuda:0": {"bytes_in_use": 16 * mb, "bytes_limit": 144 * mb},
                "cuda:1": {"bytes_in_use": 64 * mb, "bytes_limit": 144 * mb}})
            assert tservice.max_tenants_for_headroom(per_tenant_bytes=4 * mb) == 10
            # with a mesh engine only its primary (where the port stages)
            # sizes; a label the ledger lacks falls back to every device
            for dev, want in (("cuda:0", 16), ("cuda:1", 10), ("cpu", 10)):
                engine = types.SimpleNamespace(topology=object(), device=torch.device(dev))
                assert tservice.max_tenants_for_headroom(
                    per_tenant_bytes=4 * mb, engine=engine) == want
        finally:
            thbm.set_stats_provider(None)


# -- the storm corpus: N tenants through one sidecar --------------------------------------


class TestFleetReplay:
    def test_storm_digests_equal_pinned_and_isolated(self):
        res = tsimfleet.replay_fleet(3, device="cpu")
        with open(REPO / "tests/golden/scenarios/multi-cluster-storm.digests.json") as f:
            golden = json.load(f)
        assert res.ok, res.divergences
        assert res.digests == golden
        assert {t: r.digest for t, r in res.isolated.items()} == golden

    def test_cli_fleet_verb_reads_the_pinned_file(self, tmp_path, monkeypatch, capsys):
        from karpenter_tpu_torch.sim import cli

        golden = REPO / "tests/golden/scenarios/multi-cluster-storm.digests.json"
        want = json.loads(golden.read_text())
        (tmp_path / "multi-cluster-storm.digests.json").write_text(
            json.dumps({"cluster-0": "0" * 64}))
        monkeypatch.setattr(tsimfleet, "replay_fleet", lambda n, base_seed, mesh, device: types.
                            SimpleNamespace(ok=True, divergences=[],
                                            digests={"cluster-0": want["cluster-0"]}))
        rc = cli.main(["fleet", "--tenants", "1", "--device", "cpu", "--dir", str(tmp_path)])
        out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert rc == 1 and not out["ok"]
        assert out["fleet"]["drift"] == {"cluster-0": {"golden": "0" * 64,
                                                       "got": want["cluster-0"]}}
        # read, never written
        assert json.loads((tmp_path / "multi-cluster-storm.digests.json").read_text()) == {
            "cluster-0": "0" * 64}
        with pytest.raises(SystemExit):
            cli.main(["fleet", "--update-digests"])


# -- the mesh's entries into the fleet ------------------------------------------------------


def cpu_engine(n=8):
    from karpenter_tpu_torch.fleet.shard import MeshSolveEngine
    from karpenter_tpu_torch.parallel.mesh import make_mesh

    return MeshSolveEngine(make_mesh(n, devices=[torch.device("cpu")] * n))


class TestNoMesh:
    """Where a mesh enters the fleet: a mesh object builds a sharded
    sidecar; a spec counts real devices (one CPU here) and an oversized
    one is refused, never shrunk or ignored."""

    def test_build_fleet_server_refuses_a_mesh(self, sockdir, monkeypatch):
        monkeypatch.delenv(tservice.MESH_ENV, raising=False)
        with pytest.raises(ValueError, match="needs 2 devices; 1 cpu available"):
            tservice.build_fleet_server(path=os.path.join(sockdir, "m.sock"), mesh="2",
                                        device="cpu")
        # a mesh of 8 shards on the CPU is a sharded coalescing sidecar
        srv = tservice.build_fleet_server(path=os.path.join(sockdir, "m.sock"),
                                          mesh=cpu_engine())
        try:
            assert srv._mesh is not None and srv._mesh.describe()["devices"] == 8
            assert srv._coalescer is not None and srv.device == torch.device("cpu")
        finally:
            stop_server(srv)

    def test_mesh_env_is_refused_not_ignored(self, sockdir, monkeypatch):
        monkeypatch.setenv(tservice.MESH_ENV, "2x4")
        with pytest.raises(ValueError, match="needs 8 devices; 1 cpu available"):
            tservice.build_fleet_server(path=os.path.join(sockdir, "m.sock"), device="cpu")
        # an explicit falsy mesh pins the single-device path, as in the JAX package
        srv = tservice.build_fleet_server(path=os.path.join(sockdir, "m.sock"), mesh=False,
                                          device="cpu")
        assert srv._mesh is None
        stop_server(srv)

    def test_server_sizing_and_replay_refuse_a_mesh(self, sockdir):
        engine = cpu_engine()
        srv = trpc.SolverServer(path=os.path.join(sockdir, "m2.sock"), mesh=engine).start()
        stop_server(srv)
        with pytest.raises(ValueError, match="primary device"):
            trpc.SolverServer(path=os.path.join(sockdir, "m3.sock"), device="cuda",
                              mesh=engine)
        # topology-aware sizing: the port stages each tenant whole on the
        # primary, so a non-primary loss leaves the sizing unchanged
        full = tservice.max_tenants_for_headroom(headroom_bytes=1 << 30, engine=engine,
                                                 per_tenant_bytes=None)
        assert engine.mark_device_lost(7, reason="test")
        shrunk = tservice.max_tenants_for_headroom(headroom_bytes=1 << 30, engine=engine)
        assert full == (1 << 29) // tservice.TENANT_STAGED_BYTES_FALLBACK
        assert shrunk == full
        res = tsimfleet.replay_fleet(1, mesh=True, device="cpu")
        assert res.ok and res.digests == {
            t: r.digest for t, r in res.isolated.items()}

    @pytest.mark.parametrize("argv,env", [(["--mesh", "2"], None), ([], "2x4")])
    def test_binary_refuses_a_mesh(self, argv, env, monkeypatch, capsys):
        """More shards than real devices: exit 2, naming the count."""
        if env is None:
            monkeypatch.delenv(tservice.MESH_ENV, raising=False)
        else:
            monkeypatch.setenv(tservice.MESH_ENV, env)
        with pytest.raises(SystemExit) as e:
            trpc.serve_main([*argv, "--device", "cpu", "--socket", "/nonexistent/s.sock"])
        assert e.value.code == 2
        assert "1 cpu available" in capsys.readouterr().err
