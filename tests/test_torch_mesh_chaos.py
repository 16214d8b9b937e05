"""The port's mesh degrade ladder (fleet/topology.py, fleet/straggler.py) against the JAX package's, on the CPU.

Mirrors tests/test_mesh_chaos.py. The ladder

    full mesh -> shrunk mesh -> unsharded single-device
              -> wire breaker -> in process on the client's device

must leave every decision unchanged. Held here:

- every rung equal to the host, on the flat 8-shard and the 2x4 layout,
  and re-promotion handing back the ORIGINAL mesh object;
- at every rung (8, 4, 2, unsharded) the port's engine equal to the JAX
  engine walked through the same losses: the fused buffer, the repack
  and the replacement search byte for byte, the bound's totals byte
  equal to the port's unsharded bound and within test_torch_quality's
  rel 1e-6 of the JAX mesh's (the port sums in float64 and rounds once);
- epochs monotonic and stamped, a stale epoch fenced as the typed rung;
- the drills, each moving the `karpenter_mesh_*` counters as the JAX
  package's drill moves its own: `mesh.device.lost` mid-dispatch
  (classified, quarantined, one restage), `mesh.restage` (descends to
  unsharded), the straggler watchdog's escalation ladder under one fake
  clock in both packages, and a quarantined solve equal to the host;
- the device-error classifier on the JAX patterns and the CUDA runtime's
  device-loss texts, never on a program fault;
- the staging races: an evicted entry restages under the NEW epoch, and a
  mid-flight epoch bump resolves in one server-side restage;
- the committed mesh-device-loss scenario through the port's `mesh`
  replay backend equal to its pinned digest;
- a seeded chaos soak of the port's operator behind a mesh sidecar: zero
  pods lost, no double launch, re-promotion at the end.
"""
import json
import os
import shutil
import tempfile

import numpy as np
import pytest

import jax
import torch

from karpenter_tpu import metrics as jmetrics
from karpenter_tpu.apis import NodePool as JNodePool
from karpenter_tpu.failpoints import FAILPOINTS as JFAILPOINTS
from karpenter_tpu.fleet import topology as jtopology
from karpenter_tpu.fleet.shard import MeshSolveEngine as JEngine
from karpenter_tpu.fleet.straggler import ShardStragglerWatchdog as JWatchdog
from karpenter_tpu.parallel.mesh import make_mesh as jmake_mesh
from karpenter_tpu.solver import encode as jencode
from karpenter_tpu.solver import ffd as jffd
from karpenter_tpu.solver.service import TPUSolver
from karpenter_tpu_torch import metrics as tmetrics
from karpenter_tpu_torch.apis import NodePool as TNodePool
from karpenter_tpu_torch.failpoints import FAILPOINTS as TFAILPOINTS
from karpenter_tpu_torch.fleet import topology as ttopology
from karpenter_tpu_torch.fleet.shard import MeshSolveEngine as TEngine
from karpenter_tpu_torch.fleet.straggler import ShardStragglerWatchdog as TWatchdog
from karpenter_tpu_torch.obs import hbm as thbm
from karpenter_tpu_torch.parallel import mesh as tmesh
from karpenter_tpu_torch.solver import bound as tbound
from karpenter_tpu_torch.solver import encode as tencode
from karpenter_tpu_torch.solver import ffd as tffd
from karpenter_tpu_torch.solver import rpc as trpc
from karpenter_tpu_torch.solver.service import TorchSolver
from tests.test_fleet import mixed_pods
from tests.test_packing import catalog_items  # noqa: F401
from tests.test_torch_catalog import decision_sig, port_items  # noqa: F401
from tests.test_torch_ffd import port_inputs
from tests.test_torch_mesh import CPU8, host, port_mixed_pods

# small tensors: one intra-op thread per test worker (several workers share the cores)
torch.set_num_threads(1)

G = 64
JOIN_S = 10.0
GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden", "scenarios")


def need_mesh():
    if len(jax.devices()) < 8:
        pytest.skip("needs the 8-device virtual mesh (tests/conftest.py)")


@pytest.fixture(params=["1d", "2x4"])
def fresh_engine(request):
    """Function-scoped: these tests MUTATE topology, so each gets its own
    ledger."""
    mesh = (tmesh.make_mesh(8, devices=CPU8) if request.param == "1d"
            else tmesh.make_mesh_2d(2, 4, devices=CPU8))
    return TEngine(mesh)


@pytest.fixture
def reset_failpoints():
    yield
    TFAILPOINTS.reset()
    JFAILPOINTS.reset()


MESH_COUNTERS = (
    ("MESH_RESHARDS", "reason", ("full", "shrunk", "unsharded", "restage-failed")),
    ("MESH_STALE_SOLVES", "site", ("fused", "fetch", "server-restage", "client-sync",
                                   "client-wire")),
    ("MESH_TOPOLOGY_TRANSITIONS", "kind", ("device-lost", "device-returned")),
    ("MESH_SHARD_WATCHDOG", "stage", ("cancel", "quarantine", "breaker-open", "crash")),
    ("HANDLED_ERRORS", "site", ("mesh.reshard",)),
)


def counters(m) -> dict:
    out = {}
    for fam, label, values in MESH_COUNTERS:
        for v in values:
            out[f"{fam}{{{v}}}"] = getattr(m, fam).value(**{label: v})
    return out


def moved(after: dict, before: dict) -> dict:
    return {k: after[k] - before[k] for k in after if after[k] != before[k]}


# -- the ladder against the host -------------------------------------------------------


class TestDegradeLadderBitIdentity:
    def test_every_rung_matches_host(self, fresh_engine, catalog_items,  # noqa: F811
                                     port_items):  # noqa: F811
        jpods = mixed_pods(np.random.default_rng(41), 60, salt=600)
        tpods = port_mixed_pods(np.random.default_rng(41), 60, salt=600)
        want = decision_sig(TPUSolver(g_max=G).solve(JNodePool("default"), catalog_items, jpods))
        meshy = TorchSolver(g_max=G, mesh=fresh_engine)
        full_mesh = fresh_engine.mesh

        def tick():
            return decision_sig(meshy.solve(TNodePool("default"), port_items, list(tpods)))

        assert fresh_engine.topology.mode() == "full" and tick() == want
        # rung 1: shrunk -- the flat layout keeps the pow2 prefix (4); on
        # 2x4 the row holding device 7 leaves whole and one row cannot
        # stand alone, so 2D collapses to the flat fallback
        assert fresh_engine.mark_device_lost(7, reason="test")
        assert tick() == want
        assert fresh_engine.mesh is not None and fresh_engine.mesh.size == 4
        # rung 2: unsharded -- all but one device lost
        for idx in range(1, 7):
            fresh_engine.mark_device_lost(idx, reason="test")
        assert tick() == want
        assert fresh_engine.topology.mode() == "unsharded" and fresh_engine.mesh is None
        # re-promotion: the ORIGINAL mesh object comes back
        for idx in (7, *range(1, 7)):
            assert fresh_engine.mark_device_returned(idx)
        assert tick() == want
        assert fresh_engine.topology.mode() == "full" and fresh_engine.mesh is full_mesh

    def test_every_rung_matches_the_jax_mesh(self, catalog_items):  # noqa: F811
        """Both engines walked 8 -> 4 -> 2 -> unsharded through the same
        losses, the entries compared at each rung."""
        need_mesh()
        jeng, teng = JEngine(jmake_mesh(8)), TEngine(tmesh.make_mesh(8, devices=CPU8))
        catalog = jencode.encode_catalog(catalog_items, k_pad=640)
        pods = mixed_pods(np.random.default_rng(43), 70, salt=610)
        classes = jencode.group_pods(pods, extra_requirements=JNodePool("default").requirements())
        cs = jencode.encode_classes(classes, catalog, c_pad=32)
        jinp, offsets, words = jffd.make_inputs(catalog, cs)
        tinp, _, _ = port_inputs(catalog, cs, packed=True)
        nnz = jffd.nnz_budget(cs.c_pad, G)
        kw = dict(g_max=G, nnz_max=nnz, word_offsets=offsets, words=words, objective="price")
        rng = np.random.default_rng(44)
        N, C, S, R = 16, 8, 16, jencode.R
        repack = (rng.integers(0, 9000, (N, R)).astype(np.float32), rng.random((C, N)) < 0.8,
                  rng.integers(1, 600, (C, R)).astype(np.float32),
                  rng.integers(0, 6, (S, C)).astype(np.int32), rng.random((S, N)) < 0.2)
        compat = rng.random((C, 640)) < 0.7
        azone = rng.random((C, catalog.tzone.shape[1])) < 0.8
        acap = np.ones((C, catalog.tcap.shape[1]), dtype=bool)
        ovh = np.zeros((R,), np.float32)
        placed = cs.count.astype(np.float32)
        t_unsharded = host(tbound.fractional_price_bound(
            tinp, torch.from_numpy(placed), word_offsets=offsets, words=words))
        rungs = []
        for lose in ((), (7,), (2, 3, 4, 5, 6), (1,)):
            for idx in lose:
                assert jeng.mark_device_lost(idx, reason="test")
                assert teng.mark_device_lost(idx, reason="test")
            jf = np.asarray(jeng.solve_fused(jinp, **kw))
            tf = teng.fetch(teng.solve_fused(tinp, **kw))
            assert jf.tobytes() == tf.tobytes(), lose
            jb = np.asarray(jeng.price_bound(jinp, placed, word_offsets=offsets, words=words))
            tb = host(teng.price_bound(tinp, placed, word_offsets=offsets, words=words))
            assert tb.tobytes() == t_unsharded.tobytes()
            np.testing.assert_allclose(tb, jb, rtol=1e-6, atol=0)
            jl, jt = jeng.repack(*repack)
            tl, tt = teng.repack(*repack)
            assert np.asarray(jl).tobytes() == host(tl).tobytes()
            assert np.asarray(jt).tobytes() == host(tt).tobytes()
            jr = jeng.replace(np.asarray(jl), repack[2], compat, azone, acap, catalog.cap, ovh,
                              catalog.price, od_col=1)
            tr = teng.replace(tl, torch.from_numpy(repack[2]), torch.from_numpy(compat),
                              torch.from_numpy(azone), torch.from_numpy(acap),
                              torch.from_numpy(catalog.cap.copy()), torch.from_numpy(ovh),
                              torch.from_numpy(catalog.price.copy()), od_col=1)
            for a, b in zip(jr, tr):
                assert np.asarray(a).tobytes() == host(b).tobytes()
            rungs.append((jeng.describe()["devices"], teng.describe()["devices"],
                          teng.epoch == jeng.epoch))
        assert rungs == [(8, 8, True), (4, 4, True), (2, 2, True), (1, 1, True)]

    def test_epoch_monotonic_and_stamped(self, fresh_engine, port_items):  # noqa: F811
        e0 = fresh_engine.epoch
        assert fresh_engine.mark_device_lost(6, reason="test")
        assert fresh_engine.epoch == e0 + 1
        assert not fresh_engine.mark_device_lost(6, reason="test")  # idempotent
        assert fresh_engine.epoch == e0 + 1
        catalog = tencode.encode_catalog(port_items, k_pad=640)
        _, _, _, tepoch = fresh_engine.stage_catalog_versioned(catalog)
        assert tepoch == fresh_engine.epoch
        assert fresh_engine.mark_device_returned(6)
        assert fresh_engine.epoch == e0 + 2
        assert tmetrics.MESH_TOPOLOGY_EPOCH.value() == fresh_engine.epoch

    def test_stale_epoch_dispatch_fences(self, fresh_engine, port_items):  # noqa: F811
        catalog = tencode.encode_catalog(port_items, k_pad=640)
        staged, offsets, words, tepoch = fresh_engine.stage_catalog_versioned(catalog)
        classes = tencode.group_pods(port_mixed_pods(np.random.default_rng(43), 20, salt=610))
        cs = tencode.encode_classes(classes, catalog)
        inp = tffd.make_inputs_staged(staged, cs, packed_masks=True)
        nnz = tffd.nnz_budget(cs.c_pad, 32)
        fresh_engine.mark_device_lost(5, reason="test")
        before = tmetrics.MESH_STALE_SOLVES.value(site="fused")
        with pytest.raises(trpc.StaleTopologyError):
            fresh_engine.solve_fused(inp, g_max=32, nnz_max=nnz, word_offsets=offsets,
                                     words=words, epoch=tepoch)
        assert tmetrics.MESH_STALE_SOLVES.value(site="fused") == before + 1
        assert isinstance(trpc.StaleTopologyError("x"), trpc.StaleSeqnumError)
        # the fetch fences a buffer of an old epoch before any read
        with pytest.raises(trpc.StaleTopologyError):
            fresh_engine.fetch(torch.zeros(4, dtype=torch.int32), epoch=tepoch)


# -- the drills --------------------------------------------------------------------------


class TestDrills:
    def test_device_lost_mid_dispatch(self, catalog_items, port_items,  # noqa: F811
                                      reset_failpoints):
        """`mesh.device.lost` fires once inside a tick's dispatch in both
        packages: classified, the highest healthy device quarantined,
        one restage onto the survivors, the decision unchanged, and the
        same counters moved by the same amounts."""
        need_mesh()
        jpods = mixed_pods(np.random.default_rng(45), 50, salt=650)
        tpods = port_mixed_pods(np.random.default_rng(45), 50, salt=650)
        jeng, teng = JEngine(jmake_mesh(8)), TEngine(tmesh.make_mesh(8, devices=CPU8))
        js, ts = TPUSolver(g_max=G, mesh=jeng), TorchSolver(g_max=G, mesh=teng)
        js.solve(JNodePool("default"), catalog_items, list(jpods))
        ts.solve(TNodePool("default"), port_items, list(tpods))
        j0, t0 = counters(jmetrics), counters(tmetrics)
        jf0 = jmetrics.SOLVER_PIPELINE_FALLBACKS.value(reason="stale-topology")
        tf0 = tmetrics.SOLVER_PIPELINE_FALLBACKS.value(reason="stale-topology")
        JFAILPOINTS.arm("mesh.device.lost", "error", "RuntimeError", times=1)
        TFAILPOINTS.arm("mesh.device.lost", "error", "RuntimeError", times=1)
        want = decision_sig(js.solve(JNodePool("default"), catalog_items, list(jpods)))
        got = decision_sig(ts.solve(TNodePool("default"), port_items, list(tpods)))
        assert got == want
        assert TFAILPOINTS.fires("mesh.device.lost") == JFAILPOINTS.fires("mesh.device.lost") == 1
        assert moved(counters(tmetrics), t0) == moved(counters(jmetrics), j0)
        assert moved(counters(tmetrics), t0) == {
            "MESH_STALE_SOLVES{fused}": 1, "MESH_TOPOLOGY_TRANSITIONS{device-lost}": 1,
            "MESH_RESHARDS{shrunk}": 1}
        assert (tmetrics.SOLVER_PIPELINE_FALLBACKS.value(reason="stale-topology") - tf0
                == jmetrics.SOLVER_PIPELINE_FALLBACKS.value(reason="stale-topology") - jf0 == 1)
        assert teng.topology.quarantined() == jeng.topology.quarantined() == {
            7: "mesh.device.lost"}
        assert teng.describe()["devices"] == 4

    def test_restage_failure_descends_to_unsharded(self, catalog_items, port_items,  # noqa: F811
                                                   reset_failpoints):
        need_mesh()
        jpods = mixed_pods(np.random.default_rng(46), 40, salt=660)
        tpods = port_mixed_pods(np.random.default_rng(46), 40, salt=660)
        jeng, teng = JEngine(jmake_mesh(8)), TEngine(tmesh.make_mesh(8, devices=CPU8))
        j0, t0 = counters(jmetrics), counters(tmetrics)
        for eng, fp in ((jeng, JFAILPOINTS), (teng, TFAILPOINTS)):
            fp.arm("mesh.restage", "error", "RuntimeError", times=1)
            assert eng.mark_device_lost(6, reason="chaos")
        want = decision_sig(TPUSolver(g_max=G, mesh=jeng).solve(
            JNodePool("default"), catalog_items, list(jpods)))
        got = decision_sig(TorchSolver(g_max=G, mesh=teng).solve(
            TNodePool("default"), port_items, list(tpods)))
        assert got == want
        assert teng.mesh is None and jeng.mesh is None
        assert moved(counters(tmetrics), t0) == moved(counters(jmetrics), j0)
        assert moved(counters(tmetrics), t0)["MESH_RESHARDS{restage-failed}"] == 1
        # the next membership change reshards normally again
        assert teng.mark_device_returned(6)
        TorchSolver(g_max=G, mesh=teng).solve(TNodePool("default"), port_items, list(tpods))
        assert teng.topology.mode() == "full" and teng.mesh is not None

    def test_watchdog_escalation_ladder(self):
        """Both packages' watchdogs under one fake clock: the same stages
        at the same times, the same counter moves, one quarantine."""
        need_mesh()
        out = {}
        for name, Engine, mesh, Watchdog, m in (
                ("jax", JEngine, jmake_mesh(8), JWatchdog, jmetrics),
                ("torch", TEngine, tmesh.make_mesh(8, devices=CPU8), TWatchdog, tmetrics)):
            engine = Engine(mesh)

            class _Breaker:
                opened = None

                def force_open(self, reason):
                    self.opened = reason

            cancelled, clock, breaker = [], [0.0], _Breaker()
            wd = Watchdog(budget=1.0, engine=engine, cancel=lambda: cancelled.append(1),
                          breaker=breaker, clock=lambda: clock[0])
            before = counters(m)
            e0 = engine.epoch
            wd.dispatch_started("fused")
            stages = [wd.check_now()]
            for t in (4.5, 8.5, 12.5):
                clock[0] = t
                stages.append(wd.check_now())
            wd.dispatch_finished()
            clock[0] = 100.0
            stages.append(wd.check_now())
            out[name] = (stages, engine.epoch - e0, cancelled, breaker.opened,
                         dict(wd.escalations), moved(counters(m), before),
                         engine.topology.quarantined())
        assert out["torch"] == out["jax"]
        assert out["torch"][0] == [None, "cancel", "quarantine", "breaker-open", None]
        assert out["torch"][6] == {7: "straggler"}

    def test_finished_dispatch_never_escalates(self):
        clock = [0.0]
        wd = TWatchdog(budget=0.5, clock=lambda: clock[0])
        wd.dispatch_started("compact")
        wd.dispatch_finished()
        clock[0] = 1_000.0
        assert wd.check_now() is None
        d = wd.describe()
        assert d["dispatch_active_for_s"] is None and d["budget_s"] == 0.5

    def test_quarantined_solve_stays_bit_identical(self, catalog_items,  # noqa: F811
                                                   port_items):  # noqa: F811
        engine = TEngine(tmesh.make_mesh(8, devices=CPU8))
        clock = [0.0]
        wd = TWatchdog(budget=1.0, engine=engine, clock=lambda: clock[0],
                       multiples=(1.0, 2.0, 90.0, 99.0))
        engine.attach_watchdog(wd)
        wd.dispatch_started("fused")
        clock[0] = 2.5
        wd.check_now()                     # cancel (no hook)
        assert wd.check_now() == "quarantine"
        wd.dispatch_finished()
        jpods = mixed_pods(np.random.default_rng(47), 40, salt=700)
        tpods = port_mixed_pods(np.random.default_rng(47), 40, salt=700)
        assert decision_sig(TorchSolver(g_max=G, mesh=engine).solve(
            TNodePool("default"), port_items, tpods)) == decision_sig(
            TPUSolver(g_max=G).solve(JNodePool("default"), catalog_items, jpods))
        assert engine.describe()["devices"] == 4


class TestClassifier:
    @pytest.mark.parametrize("msg", [
        "RuntimeError: injected failure at mesh.device.lost",
        "device lost", "DATA_LOSS: chip halted", "device unavailable: device 3",
        "Device or resource busy",
    ])
    def test_the_jax_patterns(self, msg):
        e = RuntimeError(msg)
        assert ttopology.classify_device_error(e) == jtopology.classify_device_error(e)
        assert ttopology.classify_device_error(e) is not None
        assert ttopology.device_index_hint(e) == jtopology.device_index_hint(e)

    @pytest.mark.parametrize("msg", [
        "CUDA error: uncorrectable ECC error encountered",
        "CUDA error: uncorrectable NVLink error was detected during the execution",
        "CUDA error: CUDA-capable device(s) is/are busy or unavailable",
        "CUDA error: no CUDA-capable device is detected",
    ])
    def test_cuda_device_loss_texts(self, msg):
        assert ttopology.classify_device_error(RuntimeError(msg)) is not None

    @pytest.mark.parametrize("msg", [
        "CUDA error: an illegal memory access was encountered",
        "CUDA error: invalid configuration argument",
        "CUDA error: device-side assert triggered",
        "CUDA error: too many resources requested for launch",
        "CUDA out of memory. Tried to allocate 2.00 GiB",
    ])
    def test_program_faults_never_shrink_the_mesh(self, msg):
        e = RuntimeError(msg)
        assert ttopology.classify_device_error(e) is None
        engine = TEngine(tmesh.make_mesh(8, devices=CPU8))

        def boom():
            raise e

        with pytest.raises(RuntimeError) as got:
            engine._dispatch("fused", None, boom)
        assert got.value is e and not isinstance(got.value, trpc.StaleSeqnumError)
        assert engine.topology.mode() == "full"


# -- staging races: eviction vs reshard ----------------------------------------------------


@pytest.fixture
def mesh_server():
    d = tempfile.mkdtemp(prefix="kt-")
    srv = trpc.SolverServer(path=os.path.join(d, "m.sock"),
                            mesh=tmesh.make_mesh(8, devices=CPU8)).start()
    yield srv
    srv.stop()
    srv._thread.join(timeout=JOIN_S)
    shutil.rmtree(d, ignore_errors=True)


@pytest.fixture
def mesh_client(mesh_server):
    c = trpc.SolverClient(path=mesh_server.path, delta=True, timeout=60.0,
                          track_transport=False)
    yield c
    c.close()


class TestStagingReshardRaces:
    def test_evicted_entry_restages_under_new_epoch(self, mesh_server, mesh_client,
                                                    port_items):  # noqa: F811
        sd = TorchSolver(g_max=G, device="cpu", client=mesh_client, breaker=False)
        host_solver = TorchSolver(g_max=G, device="cpu")
        rng = np.random.default_rng(53)
        pods = port_mixed_pods(rng, 40, salt=800)
        sd.solve(TNodePool("default"), port_items, list(pods))
        (seqnum,) = list(mesh_server._staged)
        old_epoch = mesh_server._staged[seqnum].tepoch
        engine = mesh_server._mesh
        assert engine.mark_device_lost(6, reason="test")
        try:
            thbm.set_stats_provider(lambda: {
                "cuda:0": {"bytes_in_use": 950, "bytes_limit": 1000, "peak_bytes_in_use": 950},
            })
            with mesh_server._lock:
                mesh_server._evict_for_pressure_locked()
        finally:
            thbm.set_stats_provider(None)
        pods2 = pods[:-4] + port_mixed_pods(rng, 4, salt=801)
        res = sd.solve(TNodePool("default"), port_items, list(pods2))
        assert decision_sig(res) == decision_sig(
            host_solver.solve(TNodePool("default"), port_items, list(pods2)))
        entry = mesh_server._staged[seqnum]
        assert entry.tepoch == engine.epoch and entry.tepoch != old_epoch

    def test_midflight_topology_change_resolves_in_one_restage(
            self, mesh_server, mesh_client, port_items):  # noqa: F811
        solver = TorchSolver(g_max=G, device="cpu", client=mesh_client, breaker=False)
        entry = solver._catalog(port_items)
        engine = mesh_server._mesh
        classes = tencode.group_pods(port_mixed_pods(np.random.default_rng(59), 30, salt=900))
        cs = tencode.encode_classes(classes, entry.tensors, c_pad=32)
        h = mesh_client.begin_solve_compact(entry.seqnum, entry.tensors, cs, g_max=G)
        mesh_client.finish_solve_compact(h)
        before = tmetrics.MESH_STALE_SOLVES.value(site="server-restage")
        assert engine.mark_device_lost(5, reason="test")
        cs2 = tencode.encode_classes(classes, entry.tensors, c_pad=32)
        cs2.count[0] += 1
        h2 = mesh_client.begin_solve_compact(entry.seqnum, entry.tensors, cs2, g_max=G)
        try:
            dec = mesh_client.finish_solve_compact(h2)
        except trpc.StaleSeqnumError:
            dec = mesh_client.solve_classes_compact(entry.seqnum, entry.tensors, cs2, g_max=G)
        assert int(dec.n_open) >= 0
        restages = tmetrics.MESH_STALE_SOLVES.value(site="server-restage") - before
        assert restages == 1, f"restage loop: {restages} restages for one bump"
        assert mesh_server._staged[entry.seqnum].tepoch == engine.epoch
        before2 = tmetrics.MESH_STALE_SOLVES.value(site="server-restage")
        dec2 = mesh_client.solve_classes_compact(entry.seqnum, entry.tensors, cs2, g_max=G)
        assert int(dec2.n_open) >= 0
        assert tmetrics.MESH_STALE_SOLVES.value(site="server-restage") == before2

    def test_device_lost_mid_op_surfaces_then_recovers(self, mesh_server, mesh_client,
                                                       port_items, reset_failpoints):  # noqa: F811
        """A device dies inside the sidecar's dispatch: the op's error
        reply is StaleTopologyError; the pipelined claim raises it as a
        StaleSeqnumError, the synchronous op retries it once."""
        solver = TorchSolver(g_max=G, device="cpu", client=mesh_client, breaker=False)
        entry = solver._catalog(port_items)
        classes = tencode.group_pods(port_mixed_pods(np.random.default_rng(61), 30, salt=950))
        cs = tencode.encode_classes(classes, entry.tensors, c_pad=32)
        want = mesh_client.solve_classes_compact(entry.seqnum, entry.tensors, cs, g_max=G)
        TFAILPOINTS.arm("mesh.device.lost", "error", "RuntimeError", times=1)
        h = mesh_client.begin_solve_compact(entry.seqnum, entry.tensors, cs, g_max=G)
        with pytest.raises(trpc.StaleTopologyError):
            mesh_client.finish_solve_compact(h)
        TFAILPOINTS.arm("mesh.device.lost", "error", "RuntimeError", times=1)
        before = tmetrics.MESH_STALE_SOLVES.value(site="client-sync")
        got = mesh_client.solve_classes_compact(entry.seqnum, entry.tensors, cs, g_max=G)
        assert tmetrics.MESH_STALE_SOLVES.value(site="client-sync") == before + 1
        for a, b in zip(want, got):
            assert np.asarray(a).tobytes() == np.asarray(b).tobytes()
        assert mesh_server._mesh.describe()["devices"] == 4


# -- the committed corpus scenario ---------------------------------------------------------


def test_mesh_device_loss_corpus_scenario():
    """The mesh-device-loss golden through the port's mesh backend (8
    shards of the CPU), where the device events reshard: the pinned host
    digest, byte for byte."""
    from karpenter_tpu_torch.sim.replay import replay
    from karpenter_tpu_torch.sim.trace import read_trace

    with open(os.path.join(GOLDEN_DIR, "digests.json")) as f:
        golden = json.load(f)
    events = read_trace(os.path.join(GOLDEN_DIR, "mesh-device-loss.jsonl"))
    before = tmetrics.MESH_TOPOLOGY_TRANSITIONS.value(kind="device-lost")
    res = replay(events, backend="mesh", seed=20260803, device="cpu")
    assert res.digest == golden["mesh-device-loss"]
    assert tmetrics.MESH_TOPOLOGY_TRANSITIONS.value(kind="device-lost") > before


# -- the seeded chaos soak ---------------------------------------------------------------

SIZES = [("250m", "512Mi"), ("500m", "1Gi"), ("1", "2Gi"), ("2", "4Gi")]
MESH_FAULTS = ("device_lost", "device_returned", "quarantine", "restage_fault",
               "dispatch_device_death")


def check_invariants(op):
    """tests/test_soak.py's invariants on the port's cluster: bound pods
    on live nodes, unique provider ids, no node over-committed."""
    from karpenter_tpu_torch.apis import Node, NodeClaim, Pod

    nodes = {n.metadata.name: n for n in op.cluster.list(Node)}
    for p in op.cluster.list(Pod):
        if p.node_name:
            assert p.node_name in nodes, f"pod {p.metadata.name} bound to ghost node"
    pids = [c.provider_id for c in op.cluster.list(NodeClaim) if c.provider_id]
    assert len(pids) == len(set(pids)), "duplicate provider ids across claims"
    for name, node in nodes.items():
        assert op.cluster.node_usage(name).fits(node.allocatable), f"node {name} over-committed"


@pytest.mark.parametrize("seed", range(4))
def test_mesh_chaos_schedule(seed, reset_failpoints):
    from karpenter_tpu_torch.apis import NodeClaim, NodePool, Pod, TPUNodeClass
    from karpenter_tpu_torch.cache.ttl import FakeClock
    from karpenter_tpu_torch.operator import Operator
    from karpenter_tpu_torch.scheduling import Resources
    from karpenter_tpu_torch.solver.breaker import CircuitBreaker

    rng = np.random.default_rng(7000 + seed)
    d = tempfile.mkdtemp(prefix="kt-")
    srv = trpc.SolverServer(path=os.path.join(d, "s.sock"),
                            mesh=tmesh.make_mesh(8, devices=CPU8)).start()
    client = trpc.SolverClient(path=srv.path, timeout=30.0, connect_timeout=0.25, delta=True)
    breaker = CircuitBreaker(failure_threshold=2, backoff_base=1000.0)
    solver = TorchSolver(g_max=G, device="cpu", client=client, breaker=breaker)
    op = Operator(clock=FakeClock(50_000.0), solver=solver)
    op.cluster.create(TPUNodeClass("default"))
    op.cluster.create(NodePool("default"))
    engine = srv._mesh
    seq, epochs = 0, [engine.epoch]

    def burst(n):
        nonlocal seq
        for i in range(n):
            cpu, mem = SIZES[int(rng.integers(0, len(SIZES)))]
            op.cluster.create(Pod(f"meshchaos-{seed}-{seq + i}",
                                  requests=Resources({"cpu": cpu, "memory": mem})))
        seq += n

    def settle(max_ticks=40):
        for _ in range(max_ticks):
            op.tick()
            check_invariants(op)
            if not op.cluster.pending_pods():
                return True
            op.clock.step(3.0)
        return False

    try:
        for round_i in range(3):
            fault = MESH_FAULTS[int(rng.integers(0, len(MESH_FAULTS)))]
            if fault == "device_lost":
                engine.mark_device_lost(int(rng.integers(4, 8)), reason="chaos")
            elif fault == "device_returned":
                lost = sorted(engine.topology.quarantined())
                if lost:
                    engine.mark_device_returned(lost[int(rng.integers(0, len(lost)))])
            elif fault == "quarantine":
                engine.quarantine_worst_device(reason="chaos")
            elif fault == "restage_fault":
                TFAILPOINTS.arm("mesh.restage", "error", "RuntimeError", times=1)
                healthy = engine.topology.healthy_indices()
                pool = [i for i in healthy if i >= 4] or list(healthy)
                engine.mark_device_lost(pool[int(rng.integers(0, len(pool)))], reason="chaos")
            else:
                TFAILPOINTS.arm("mesh.device.lost", "error", "RuntimeError", times=1)
            epochs.append(engine.epoch)
            burst(int(rng.integers(3, 8)))
            assert settle(), f"seed {seed} round {round_i}: never converged after {fault}"
            if fault in ("restage_fault", "dispatch_device_death"):
                site = "mesh.restage" if fault == "restage_fault" else "mesh.device.lost"
                if TFAILPOINTS.fires(site) == 0:
                    # the burst never reached the armed seam: poke the
                    # dispatch path so the drill is consumed
                    try:
                        engine._dispatch("fused", None, lambda: None)
                    except RuntimeError:
                        pass
                assert TFAILPOINTS.fires(site) >= 1
            TFAILPOINTS.reset()
        assert epochs == sorted(epochs)
        for idx in sorted(engine.topology.quarantined()):
            engine.mark_device_returned(idx)
        assert engine.topology.mode() == "full"
        burst(4)
        assert settle(), f"seed {seed}: no convergence after re-promotion"
        for _ in range(5):
            op.tick()
            op.clock.step(10.0)
        check_invariants(op)
        for p in op.cluster.list(Pod):
            assert p.node_name, f"pod {p.metadata.name} lost (never bound)"
        claimed = [c.provider_id for c in op.cluster.list(NodeClaim) if c.provider_id]
        assert len(claimed) == len(set(claimed)), "duplicate provider id: double launch"
    finally:
        TFAILPOINTS.reset()
        breaker.stop()
        client.close()
        srv.stop()
        srv._thread.join(timeout=JOIN_S)
        shutil.rmtree(d, ignore_errors=True)
