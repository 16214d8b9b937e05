"""The port's mesh (parallel/mesh.py, fleet/shard.py) against the JAX package's, on the CPU.

The JAX side is `MeshSolveEngine(make_mesh(8))` over the 8 virtual CPU
devices tests/conftest.py forces; the port's is `MeshSolveEngine(make_mesh(
8, devices=[cpu] * 8))`, eight positional shards of the CPU. They mirror
tests/test_mesh.py and tests/test_fleet.py:94-341 and hold:

- the fused, compact and dense entries and the bound's [R] totals byte
  equal to the JAX mesh's on the same encoded inputs (the JAX package's
  arrays carried over with `test_torch_ffd.port_inputs`), both
  objectives, two class buckets and a world of hundreds of classes;
- the K split at K = 640, 1,280 and 1,920 on flat, 2x4 and uneven
  meshes and the engine's unsharded rung against `DeviceEngine`;
- `repack` and `replace` equal to the JAX mesh's and `DeviceEngine`'s;
- one engine surface: `DeviceEngine` and `MeshSolveEngine` take every
  shared entry with the same parameters, and an 8-shard mesh, the mesh
  engine's unsharded rung and `DeviceEngine` agree bit for bit on each;
- whole solves, synchronous and pipelined: `TorchSolver(mesh=)` decides
  as `TPUSolver(mesh=)` and as the unsharded solver, counted;
- `parse_mesh_spec` parses specs and refuses oversized ones;
- the wire with a mesh: `SolverServer(mesh=)` equal to the host, the
  stage reply's `tepoch`, delta epochs, pressure eviction, the stale
  epoch that surfaces then recovers, the debug document;
- the consolidation evaluator with a mesh equal to without;
- `init_distributed`'s environment contract, and a 2-rank gloo world
  whose 8 shards split over two processes (the 4-rank one is gated by
  KARPENTER_TPU_MP_DRYRUN, as the JAX package's).
"""
import inspect
import os
import shutil
import tempfile

import numpy as np
import pytest

import jax
import torch

from karpenter_tpu import metrics as jmetrics
from karpenter_tpu.apis import NodePool as JNodePool, Pod as JPod
from karpenter_tpu.fleet.shard import MeshSolveEngine as JEngine
from karpenter_tpu.parallel.mesh import make_mesh as jmake_mesh
from karpenter_tpu.parallel.mesh import sharded_solve as jsharded_solve
from karpenter_tpu.scheduling import Resources as JResources
from karpenter_tpu.scheduling import resources as jres
from karpenter_tpu.solver import encode as jencode
from karpenter_tpu.solver import ffd as jffd
from karpenter_tpu.solver.service import TPUSolver
from karpenter_tpu_torch import metrics as tmetrics
from karpenter_tpu_torch.apis import NodePool as TNodePool, Pod as TPod
from karpenter_tpu_torch.fleet import shard as tshard
from karpenter_tpu_torch.fleet.shard import MeshSolveEngine as TEngine
from karpenter_tpu_torch.obs import hbm as thbm
from karpenter_tpu_torch.parallel import mesh as tmesh
from karpenter_tpu_torch.scheduling import Resources as TResources
from karpenter_tpu_torch.solver import encode as tencode
from karpenter_tpu_torch.solver import ffd as tffd
from karpenter_tpu_torch.solver import rpc as trpc
from karpenter_tpu_torch.solver.device_engine import DeviceEngine
from karpenter_tpu_torch.solver.disrupt import kernel as tdk
from karpenter_tpu_torch.solver.service import TorchSolver
from tests.test_fleet import mixed_pods
from tests.test_packing import catalog_items  # noqa: F401
from tests.test_torch_catalog import decision_sig, port_churn_pods, port_items  # noqa: F401
from tests.test_torch_ffd import port_inputs

# small tensors: one intra-op thread per test worker (several workers share the cores)
torch.set_num_threads(1)

G = 64
JOIN_S = 10.0
CPU8 = [torch.device("cpu")] * 8


def need_mesh():
    if len(jax.devices()) < 8:
        pytest.skip("needs the 8-device virtual mesh (tests/conftest.py)")


def port_mixed_pods(rng: np.random.Generator, n: int, salt: int = 0):
    """tests/test_fleet.py mixed_pods with the port's types: the same
    draws give the same pods."""
    pods = port_churn_pods(rng, 0, n)
    for i, p in enumerate(pods):
        p.metadata.name = f"fleet-{salt}-{i}"
    return pods


def both_pods(seed: int, n: int, salt: int = 0):
    return (mixed_pods(np.random.default_rng(seed), n, salt=salt),
            port_mixed_pods(np.random.default_rng(seed), n, salt=salt))


@pytest.fixture(scope="module")
def jengine():
    need_mesh()
    return JEngine(jmake_mesh(8))


@pytest.fixture(scope="module")
def tengine():
    return TEngine(tmesh.make_mesh(8, devices=CPU8))


def unsharded_engine():
    """An 8-shard engine walked down its degrade ladder to the unsharded
    rung: devices 1-7 lost (it reshards at its next dispatch)."""
    engine = TEngine(tmesh.make_mesh(8, devices=CPU8))
    for i in range(1, 8):
        engine.mark_device_lost(i, "test")
    return engine


def port_world(port_items, k_pad=640, seed=None):  # noqa: F811
    """(SolveInputs, offsets, words, class set) of 90 mixed pods on the
    port's catalog, staged on the CPU."""
    catalog = tencode.encode_catalog(port_items, k_pad=k_pad)
    pods = port_mixed_pods(np.random.default_rng(k_pad if seed is None else seed), 90)
    classes = tencode.group_pods(pods, extra_requirements=TNodePool("default").requirements())
    cs = tencode.encode_classes(classes, catalog, c_pad=32)
    staged, offsets, words = tffd.stage_catalog(catalog, "cpu")
    return tffd.make_inputs_staged(staged, cs, packed_masks=True), offsets, words, cs


def encoded_world(catalog_items, seed, n, *, c_pad=None, k_pad=640):  # noqa: F811
    catalog = jencode.encode_catalog(catalog_items, k_pad=k_pad)
    pods = mixed_pods(np.random.default_rng(seed), n)
    classes = jencode.group_pods(pods, extra_requirements=JNodePool("default").requirements())
    cs = jencode.encode_classes(classes, catalog, c_pad=c_pad)
    return catalog, cs


def host(x):
    return np.asarray(x.cpu().numpy() if isinstance(x, torch.Tensor) else x)


def assert_tree_equal(want, got, names):
    for name, a, b in zip(names, want, got):
        a, b = np.asarray(a), host(b)
        if a.dtype == np.uint32:
            b = b.view(np.uint32)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert a.tobytes() == b.tobytes(), name


# -- the entries against the JAX mesh ------------------------------------------------------


class TestMeshEngineBitIdentity:
    """Raw entries: dense / compact / fused and the bound, both objectives."""

    @pytest.mark.parametrize("c_pad", [16, 64])
    @pytest.mark.parametrize("objective", ["price", "fit"])
    def test_entries_match_the_jax_mesh(self, jengine, tengine, catalog_items,  # noqa: F811
                                        objective, c_pad):
        catalog, cs = encoded_world(catalog_items, 5, 80, c_pad=c_pad)
        jinp, offsets, words = jffd.make_inputs(catalog, cs)
        tinp, _, _ = port_inputs(catalog, cs, packed=True)
        kw = dict(g_max=G, word_offsets=offsets, words=words, objective=objective)
        jd = jengine.fetch(jengine.solve_dense(jinp, **kw))
        td = tengine.fetch(tengine.solve_dense(tinp, **kw))
        assert_tree_equal(jd, td, jffd.SolveOutputs._fields)
        nnz = jffd.nnz_budget(cs.c_pad, G)
        jc = jengine.fetch(jengine.solve_compact(jinp, nnz_max=nnz, **kw))
        tc = tengine.fetch(tengine.solve_compact(tinp, nnz_max=nnz, **kw))
        assert_tree_equal(jc, tc, jffd.CompactDecision._fields)
        jf = np.asarray(jengine.solve_fused(jinp, nnz_max=nnz, **kw))
        tf = tengine.fetch(tengine.solve_fused(tinp, nnz_max=nnz, **kw))
        assert jf.dtype == tf.dtype == np.uint32 and jf.tobytes() == tf.tobytes()
        # the bound's [R] totals on the take rows the solve placed: byte
        # equal to the port's unsharded bound (the minimum over shards is
        # exact and the float64 sum runs once, after it), and to the JAX
        # mesh's within test_torch_quality's rel 1e-6 -- the port sums
        # in float64 and rounds once, the JAX entry in float32 in XLA's
        # order (solver/bound.py)
        placed = np.asarray(jd.take).sum(axis=1).astype(np.float32)
        jb = np.asarray(jengine.price_bound(jinp, placed, word_offsets=offsets, words=words))
        tb = host(tengine.price_bound(tinp, placed, word_offsets=offsets, words=words))
        t1 = host(DeviceEngine("cpu").price_bound(tinp, placed, word_offsets=offsets,
                                                  words=words))
        assert tb.tobytes() == t1.tobytes()
        np.testing.assert_allclose(tb, jb, rtol=1e-6, atol=0)

    @pytest.mark.parametrize("objective", ["price", "fit"])
    def test_hundreds_of_classes_bit_identical(self, tengine, catalog_items,  # noqa: F811
                                               objective):
        """tests/test_mesh.py's realistic shapes: 320 templates against
        the full catalog, the JAX `sharded_solve` on 8 devices."""
        need_mesh()
        rng = np.random.default_rng(99)
        catalog = jencode.encode_catalog(catalog_items)
        pods = []
        for t in range(320):
            cpu = int(rng.choice([100, 250, 500, 750, 1000, 1500, 2000, 3000, 4000])) + t % 7
            mem = int(rng.choice([128, 256, 512, 1024, 2048, 4096, 8192]))
            for i in range(int(rng.integers(1, 5))):
                pods.append(JPod(f"t{t}-{i}", requests=JResources.from_base_units(
                    {jres.CPU: float(cpu), jres.MEMORY: float(mem) * 2**20})))
        classes = jencode.group_pods(pods, extra_requirements=JNodePool("default").requirements())
        assert len(classes) >= 200
        cs = jencode.encode_classes(classes, catalog, c_pad=jencode.bucket(len(classes), 16))
        jinp, offsets, words = jffd.make_inputs(catalog, cs)
        tinp, _, _ = port_inputs(catalog, cs, packed=False)
        kw = dict(g_max=256, word_offsets=offsets, words=words, objective=objective)
        want = jsharded_solve(jmake_mesh(8), jinp, **kw)
        got = tmesh.sharded_solve(tengine.mesh, tinp, **kw)
        assert_tree_equal(want, got, jffd.SolveOutputs._fields)
        assert int(host(got.take).sum()) + int(host(got.unplaced).sum()) == len(pods)

    def test_repack_and_replace_match(self, jengine, tengine, catalog_items):  # noqa: F811
        rng = np.random.default_rng(9)
        N, C, S, R = 16, 8, 16, jencode.R
        headroom = np.zeros((N, R), dtype=np.float32)
        headroom[:, jres.AXIS_INDEX[jres.CPU]] = rng.choice([2000, 4000, 8000], N)
        headroom[:, jres.AXIS_INDEX[jres.MEMORY]] = rng.choice([4096, 8192], N)
        headroom[:, jres.AXIS_INDEX[jres.PODS]] = 110
        req = np.zeros((C, R), dtype=np.float32)
        req[:, jres.AXIS_INDEX[jres.CPU]] = rng.choice([250, 500, 1000], C)
        req[:, jres.AXIS_INDEX[jres.MEMORY]] = rng.choice([256, 1024], C)
        req[:, jres.AXIS_INDEX[jres.PODS]] = 1
        feas = rng.random((C, N)) < 0.8
        member = rng.integers(0, 6, size=(S, C)).astype(np.int32)
        excl = rng.random((S, N)) < 0.2
        jl, jt = jengine.repack(headroom, feas, req, member, excl)
        before = tmetrics.MESH_DISPATCHES.value(entry="repack")
        tl, tt = tengine.repack(headroom, feas, req, member, excl)
        assert tmetrics.MESH_DISPATCHES.value(entry="repack") == before + 1
        assert np.asarray(jl).tobytes() == host(tl).tobytes()
        assert np.asarray(jt).tobytes() == host(tt).tobytes()
        dl, dt = DeviceEngine("cpu").repack(headroom, feas, req, member, excl)
        assert torch.equal(dl, tl) and torch.equal(dt, tt)
        # the replacement search over the catalog, leftover split by sets
        catalog = jencode.encode_catalog(catalog_items, k_pad=640)
        K, Z, CT = catalog.k_pad, catalog.tzone.shape[1], catalog.tcap.shape[1]
        compat = rng.random((C, K)) < 0.7
        azone = rng.random((C, Z)) < 0.8
        acap = np.ones((C, CT), dtype=bool)
        ovh = np.zeros((R,), dtype=np.float32)
        left = np.asarray(jl)
        jout = jengine.replace(left, req, compat, azone, acap, catalog.cap, ovh, catalog.price,
                               od_col=1)

        def put(a):
            return torch.from_numpy(np.ascontiguousarray(a))

        args = (put(left), put(req), put(compat), put(azone), put(acap), put(catalog.cap),
                put(ovh), put(catalog.price))
        tout = tengine.replace(*args, od_col=1)
        dout = DeviceEngine("cpu").replace(*args, od_col=1)
        for a, b, d in zip(jout, tout, dout):
            assert np.asarray(a).tobytes() == host(b).tobytes() == host(d).tobytes()


class TestKSplit:
    """8 shards split K into blocks that are not whole words (80 columns
    at K=640): the shards' columns gather unpacked and pack once on the
    primary. Pinned at the merged catalogs' widths, flat, 2x4 and an
    uneven 3-shard mesh, and the engine's unsharded rung, against
    DeviceEngine's entries."""

    @pytest.mark.parametrize("k_pad", [640, 1280, 1920])
    @pytest.mark.parametrize("layout", ["8", "2x4", "3", "unsharded"])
    def test_fused_and_bound_equal_unsharded(self, port_items, k_pad, layout):  # noqa: F811
        engine = {"8": lambda: TEngine(tmesh.make_mesh(8, devices=CPU8)),
                  "2x4": lambda: TEngine(tmesh.make_mesh_2d(2, 4, devices=CPU8)),
                  "3": lambda: TEngine(tmesh.make_mesh(3, devices=CPU8)),
                  "unsharded": unsharded_engine}[layout]()
        inp, offsets, words, cs = port_world(port_items, k_pad)
        kw = dict(g_max=G, word_offsets=offsets, words=words, objective="price")
        nnz = tffd.nnz_budget(cs.c_pad, G)
        device = DeviceEngine("cpu")
        assert torch.equal(device.solve_fused(inp, nnz_max=nnz, **kw),
                           engine.solve_fused(inp, nnz_max=nnz, **kw))
        assert (engine.mesh is None) == (layout == "unsharded")
        placed = torch.from_numpy(cs.count.astype(np.float32))
        assert torch.equal(
            device.price_bound(inp, placed, word_offsets=offsets, words=words),
            engine.price_bound(inp, placed, word_offsets=offsets, words=words))

    def test_split_plan(self):
        assert tmesh.split_bounds(10, 4) == [(0, 3), (3, 6), (6, 8), (8, 10)]
        mesh = tmesh.make_mesh_2d(2, 4, devices=CPU8)
        plan = tmesh.catalog_split(mesh, 32, 640)
        assert plan[0] == ((0, 16), (0, 160)) and plan[7] == ((16, 32), (480, 640))
        assert tmesh.set_split(tmesh.make_mesh(8, devices=CPU8), 512)[7] == (448, 512)
        # equality by devices, axis names and shape: equal meshes key one cache
        assert tmesh.make_mesh(8, devices=CPU8) == tmesh.make_mesh(8, devices=CPU8)
        assert tmesh.make_mesh(8, devices=CPU8) != mesh
        assert len({tmesh.make_mesh(4, devices=CPU8), tmesh.make_mesh(4, devices=CPU8)}) == 1


# -- one engine surface ------------------------------------------------------------------

ENGINE_ENTRIES = ("stage_catalog_versioned", "solve_fused", "solve_compact", "solve_dense",
                  "refetch_dense", "price_bound", "repack", "repack_leftover", "replace")


def host_parts(out):
    """An entry's outputs as (dtype, shape, bytes) per array, ints as is."""
    if isinstance(out, (int, np.integer)):
        return [int(out)]
    if isinstance(out, (torch.Tensor, np.ndarray)):
        a = host(out)
        return [(str(a.dtype), a.shape, a.tobytes())]
    return [part for x in out for part in host_parts(x)]


class TestOneEngine:
    """DeviceEngine is the single-device back end of TorchSolver and the
    sidecar and the mesh engine's unsharded rung: the two engines' shared
    entries take the same parameters, and an 8-shard mesh, the unsharded
    rung and DeviceEngine agree bit for bit on each entry."""

    @pytest.mark.parametrize("name", ENGINE_ENTRIES)
    def test_surfaces_match(self, name):
        def params(cls):
            sig = inspect.signature(getattr(cls, name))
            return [(p.name, p.kind, p.default) for p in sig.parameters.values()]

        assert params(DeviceEngine) == params(TEngine)
        assert DeviceEngine("cpu").epoch is None and not DeviceEngine("cpu").replayed

    @pytest.mark.parametrize("entry", ["fused", "compact", "dense", "refetch_dense", "bound",
                                       "repack", "repack_leftover", "replace"])
    def test_every_entry_agrees_across_the_rungs(self, port_items, entry):  # noqa: F811
        inp, offsets, words, cs = port_world(port_items, seed=23)
        kw = dict(g_max=G, word_offsets=offsets, words=words, objective="price")
        nnz = tffd.nnz_budget(cs.c_pad, G)
        rng = np.random.default_rng(23)
        N, C, S, R = 16, 8, 16, tencode.R
        pack = (rng.integers(0, 8000, (N, R)).astype(np.float32), rng.random((C, N)) < 0.8,
                rng.integers(0, 900, (C, R)).astype(np.float32),
                rng.integers(0, 6, (S, C)).astype(np.int32), rng.random((S, N)) < 0.2)
        K, Z, CT = inp.cap.shape[0], inp.tzone.shape[1], inp.tcap.shape[1]
        swap = (torch.from_numpy(rng.integers(0, 4, (S, C)).astype(np.int32)),
                torch.from_numpy(pack[2]), torch.from_numpy(rng.random((C, K)) < 0.7),
                torch.from_numpy(rng.random((C, Z)) < 0.8), torch.ones((C, CT), dtype=torch.bool),
                inp.cap, torch.zeros((R,), dtype=torch.float32), inp.price)
        call = {
            "fused": lambda e: e.solve_fused(inp, nnz_max=nnz, **kw),
            "compact": lambda e: e.solve_compact(inp, nnz_max=nnz, **kw),
            "dense": lambda e: e.solve_dense(inp, **kw),
            "refetch_dense": lambda e: e.refetch_dense(inp, **kw),
            "bound": lambda e: e.price_bound(inp, cs.count.astype(np.float32),
                                             word_offsets=offsets, words=words),
            "repack": lambda e: e.repack(*pack),
            "repack_leftover": lambda e: e.repack_leftover(*pack),
            "replace": lambda e: e.replace(*swap, od_col=1),
        }[entry]
        sharded, unsharded = TEngine(tmesh.make_mesh(8, devices=CPU8)), unsharded_engine()
        want = host_parts(call(DeviceEngine("cpu")))
        assert host_parts(call(sharded)) == want
        assert host_parts(call(unsharded)) == want
        assert sharded.mesh is not None and unsharded.mesh is None


# -- the production tick -----------------------------------------------------------------


class TestMeshProductionTick:
    """TorchSolver(mesh=) through solve, synchronous and pipelined, equal
    to TPUSolver(mesh=) and to the unsharded solve."""

    def test_full_solve_bit_identical(self, jengine, tengine, catalog_items,  # noqa: F811
                                      port_items):  # noqa: F811
        jpods, tpods = both_pods(11, 90)
        want = decision_sig(TPUSolver(g_max=G, mesh=jengine).solve(
            JNodePool("default"), catalog_items, jpods))
        assert want == decision_sig(TPUSolver(g_max=G).solve(
            JNodePool("default"), catalog_items, list(jpods)))
        before = tmetrics.MESH_DISPATCHES.value(entry="fused")
        got = TorchSolver(g_max=G, mesh=tengine).solve(TNodePool("default"), port_items, tpods)
        assert decision_sig(got) == want
        assert tmetrics.MESH_DISPATCHES.value(entry="fused") > before

    def test_pipelined_begin_finish(self, tengine, catalog_items, port_items):  # noqa: F811
        solver = TorchSolver(g_max=G, mesh=tengine)
        plain = TPUSolver(g_max=G)
        jrng, trng = np.random.default_rng(12), np.random.default_rng(12)
        for tick in range(3):
            jpods = mixed_pods(jrng, 40 + 7 * tick, salt=tick)
            tpods = port_mixed_pods(trng, 40 + 7 * tick, salt=tick)
            pending = solver.solve_begin(TNodePool("default"), port_items, tpods)
            res = solver.solve_finish(pending)
            assert decision_sig(res) == decision_sig(
                plain.solve(JNodePool("default"), catalog_items, jpods)), f"tick {tick}"

    def test_mesh_solver_takes_the_mesh_device(self, tengine):
        assert TorchSolver(g_max=G, mesh=tengine).device == torch.device("cpu")
        with pytest.raises(ValueError, match="primary device"):
            TorchSolver(g_max=G, mesh=tengine, device="cuda")
        # a wire client owns no mesh (the sidecar does), as in TPUSolver
        assert TorchSolver(g_max=G, mesh=tengine, device="cpu",
                           client=object(), breaker=False).mesh_engine is None


class TestMeshSpec:
    def test_parse_specs(self, monkeypatch):
        for spec in (None, "", "0", "1", "off", "none"):
            assert tshard.parse_mesh_spec(spec) is None
        # specs count real cards: eight of them named, none touched
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
        m = tshard.parse_mesh_spec("8")
        assert m.size == 8 and m.devices == tuple(torch.device("cuda", i) for i in range(8))
        m2 = tshard.parse_mesh_spec("2x4")
        assert m2.shape == (2, 4) and m2.axis_names == (tmesh.HOSTS_AXIS, tmesh.TYPES_AXIS)
        monkeypatch.setenv(tshard.MESH_ENV, "4")
        assert tshard.mesh_from_env().size == 4

    def test_oversized_spec_fails_loudly(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
        with pytest.raises(ValueError, match="needs 2 devices; 1 cuda available"):
            tshard.parse_mesh_spec("2")
        with pytest.raises(ValueError, match="needs 8 devices"):
            tshard.parse_mesh_spec("2x4")
        # the CPU is one device: every sharded spec is oversized there
        with pytest.raises(ValueError, match="1 cpu available"):
            tshard.parse_mesh_spec("2", "cpu")
        with pytest.raises(ValueError, match="needs 2 CUDA devices"):
            tmesh.make_mesh(2)


# -- the wire with a mesh ----------------------------------------------------------------


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


class TestMeshWire:
    """The sharded sidecar: wire == host == sharded, and the per-shard
    delta-epoch contracts behave exactly as on one device."""

    def test_wire_solve_matches_host(self, mesh_server, mesh_client, catalog_items,  # noqa: F811
                                     port_items):  # noqa: F811
        sd = TorchSolver(g_max=G, device="cpu", client=mesh_client, breaker=False)
        jrng, trng = np.random.default_rng(21), np.random.default_rng(21)
        before = tmetrics.MESH_DISPATCHES.value(entry="compact")
        for tick in range(3):
            jpods = mixed_pods(jrng, 50, salt=100 + tick)
            tpods = port_mixed_pods(trng, 50, salt=100 + tick)
            assert decision_sig(sd.solve(TNodePool("default"), port_items, tpods)) == \
                decision_sig(TPUSolver(g_max=G).solve(JNodePool("default"), catalog_items, jpods))
        assert tmetrics.MESH_DISPATCHES.value(entry="compact") >= before + 3
        # the stage reply carried the topology epoch the catalog staged under
        (seqnum,) = list(mesh_server._staged)
        assert mesh_client._staged_tepochs[seqnum] == mesh_server._staged[seqnum].tepoch \
            == mesh_server._mesh.epoch
        assert sorted(mesh_client.features()) == sorted(
            ["join_allowed", "trace_echo", "solve_delta", "reply_v2", "solve_disrupt",
             "packed_masks", "topology_epoch", "convex", "shm"])

    def test_delta_epochs_compose_across_ticks(self, mesh_client, port_items):  # noqa: F811
        sd = TorchSolver(g_max=G, device="cpu", client=mesh_client, breaker=False)
        host_solver = TorchSolver(g_max=G, device="cpu")
        rng = np.random.default_rng(23)
        pods = port_mixed_pods(rng, 40, salt=200)
        sd.solve(TNodePool("default"), port_items, list(pods))
        pods2 = pods[:-5] + port_mixed_pods(rng, 5, salt=201)
        res = sd.solve(TNodePool("default"), port_items, list(pods2))
        assert mesh_client.last_delta["mode"] == "delta"
        assert decision_sig(res) == decision_sig(
            host_solver.solve(TNodePool("default"), port_items, list(pods2)))

    def test_pressure_eviction_restages_not_errors(self, mesh_server, mesh_client,
                                                   port_items):  # noqa: F811
        sd = TorchSolver(g_max=G, device="cpu", client=mesh_client, breaker=False)
        host_solver = TorchSolver(g_max=G, device="cpu")
        rng = np.random.default_rng(29)
        pods = port_mixed_pods(rng, 40, salt=300)
        sd.solve(TNodePool("default"), port_items, list(pods))
        try:
            thbm.set_stats_provider(lambda: {
                "cuda:0": {"bytes_in_use": 950, "bytes_limit": 1000, "peak_bytes_in_use": 950},
            })
            with mesh_server._lock:
                mesh_server._evict_for_pressure_locked()
            assert len(mesh_server._epochs) <= 1
        finally:
            thbm.set_stats_provider(None)
        before = tmetrics.DELTA_EPOCH_RESTAGES.value()
        pods2 = pods[:-4] + port_mixed_pods(rng, 4, salt=301)
        res = sd.solve(TNodePool("default"), port_items, list(pods2))
        assert decision_sig(res) == decision_sig(
            host_solver.solve(TNodePool("default"), port_items, list(pods2)))
        assert tmetrics.DELTA_EPOCH_RESTAGES.value() >= before

    def test_midflight_stale_epoch_surfaces_then_recovers(self, mesh_server, mesh_client,
                                                          port_items):  # noqa: F811
        solver = TorchSolver(g_max=G, device="cpu", client=mesh_client, breaker=False)
        entry = solver._catalog(port_items)
        classes = tencode.group_pods(port_mixed_pods(np.random.default_rng(31), 30, salt=400))
        cs = tencode.encode_classes(classes, entry.tensors, c_pad=32)
        h = mesh_client.begin_solve_compact(entry.seqnum, entry.tensors, cs, g_max=G)
        mesh_client.finish_solve_compact(h)
        assert mesh_client.last_delta["mode"] == "full"
        cs2 = tencode.encode_classes(classes, entry.tensors, c_pad=32)
        cs2.count[0] += 1
        with mesh_server._lock:
            mesh_server._epochs.clear()
        h2 = mesh_client.begin_solve_compact(entry.seqnum, entry.tensors, cs2, g_max=G)
        assert mesh_client.last_delta["mode"] == "delta"
        with pytest.raises(trpc.StaleEpochError):
            mesh_client.finish_solve_compact(h2)
        dec = mesh_client.solve_classes_compact(entry.seqnum, entry.tensors, cs2, g_max=G)
        assert int(dec.n_open) >= 0 and mesh_client.last_delta["mode"] == "full"

    def test_jax_client_on_the_mesh_sidecar(self, mesh_server, catalog_items):  # noqa: F811
        from karpenter_tpu.solver import rpc as jrpc

        c = jrpc.SolverClient(path=mesh_server.path, timeout=60.0, track_transport=False)
        try:
            jpods = mixed_pods(np.random.default_rng(33), 40, salt=450)
            got = TPUSolver(g_max=G, client=c, breaker=False).solve(
                JNodePool("default"), catalog_items, list(jpods))
            assert decision_sig(got) == decision_sig(
                TPUSolver(g_max=G).solve(JNodePool("default"), catalog_items, list(jpods)))
            assert set(c._staged_tepochs.values()) == {mesh_server._mesh.epoch}
        finally:
            c.close()

    def test_debug_doc_reports_mesh(self, mesh_client, port_items):  # noqa: F811
        TorchSolver(g_max=G, device="cpu", client=mesh_client, breaker=False).solve(
            TNodePool("default"), port_items, port_mixed_pods(np.random.default_rng(1), 10))
        info = mesh_client.debug_info()
        assert info["mesh"]["devices"] == 8 and info["mesh"]["mode"] == "full"
        assert info["mesh"]["topology"]["healthy"] == 8


# -- the consolidation evaluator ----------------------------------------------------------


def test_evaluator_with_mesh_matches_without(tengine):
    """tests/test_mesh.py's evaluator case on both packages: 10 sets over
    5 nodes, S padded to the mesh size, kernel B once per shard."""
    need_mesh()
    from karpenter_tpu.solver import consolidate as jconsolidate
    from karpenter_tpu.solver.oracle import ExistingNode as JNode
    from karpenter_tpu_torch.scheduling import resources as tres
    from karpenter_tpu_torch.solver import consolidate as tconsolidate
    from karpenter_tpu_torch.solver.oracle import ExistingNode as TNode

    def world(Node, Pod, Resources, res):
        nodes = [Node(name=f"n{i}", labels={}, allocatable=Resources.from_base_units(
            {res.CPU: 4000, res.MEMORY: 8 * 2**30, res.PODS: 110})) for i in range(5)]
        sets = [([Pod(f"s{s}-{i}", requests=Resources({"cpu": "1", "memory": "1Gi"}))
                  for i in range(2 + s)], [f"n{s % 5}"]) for s in range(10)]
        return nodes, sets

    jn, js = world(JNode, JPod, JResources, jres)
    tn, ts = world(TNode, TPod, TResources, tres)
    want = [(v.can_delete, v.leftover)
            for v in jconsolidate.ConsolidationEvaluator(mesh=jmake_mesh(8)).evaluate(jn, js)]
    plain = tconsolidate.ConsolidationEvaluator(device="cpu").evaluate(tn, ts)
    calls = []
    # the sweep's entry: leftovers only, no takes on any shard
    kernel = tdk.disrupt_repack_leftover

    def counted(*a):
        calls.append(int(a[3].shape[0]))
        return kernel(*a)

    tdk.disrupt_repack_leftover = counted
    try:
        meshy = tconsolidate.ConsolidationEvaluator(mesh=tengine.mesh).evaluate(tn, ts)
    finally:
        tdk.disrupt_repack_leftover = kernel
    assert [(v.can_delete, v.leftover) for v in plain] == want
    assert [(v.can_delete, v.leftover) for v in meshy] == want
    assert calls == [2] * 8


# -- multi-process -------------------------------------------------------------------------


class TestMultiHostMesh:
    def test_init_distributed_noop_without_env(self, monkeypatch):
        monkeypatch.delenv("JAX_COORDINATOR_ADDRESS", raising=False)
        assert tmesh.init_distributed() is False

    def test_init_distributed_half_configured_fails(self, monkeypatch):
        monkeypatch.setenv("JAX_COORDINATOR_ADDRESS", "127.0.0.1:1")
        monkeypatch.delenv("JAX_NUM_PROCESSES", raising=False)
        monkeypatch.delenv("JAX_PROCESS_ID", raising=False)
        with pytest.raises(RuntimeError, match="JAX_NUM_PROCESSES"):
            tmesh.init_distributed()

    def test_two_process_gloo_bit_identity(self):
        """8 shards over 2 gloo ranks (4 each): every rank's sharded
        solve, bound and repack equal its unsharded ones."""
        from karpenter_tpu_torch.parallel import dryrun

        doc = dryrun.run(2, "cpu", timeout_s=100.0)
        assert doc["ok"], doc
        assert sorted(tuple(r["local_shards"]) for r in doc["reports"]) == [
            (0, 1, 2, 3), (4, 5, 6, 7)]
        assert all(r["checks"]["multiprocess"] for r in doc["reports"])

    @pytest.mark.skipif(
        not os.environ.get("KARPENTER_TPU_MP_DRYRUN"),
        reason="4-process mesh dryrun: set KARPENTER_TPU_MP_DRYRUN=1 (as the JAX "
        "package's TestMultiProcessMesh)")
    def test_four_process_gloo_bit_identity(self):
        from karpenter_tpu_torch.parallel import dryrun

        doc = dryrun.run(4, "cpu", timeout_s=110.0)
        assert doc["ok"], doc


def test_registries_share_the_mesh_families():
    names = {n for n in tmetrics.REGISTRY._metrics if n.startswith("karpenter_mesh_")}
    assert names == {n for n in jmetrics.REGISTRY._metrics if n.startswith("karpenter_mesh_")}
    assert len(names) == 10
