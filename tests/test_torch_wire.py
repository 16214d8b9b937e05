"""The port's solver wire against the JAX package's, on the CPU.

- framing: the same header and tensors framed by each package's
  `_send_frame` over a socketpair are byte-equal, and each package's
  `_recv_frame` reads the other's frames, v1 and the trimmed reply v2;
- the client x server matrix: {JAX client, port client} x {JAX server,
  port server(device="cpu")} at small width; every op's reply equals the
  JAX/JAX reply -- decisions array-equal, the disrupt leftover and
  replacement outputs equal, the convex decision and header exact with
  the relaxation's lower bound within the 5e-5 test_torch_convex.py pins;
- `TorchSolver(device="cpu", client=...)` over the port's server decides
  as `TPUSolver(client=...)` over the JAX server (`decision_sig` and
  `last_route`) on a tick, existing nodes, the merged route and the
  pipelined entry; a sweep through the port's `DisruptEngine` over the
  wire gives the JAX engine's wire verdicts;
- transports and security: the shm ring and TCP, the token on TCP, a
  server restart answered by StaleSeqnumError then a restage, `features`.

Every socket carries a timeout and every server stops in a fixture with a
bounded join (no test can hang the run); socket paths come from
`tempfile.mkdtemp(prefix="kt-")`, far inside the 108-byte UNIX limit.
"""
import dataclasses
import os
import shutil
import socket
import tempfile

import numpy as np
import pytest

import jax  # noqa: F401  -- both frameworks in one process; data crosses as numpy
import torch

import bench
from karpenter_tpu import metrics as jmetrics
from karpenter_tpu.solver import encode as jencode
from karpenter_tpu.solver import rpc as jrpc
from karpenter_tpu.solver.disrupt import DisruptEngine as JEngine
from karpenter_tpu.solver.service import TPUSolver
from karpenter_tpu_torch import metrics as tmetrics
from karpenter_tpu_torch import workload
from karpenter_tpu_torch.apis import NodePool as TNodePool
from karpenter_tpu_torch.solver import rpc as trpc
from karpenter_tpu_torch.solver.disrupt import DisruptEngine as TEngine
from karpenter_tpu_torch.solver.service import TorchSolver
from tests.test_packing import catalog_items  # noqa: F401
from tests.test_torch_catalog import port_items  # noqa: F401
from tests.test_torch_consolidate import jax_sweep, sweep_pools
from tests.test_torch_oracle import (  # noqa: F401
    SPOT_OD_POOLS, TAINTED_POOLS, build, fuzz_spec, result_sig, small_items,
)

# small tensors: one intra-op thread per test worker (several workers share the cores)
torch.set_num_threads(1)

G = 64
JOIN_S = 10.0
CLIENTS = {"jax": jrpc.SolverClient, "torch": trpc.SolverClient}
# the JAX server's features without a coalescer, shm on; a mesh adds none
# (topology_epoch is always advertised; with a mesh the stage reply carries
# the epoch: tests/test_torch_mesh.py)
FEATURES = sorted([
    "join_allowed", "trace_echo", "solve_delta", "reply_v2", "solve_disrupt",
    "packed_masks", "topology_epoch", "convex", "shm",
])


# -- servers, clients ------------------------------------------------------------------


@pytest.fixture(scope="module")
def sockdir():
    d = tempfile.mkdtemp(prefix="kt-")
    yield d
    shutil.rmtree(d, ignore_errors=True)


def start_server(kind, path=None, **kw):
    if kind == "jax":
        return jrpc.SolverServer(path=path, **kw).start()
    return trpc.SolverServer(path=path, device="cpu", **kw).start()


def stop_server(srv):
    srv.stop()
    srv._thread.join(timeout=JOIN_S)
    assert not srv._thread.is_alive(), "the server thread did not stop"


@pytest.fixture(scope="module")
def servers(sockdir):
    out = {k: start_server(k, os.path.join(sockdir, f"{k}.sock")) for k in ("jax", "torch")}
    yield out
    for srv in out.values():
        stop_server(srv)


@pytest.fixture(scope="module")
def matrix_servers(sockdir):
    """A pair that serves the matrix world only (its staging documents
    then compare entry for entry)."""
    out = {k: start_server(k, os.path.join(sockdir, f"m-{k}.sock")) for k in ("jax", "torch")}
    yield out
    for srv in out.values():
        stop_server(srv)


def make_client(kind, srv, **kw):
    kw.setdefault("timeout", 60.0)
    kw.setdefault("connect_timeout", 5.0)
    if srv.path is not None:
        return CLIENTS[kind](path=srv.path, **kw)
    host, port = srv.address
    return CLIENTS[kind](host, port, **kw)


@pytest.fixture
def clients():
    """Clients a test opens, closed at teardown (the handler threads then
    see EOF and end)."""
    opened = []

    def open_(kind, srv, **kw):
        c = make_client(kind, srv, **kw)
        opened.append(c)
        return c

    yield open_
    for c in opened:
        c.close()


# -- the world: one encoding, both clients ship it ----------------------------------


@dataclasses.dataclass
class World:
    catalog: object
    cs1: object
    cs2: object
    repack: dict
    replace1: dict
    replace2: dict


@pytest.fixture(scope="module")
def world(small_items):  # noqa: F811
    catalog = jencode.encode_catalog(small_items["jax"])
    pods = bench.synth_pods(np.random.default_rng(5), list(workload.ZONES), 400, 5, 24)
    classes = jencode.group_pods(pods)
    cs1 = jencode.encode_classes(classes, catalog, c_pad=encode_pad(len(classes)))
    # tick 2: a few rows changed (the delta ship)
    cs2 = dataclasses.replace(cs1, count=cs1.count.copy())
    cs2.count[[0, 3]] += 2
    rng = np.random.default_rng(9)
    C, N, S, R = cs1.c_pad, 16, 8, jencode.R
    req = np.zeros((C, R), np.float32)
    req[: len(classes)] = cs1.req[: len(classes)]
    repack = {
        "headroom": rng.integers(0, 6_000, (N, R)).astype(np.float32),
        "feas": rng.random((C, N)) < 0.6,
        "req": req,
        "member": rng.integers(0, 3, (S, C)).astype(np.int32),
        "excl": rng.random((S, N)) < 0.2,
    }

    def replace(seed):
        r = np.random.default_rng(seed)
        return {
            "creq": req, "compat": r.random((C, catalog.k_pad)) < 0.7,
            "azone": np.ones((C, jencode.Z_PAD), bool), "acap": r.random((C, jencode.CT)) < 0.8,
            "ovh": np.zeros((R,), np.float32),
        }

    return World(catalog, cs1, cs2, repack, replace(10), replace(11))


def encode_pad(n):
    return jencode.bucket(n, 16)


# -- the ops, as each client drives them -------------------------------------------


def arrays(nt):
    return {k: np.asarray(v) for k, v in nt._asdict().items()}


def run_op(op, kind, srv, w, clients):
    """One op through a fresh client of `kind` against `srv`: the reply's
    decision-bearing content."""
    seq = f"seq-{op}"
    if op == "ping":
        c = clients(kind, srv, shm=False)
        return {"ok": c.ping(), "features": sorted(c.features())}
    if op == "stage":
        c = clients(kind, srv, shm=False)
        c.stage_catalog(seq, w.catalog)
        doc = c.debug_info()
        # the matrix servers stage only this world's catalog: bytes per entry
        return {"per_catalog": doc["staged_bytes"]["catalog"] // len(doc["staged_seqnums"]),
                "staged": seq in doc["staged_seqnums"]}
    if op == "solve":
        c = clients(kind, srv, shm=False)
        return arrays(c.solve_classes(seq, w.catalog, w.cs1, g_max=G))
    if op in ("solve_compact", "solve_compact_v2"):
        v2 = op.endswith("v2")
        c = clients(kind, srv, shm=False, delta=False, reply_v2=v2)
        out = arrays(c.solve_classes_compact(seq, w.catalog, w.cs1, g_max=G))
        assert c.last_reply["v"] == (2 if v2 else 1)
        return out
    if op == "solve_delta":
        c = clients(kind, srv, shm=False, delta=True)
        out = {}
        for i, cs in enumerate((w.cs1, w.cs2)):
            out[i] = arrays(c.solve_classes_compact(seq, w.catalog, cs, g_max=G))
            out[f"mode{i}"] = c.last_delta["mode"]
        h = c.begin_solve_compact(seq, w.catalog, w.cs1, g_max=G)
        out[2] = arrays(c.finish_solve_compact(h))
        out["mode2"] = c.last_delta["mode"]
        doc = c.debug_info()
        # the chain's base was consumed by each delta: one epoch per chain
        out["epochs"] = doc["staged_bytes"]["class_epoch"] // len(doc["class_epochs"])
        return out
    if op == "solve_disrupt":
        c = clients(kind, srv, shm=False)
        depoch, first = c.solve_disrupt_repack(
            w.repack, seqnum=seq, catalog=w.catalog, replace=w.replace1)
        second = c.solve_disrupt_replace(
            depoch, seqnum=seq, catalog=w.catalog, replace=w.replace2)
        stateless = c.solve_disrupt_replace(
            "gone", seqnum=seq, catalog=w.catalog, replace=w.replace2,
            leftover=np.asarray(first["leftover"]))
        return {"first": {k: np.asarray(v) for k, v in first.items()},
                "second": {k: np.asarray(v) for k, v in second.items()},
                "stateless": {k: np.asarray(v) for k, v in stateless.items()}}
    if op == "solve_convex":
        c = clients(kind, srv, shm=False)
        dense, info = c.solve_convex(seq, w.catalog, w.cs1, g_max=G)
        return {"dense": [np.asarray(a) for a in dense], "info": info}
    if op == "shm_open":
        c = clients(kind, srv, shm=True, delta=False)
        assert "shm" in c.features()
        assert c._ring is not None, "the ring was not negotiated"
        return arrays(c.solve_classes_compact(seq, w.catalog, w.cs1, g_max=G))
    raise AssertionError(op)


OPS = ("ping", "stage", "solve", "solve_compact", "solve_compact_v2", "solve_delta",
       "solve_disrupt", "solve_convex", "shm_open")


def assert_same(got, want, path="reply"):
    if isinstance(want, dict):
        assert set(got) == set(want), f"{path}: keys {sorted(got)} != {sorted(want)}"
        for k in want:
            assert_same(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)) and not isinstance(want, str):
        assert len(got) == len(want), path
        for i, (a, b) in enumerate(zip(got, want)):
            assert_same(a, b, f"{path}[{i}]")
    elif isinstance(want, np.ndarray):
        got = np.asarray(got)
        assert got.dtype == want.dtype and got.shape == want.shape, (
            f"{path}: {got.dtype}{got.shape} != {want.dtype}{want.shape}")
        np.testing.assert_array_equal(got, want, err_msg=path)
    else:
        assert got == want, f"{path}: {got!r} != {want!r}"


@pytest.fixture(scope="module")
def reference(matrix_servers, world):
    """The JAX client against the JAX server, op by op (memoized)."""
    cache = {}
    opened = []

    def ref(op):
        if op not in cache:
            def open_(kind, srv, **kw):
                c = make_client(kind, srv, **kw)
                opened.append(c)
                return c

            cache[op] = run_op(op, "jax", matrix_servers["jax"], world, open_)
        return cache[op]

    yield ref
    for c in opened:
        c.close()


class TestMatrix:
    @pytest.mark.parametrize("op", OPS)
    @pytest.mark.parametrize("pair", ["jax-torch", "torch-jax", "torch-torch"])
    def test_reply_equals_jax_jax(self, pair, op, matrix_servers, world, reference, clients):
        client_kind, server_kind = pair.split("-")
        got = run_op(op, client_kind, matrix_servers[server_kind], world, clients)
        want = reference(op)
        if op == "solve_convex":
            # the relaxation's certified lower bound within the convex
            # tolerance; every other field of the header and the chosen
            # dense decision exact
            assert got["info"]["lower"] == pytest.approx(want["info"]["lower"], rel=5e-5, abs=5e-5)
            got = dict(got, info={k: v for k, v in got["info"].items() if k != "lower"})
            want = dict(want, info={k: v for k, v in want["info"].items() if k != "lower"})
        assert_same(got, want)
        if op == "ping":
            assert got["features"] == FEATURES
        if op == "solve_delta":
            assert [got["mode0"], got["mode1"], got["mode2"]] == ["full", "delta", "delta"]


# -- framing -------------------------------------------------------------------------------


FRAME_TENSORS = [
    ("f", np.arange(12, dtype=np.float32).reshape(3, 4)),
    ("i", np.array([-1, 7, 2**31 - 1], dtype=np.int32)),
    ("u", np.array([[0xFFFFFFFF, 1]], dtype=np.uint32)),
    ("b", np.array([True, False, True])),
    ("s", np.array(5, dtype=np.int32)),            # 0-d: shape [] on the wire
    ("e", np.zeros((0, 3), dtype=np.float32)),     # empty: header only
    ("t", np.arange(6, dtype=np.int32).reshape(2, 3).T),  # non-contiguous: one copy
]


def frame_bytes(mod, header, tensors=()):
    a, b = socket.socketpair()
    try:
        a.settimeout(10)
        b.settimeout(10)
        mod._send_frame(a, header, tensors)
        a.shutdown(socket.SHUT_WR)
        chunks = []
        while True:
            chunk = b.recv(65536)
            if not chunk:
                return b"".join(chunks)
            chunks.append(chunk)
    finally:
        a.close()
        b.close()


def cross_recv(sender, reader, header, tensors):
    a, b = socket.socketpair()
    try:
        a.settimeout(10)
        b.settimeout(10)
        sender._send_frame(a, header, tensors)
        return reader._recv_frame(b)
    finally:
        a.close()
        b.close()


class TestFraming:
    def test_frames_are_byte_equal(self):
        header = {"op": "solve_compact", "seqnum": "x-1", "g_max": 64, "rows": [1, 5]}
        want = frame_bytes(jrpc, header, FRAME_TENSORS)
        got = frame_bytes(trpc, header, FRAME_TENSORS)
        assert got == want
        # and a tensorless frame (no crc field)
        assert frame_bytes(trpc, {"ok": True}) == frame_bytes(jrpc, {"ok": True})

    @pytest.mark.parametrize("direction", ["jax->torch", "torch->jax"])
    def test_each_reads_the_other(self, direction):
        sender, reader = (jrpc, trpc) if direction == "jax->torch" else (trpc, jrpc)
        header, tensors = cross_recv(sender, reader, {"op": "ping", "n": 3}, FRAME_TENSORS)
        assert header["op"] == "ping" and header["n"] == 3 and "crc" in header
        assert list(tensors) == [n for n, _ in FRAME_TENSORS]
        for name, a in FRAME_TENSORS:
            assert tensors[name].dtype == a.dtype and tensors[name].shape == a.shape
            np.testing.assert_array_equal(tensors[name], a)

    @pytest.mark.parametrize("direction", ["jax->torch", "torch->jax"])
    def test_reply_v2_crosses(self, direction, servers, world):
        """A v2 reply built by one package's `_reply_v2_parts` expands in
        the other's `expand_reply_v2` to the same CompactDecision."""
        sender, reader = (jrpc, trpc) if direction == "jax->torch" else (trpc, jrpc)
        c = make_client("jax", servers["jax"], shm=False, delta=False, reply_v2=False)
        try:
            dec = c.solve_classes_compact("v2-cross", world.catalog, world.cs1, g_max=G)
        finally:
            c.close()
        fields = {k: np.asarray(v) for k, v in dec._asdict().items()}
        hdr, tensors = sender._reply_v2_parts(fields)
        header, got = cross_recv(sender, reader, {"ok": True, **hdr}, tensors)
        out = reader.expand_reply_v2(header, got, G)
        want = jrpc.expand_reply_v2({"ok": True, **hdr}, dict(tensors), G)
        for k in want._fields:
            np.testing.assert_array_equal(np.asarray(getattr(out, k)), np.asarray(getattr(want, k)))
        assert int(out.n_open) == int(dec.n_open) and int(out.nnz) == int(dec.nnz)

    @pytest.mark.parametrize("mod", [jrpc, trpc], ids=["jax", "torch"])
    def test_corrupt_payload_is_a_connection_error(self, mod):
        data = bytearray(frame_bytes(jrpc, {"op": "x"}, FRAME_TENSORS[:2]))
        data[-1] ^= 0xFF
        a, b = socket.socketpair()
        try:
            b.settimeout(10)
            a.sendall(bytes(data))
            with pytest.raises(ConnectionError, match="crc"):
                mod._recv_frame(b)
        finally:
            a.close()
            b.close()

    def test_oversized_unauthenticated_header_is_refused(self):
        a, b = socket.socketpair()
        try:
            b.settimeout(10)
            a.sendall(trpc._LEN.pack(5000) + b"{}")
            with pytest.raises(ConnectionError, match="oversized"):
                trpc._recv_frame(b, limit=4096)
        finally:
            a.close()
            b.close()


# -- TorchSolver and DisruptEngine over the wire -----------------------------------


def solver_pair(servers, clients, **kw):
    """(TPUSolver over the JAX server, TorchSolver over the port server)."""
    js = TPUSolver(g_max=G, client=clients("jax", servers["jax"]), breaker=False, **kw)
    ts = TorchSolver(device="cpu", g_max=G, client=clients("torch", servers["torch"]),
                     breaker=False, **kw)
    return js, ts


class TestSolverOverTheWire:
    @pytest.mark.parametrize("route,pipelined", [
        ("device", False), ("merged", False), ("tainted-merged", False), ("device", True),
    ])
    def test_schedule_equals_tpusolver(self, route, pipelined, servers, clients, small_items):  # noqa: F811
        kw = dict(seed=2, spread=0.6, nodes=3, bound_spread=True, overhead=True)
        if route == "merged":
            kw = dict(seed=3, pools=SPOT_OD_POOLS, spread=0.5, nodes=2, bound_spread=True,
                      overhead=True)
        elif route == "tainted-merged":
            kw = dict(seed=7, pools=TAINTED_POOLS, nodes=2)
        spec = fuzz_spec(kw.pop("seed"), **kw)
        j, t = build("jax", spec, small_items), build("torch", spec, small_items)
        js, ts = solver_pair(servers, clients)
        want = result_sig(js.schedule(j.scheduler("price"), list(j.pods)))
        if pipelined:
            pending = ts.schedule_begin(t.scheduler("price"), list(t.pods))
            assert pending.rpc_handle is not None, "the wire solve did not pipeline"
            got = result_sig(ts.schedule_finish(pending))
        else:
            got = result_sig(ts.schedule(t.scheduler("price"), list(t.pods)))
        assert ts.last_route == js.last_route
        assert ts.last_route["path"] == ("merged" if "merged" in route else "device")
        assert got == want
        # the wire carried the solve: staged on the port's sidecar, and the
        # quality document carries no local bound, as TPUSolver's wire ticks
        assert ts.describe_wire()["server"]["staged_seqnums"]
        assert ts.last_quality is not None and js.last_quality is not None
        assert ts.last_quality.get("bound_per_h") == js.last_quality.get("bound_per_h")

    def test_two_ticks_ship_a_delta(self, servers, clients, small_items):  # noqa: F811
        spec = fuzz_spec(2, spread=0.6, nodes=3, bound_spread=True, overhead=True)
        js, ts = solver_pair(servers, clients)
        for tick in range(2):
            j, t = build("jax", spec, small_items), build("torch", spec, small_items)
            pods_j, pods_t = list(j.pods), list(t.pods)
            if tick:
                pods_j, pods_t = pods_j[:-3], pods_t[:-3]
            want = result_sig(js.schedule(j.scheduler("price"), pods_j))
            got = result_sig(ts.schedule(t.scheduler("price"), pods_t))
            assert got == want
            assert ts.client.last_delta["mode"] == js.client.last_delta["mode"]
        assert ts.client.last_delta["mode"] == "delta"

    def test_convex_tier_equals_tpusolver(self, servers, clients, small_items):  # noqa: F811
        spec = fuzz_spec(11, nodes=0)
        j, t = build("jax", spec, small_items), build("torch", spec, small_items)
        js, ts = solver_pair(servers, clients, tier="convex")
        want = result_sig(js.schedule(j.scheduler("price"), list(j.pods)))
        got = result_sig(ts.schedule(t.scheduler("price"), list(t.pods)))
        assert got == want and ts.last_route == js.last_route
        # last_convex is the sidecar's certificate on both sides
        assert set(ts.last_convex) == set(js.last_convex) == {
            "winner", "lower", "iterations", "fallback", "price_ffd", "price_convex"}
        for k in ("winner", "iterations", "fallback", "price_ffd", "price_convex"):
            assert ts.last_convex[k] == js.last_convex[k], k
        assert ts.last_convex["lower"] == pytest.approx(js.last_convex["lower"], rel=5e-5)

    def test_sweep_equals_jax_engine_wire_route(self, servers, clients, catalog_items, port_items):  # noqa: F811
        pods = workload.synth_pods(np.random.default_rng(5), workload.ZONES, 1_500, 5, 40)
        tick = TorchSolver(device="cpu", g_max=G).solve(TNodePool("default"), port_items, pods)
        spec = workload.rampdown_sweep_spec(tick, np.random.default_rng(11), n_cand=8, keep=1.0)
        js, ts = solver_pair(servers, clients)
        jengine, tengine = JEngine(solver=js), TEngine(solver=ts)
        out = []
        for which, engine, items in (("jax", jengine, catalog_items), ("torch", tengine, port_items)):
            nodes, sets = jax_sweep(spec) if which == "jax" else workload.sweep_world(spec)
            pools, ovh = sweep_pools(which, "spot-od")
            out.append([repr(v) for v in engine.evaluate(
                nodes, sets, pools=pools, catalogs={p.name: items for p in pools},
                daemon_overhead=ovh or None)])
        want, got = out
        assert jengine.last_dispatch["path"] == "wire"
        assert tengine.last_dispatch["path"] == "wire"
        assert got == want
        assert any("replace_type='" in v for v in got), "no set took the replacement search"


# -- transports and security ----------------------------------------------------------


def compact_arrays(c, w, seq="tr"):
    return arrays(c.solve_classes_compact(seq, w.catalog, w.cs1, g_max=G))


class TestTransports:
    @pytest.mark.parametrize("client_kind", ["jax", "torch"])
    def test_shm_ring_and_socket_agree(self, client_kind, servers, world, clients):
        ring = clients(client_kind, servers["torch"], shm=True, delta=False)
        sock = clients(client_kind, servers["torch"], shm=False, delta=False)
        mod = tmetrics if client_kind == "torch" else jmetrics
        before = mod.WIRE_BYTES.value(direction="sent", transport="shm")
        a = compact_arrays(ring, world)
        assert ring._ring is not None
        assert mod.WIRE_BYTES.value(direction="sent", transport="shm") > before
        assert_same(compact_arrays(sock, world), a)
        assert sock._ring is None

    @pytest.mark.parametrize("client_kind", ["jax", "torch"])
    def test_tcp_needs_the_token(self, client_kind, world, clients):
        with pytest.raises(ValueError, match="token"):
            trpc.SolverServer("127.0.0.1", 0, device="cpu", token="")
        srv = trpc.SolverServer("127.0.0.1", 0, device="cpu", token="s3cret").start()
        try:
            good = clients(client_kind, srv, token="s3cret")
            assert good.ping()
            assert_same(compact_arrays(good, world, "tcp"),
                        compact_arrays(clients(client_kind, srv, token="s3cret"), world, "tcp2"))
            bad = clients(client_kind, srv, token="wrong")
            with pytest.raises(ConnectionError):
                bad.ping()
            # no token: the first op is answered "unauthenticated" and the
            # server hangs up
            none = clients(client_kind, srv, token="")
            resp, _ = none._roundtrip({"op": "ping"})
            assert resp["error"] == "unauthenticated" and not none.ping()
        finally:
            stop_server(srv)

    def test_insecure_tcp_is_an_explicit_choice(self, world, clients):
        srv = trpc.SolverServer("127.0.0.1", 0, device="cpu", token="", insecure_tcp=True).start()
        try:
            assert clients("torch", srv).ping()
        finally:
            stop_server(srv)

    def test_unix_socket_is_private(self, servers):
        assert (os.stat(servers["torch"].path).st_mode & 0o777) == 0o600

    @pytest.mark.parametrize("client_kind", ["jax", "torch"])
    def test_restart_is_a_stale_seqnum_then_a_restage(self, client_kind, sockdir, world, clients):
        path = os.path.join(sockdir, f"restart-{client_kind}.sock")
        srv = start_server("torch", path)
        c = clients(client_kind, srv, shm=False)
        mod = jrpc if client_kind == "jax" else trpc
        try:
            want = compact_arrays(c, world, "rs")
            c.close()  # the stale connection dies with the old server
            stop_server(srv)
            srv = start_server("torch", path)
            # the client believes the seqnum is staged; the new server does not
            c._staged_seqnums.add("rs")
            h = c.begin_solve_compact("rs", world.catalog, world.cs1, g_max=G)
            with pytest.raises(mod.StaleSeqnumError):
                c.finish_solve_compact(h)
            # the synchronous op restages and retries
            assert_same(compact_arrays(c, world, "rs"), want)
        finally:
            c.close()
            stop_server(srv)

    def test_unknown_op_and_unknown_depoch_are_errors(self, servers, clients):
        c = clients("torch", servers["torch"], shm=False)
        resp, _ = c._roundtrip({"op": "nope"})
        assert resp == {"ok": False, "error": "unknown op 'nope'", "tensors": []}
        with pytest.raises(RuntimeError, match="unknown-depoch"):
            c.solve_disrupt_replace("never", seqnum=None, catalog=None, replace={})


class TestWireFailpoints:
    """The wire's failpoint sites fire where the JAX package fires them,
    and the client's ladder answers as it does there."""

    @pytest.fixture
    def armed(self):
        from karpenter_tpu_torch import failpoints

        yield failpoints.FAILPOINTS
        failpoints.FAILPOINTS.reset()

    def test_server_dispatch_error_crosses_as_an_error_frame(self, armed, servers, world, clients):
        c = clients("torch", servers["torch"], shm=False, delta=False)
        armed.arm_spec("rpc.server.dispatch=error(RuntimeError):times=1")
        with pytest.raises(RuntimeError, match="failpoint rpc.server.dispatch"):
            c.solve_classes_compact("fp-d", world.catalog, world.cs1, g_max=G)
        assert armed.fires("rpc.server.dispatch") == 1
        assert compact_arrays(c, world, "fp-d")["nnz"].size

    @pytest.mark.parametrize("site", ["rpc.frame.corrupt", "rpc.shm.corrupt"])
    def test_corrupt_frame_is_retried_on_a_fresh_stream(self, site, armed, servers, world, clients):
        want = compact_arrays(clients("torch", servers["torch"], shm=False, delta=False), world, "fp-c0")
        c = clients("torch", servers["torch"], shm=site == "rpc.shm.corrupt", delta=False)
        assert c.ping()
        armed.arm_spec(f"{site}=corrupt:times=1")
        assert_same(compact_arrays(c, world, "fp-c"), want)
        assert armed.fires(site) == 1

    def test_connect_error_then_recovery(self, armed, servers, clients):
        c = clients("torch", servers["torch"], shm=False)
        armed.arm_spec("rpc.client.connect=error(ConnectionError):times=1")
        with pytest.raises(ConnectionError):
            c.ping()
        assert c.ping() and armed.fires("rpc.client.connect") == 1


class TestOverloadBudget:
    """The tick budget and the brownout's delta shed, as the JAX client
    reads its own."""

    @pytest.mark.parametrize("deadline", [0.2, 5.0, 500.0])
    def test_read_timeout_clamped_like_jax(self, deadline, servers, clients):
        from karpenter_tpu import overload as joverload
        from karpenter_tpu_torch import overload as toverload

        clock = [100.0]
        got = []
        for kind, mod in (("jax", joverload), ("torch", toverload)):
            c = clients(kind, servers["torch"], shm=False)
            assert c.ping()
            with mod.active(mod.TickBudget(deadline, clock=lambda: clock[0])):
                clock[0] += 0.1
                c._apply_budget_timeout()
                got.append((c._wire.gettimeout(), c._budget_clamped))
        assert got[1] == got[0]
        assert got[1][1] == (deadline - 0.1 < 60.0)

    def test_brownout_sheds_delta(self, servers, world, clients, monkeypatch):
        from karpenter_tpu_torch import overload as toverload

        c = clients("torch", servers["torch"], shm=False, delta=True)
        c.solve_classes_compact("shed", world.catalog, world.cs1, g_max=G)
        assert c.last_delta["mode"] == "full"

        class Rung3:
            def sheds_delta(self):
                return True

        monkeypatch.setattr(toverload, "_BROWNOUT", Rung3())
        before = tmetrics.DELTA_SOLVES.value(mode="bypass")
        c.solve_classes_compact("shed", world.catalog, world.cs2, g_max=G)
        assert c.last_delta["mode"] == "bypass"
        assert tmetrics.DELTA_SOLVES.value(mode="bypass") == before + 1
