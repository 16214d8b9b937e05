"""Solver service boundary: the decision plane as a network sidecar.

Copy of karpenter_tpu/solver/rpc.py with the port's kernels behind the
server: the same length-prefixed binary protocol, byte for byte in both
directions (tests/test_torch_wire.py frames the same header and tensors
with both packages and reads each package's frames with the other's
reader), so the JAX binary's ``SolverClient`` drives this server and this
client drives the JAX server:

    frame := u32 header_len | header_json | payload_bytes
    header := {"op"|"ok": ..., meta..., "tensors": [{name, dtype, shape}], "crc"}
    payload := the tensors' raw little-endian buffers, concatenated

Security posture, as in the JAX package: the default transport is a
UNIX domain socket (mode 0600); a TCP listener requires a shared token
(``token=`` or $KARPENTER_TPU_SOLVER_TOKEN) proven by an ``auth`` frame
first on the connection, unless ``insecure_tcp=True``; TCP can be wrapped
in TLS. Pre-auth frames are capped at 4 KiB.

The server computes on ``device``: None means the card (``cuda``) and
raises without one; only an explicit ``device="cpu"`` runs the kernels'
plain torch versions. On the card every op launches the CUDA kernels --
kernel A (the FFD scan) behind ``solve``, ``solve_compact``,
``solve_delta`` and ``solve_convex``, kernel B (the repack) behind
``solve_disrupt`` -- or crosses the wire as an error frame; it never
computes a plain version in their place.

The fleet's single-device half is here: ``SolverServer(coalescer=)``
routes the five device ops through a ``fleet.coalesce.DispatchCoalescer``
(one dispatcher thread, deterministic tenant order, per-tenant budgets
and breakers; each reply captured in a ``_ReplyBuffer`` and flushed by
the tenant's own handler thread), the ping advertises ``coalesce``, and
``SolverClient(tenant=)`` stamps its tenant id on every op header (a
client without one sends the frames it always sent).

Every device op dispatches through one engine: a ``solver.device_engine.
DeviceEngine`` on ``device``, or with ``SolverServer(mesh=)`` (a
``fleet.shard.MeshSolveEngine`` or a ``parallel.mesh.Mesh``) the sharded
entries -- kernel A once per solve on the primary shard, kernel B once
per shard of a ``solve_disrupt`` repack -- which stamp each staged seqnum
with the topology epoch it was staged under (``tepoch`` in the stage
reply, the ``topology_epoch`` feature). A seqnum staged under an older
epoch restages in place at its next lookup; a device lost mid-dispatch
crosses the wire as ``StaleTopologyError``, which the client's
synchronous ops retry once (``karpenter_mesh_stale_topology_solves_total
{site="client-sync"|"client-disrupt"}``) and its pipelined claim raises
as a ``StaleSeqnumError``. ``--mesh``/``$KARPENTER_TPU_MESH`` count real
devices and exit non-zero when there are too few.

Run the sidecar with ``python -m karpenter_tpu_torch.solver.rpc`` (see
``serve_main``).
"""
from __future__ import annotations

import hmac
import json
import os
import signal
import socket
import socketserver
import struct
import sys
import threading
import zlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

import torch

from karpenter_tpu_torch import failpoints, metrics, overload, tracing
from karpenter_tpu_torch.obs import hbm as obs_hbm
from karpenter_tpu_torch.solver import encode, ffd, packing

TOKEN_ENV = "KARPENTER_TPU_SOLVER_TOKEN"
# kill switch for delta class shipping (solve_delta): the client defaults
# to delta-on whenever the server advertises the feature; "0" forces every
# solve back to the full class-tensor ship
DELTA_ENV = "KARPENTER_TPU_DELTA"
# shared-memory ring transport (solver/shm.py): "0" kills it on either
# side; "1" forces the client to ask even over TCP (colocated-by-config);
# unset, the client asks only on a UNIX-socket transport (the colocated
# sidecar topology the ring exists for)
SHM_ENV = "KARPENTER_TPU_SHM"
# trimmed compact replies (reply_v2): "0" forces the v1 dense reply shape
REPLY_V2_ENV = "KARPENTER_TPU_REPLY_V2"
# consecutive shm-mode stream failures after which a client stops
# re-negotiating the ring and stays on the socket transport (the
# corrupt-shm degrade path: crc failures close the stream; two strikes
# and the segment is considered bad, not the luck)
SHM_MAX_FAILURES = 2

# the per-class tensors delta shipping can patch row-wise. node_overhead
# ([R], whole-set) always ships in full; open_allowed/join_allowed ([C, K]
# merged-multipool masks) bypass the delta path entirely when they ship
# full-width -- bool rows dominate the payload and the merged shape
# re-derives them per tick. BIT-PACKED masks (solver/packing.py, the
# feature-negotiated "packed_masks" wire form) are [C, KW] uint32 rows an
# eighth the size, so they rejoin the row-patch machinery like any other
# per-class tensor (PACKED_MASK_TENSORS below).
PER_CLASS_TENSORS = (
    "req", "count", "env_count", "allowed", "num_lo", "num_hi",
    "azone", "acap", "schedulable",
)
# mask tensors that become row-patchable once packed: only clients that
# negotiated "packed_masks" ship them inside a delta request, so a server
# that advertises the feature is by construction the one patching them
PACKED_MASK_TENSORS = ("open_allowed", "join_allowed")
# kill switch for the packed-mask wire form: "0" ships full-width bool
# masks even to a packed_masks-advertising server
PACKED_MASKS_ENV = "KARPENTER_TPU_PACKED_MASKS"
# never ship a delta when more than this fraction of rows changed: the
# row-index header plus per-row framing overtakes the dense ship
DELTA_MAX_DIRTY_FRACTION = 0.5

# connection ESTABLISHMENT budget (TCP/UNIX connect + TLS handshake +
# auth), split from the solve/read budget: a dead sidecar must fail a
# degraded tick in ~1s, not eat the whole 30s solve budget per call
DEFAULT_CONNECT_TIMEOUT = 1.0


def default_socket_path() -> str:
    """Default sidecar socket location (PURE -- no filesystem side
    effects; callers that will bind/connect run ensure_socket_dir).
    Without XDG_RUNTIME_DIR the fallback is a PER-USER directory, never
    bare /tmp: a predictable world-writable path invites local socket
    squatting (an attacker pre-binds it and serves forged decisions)."""
    base = os.environ.get("XDG_RUNTIME_DIR") or f"/tmp/karpenter-tpu-{os.getuid()}"
    return os.path.join(base, "karpenter-tpu-solver.sock")


def ensure_socket_dir(path: str) -> None:
    """Create the socket's parent as mode 0700 and enforce ownership
    loudly: chmod on another user's squatted directory raises EPERM
    instead of silently trusting it."""
    parent = os.path.dirname(path) or "."
    os.makedirs(parent, mode=0o700, exist_ok=True)
    if parent not in ("/tmp", "/run", "."):
        os.chmod(parent, 0o700)

_LEN = struct.Struct("<I")
MAX_FRAME = 256 * 1024 * 1024


# -- framing -----------------------------------------------------------------
#
# Wire v2: the framing is ZERO-COPY end to end on the hot path.
# Encode ships C-contiguous tensor buffers as a scatter-gather send
# (socket.sendmsg / RingEndpoint.sendmsg over memoryviews -- no tobytes(),
# no join); decode receives straight INTO the final tensor buffers
# (recv_into over a numpy allocation) and hands out read-only views.
# Every residual copy is counted into karpenter_wire_payload_copies_total
# -- the warm delta path's counters read 0, test-asserted.


def _transport(sock) -> str:
    """Metric label for the wire a frame moved over: 'shm' for ring
    endpoints (solver/shm.py), 'tcp' for any socket (TCP or UNIX)."""
    return getattr(sock, "transport_label", "tcp")


def _payload_views(tensors: Sequence[Tuple[str, np.ndarray]]):
    """(byte views, copy count, total bytes) for a frame's payload.
    C-contiguous arrays (everything the production encode produces) view
    for free; a non-contiguous tensor pays one copy, counted."""
    views, copies, nbytes = [], 0, 0
    for _, a in tensors:
        c = np.ascontiguousarray(a)
        if c is not a:
            copies += 1
        if c.size == 0:
            continue  # nothing on the wire; the header still records the shape
        if c.ndim == 0:
            c = c.reshape(1)  # 0-d buffers cannot cast; the header keeps shape []
        views.append(memoryview(c).cast("B"))
        nbytes += c.nbytes
    return views, copies, nbytes


def _sendmsg_all(sock, bufs) -> None:
    """Drive a scatter-gather buffer list fully onto the wire (sendmsg
    may send fewer bytes than offered). Raises NotImplementedError
    untouched when the socket cannot scatter-gather (TLS) -- nothing has
    been sent at that point, so the caller's join fallback is safe."""
    bufs = [b if isinstance(b, memoryview) else memoryview(b) for b in bufs]
    while bufs:
        sent = sock.sendmsg(bufs)
        while bufs and sent >= len(bufs[0]):
            sent -= len(bufs[0])
            bufs.pop(0)
        if bufs and sent:
            bufs[0] = bufs[0][sent:]


def _send_frame(sock, header: dict, tensors: Sequence[Tuple[str, np.ndarray]] = ()) -> None:
    failpoints.eval("rpc.send")
    header = dict(header)
    header["tensors"] = [
        {"name": name, "dtype": str(a.dtype), "shape": list(a.shape)} for name, a in tensors
    ]
    views, copies, payload_bytes = _payload_views(tensors)
    if views:
        # payload integrity: one crc32 STREAMED over the tensor views (no
        # intermediate concatenation). A flipped bit in a decision tensor
        # would otherwise decode into a silently WRONG placement; with the
        # checksum it surfaces as a ConnectionError and the caller degrades
        # through the ladder to a recomputed (correct) decision. Old peers
        # ignore the extra header field; frames from old peers skip the check.
        crc = 0
        for v in views:
            crc = zlib.crc32(v, crc)
        header["crc"] = crc
    hb = json.dumps(header).encode()
    prefix = _LEN.pack(len(hb)) + hb
    if copies:
        metrics.WIRE_PAYLOAD_COPIES.inc(copies, side="encode")
    metrics.WIRE_BYTES.inc(
        len(prefix) + payload_bytes, direction="sent", transport=_transport(sock)
    )
    if failpoints.live("rpc.frame.corrupt") is not None:
        # chaos path: the corrupt site needs the whole frame as one buffer
        # to flip a deterministic byte past the length prefix; the joining
        # copy is acceptable while THIS site can still fire (and counted)
        # -- a drill on an unrelated site, or one already spent, must not
        # cost the zero-copy path
        data = failpoints.corrupt("rpc.frame.corrupt", b"".join([prefix] + views))
        if views:
            metrics.WIRE_PAYLOAD_COPIES.inc(side="encode")
        sock.sendall(data)
        return
    try:
        _sendmsg_all(sock, [prefix] + views)
    except (NotImplementedError, AttributeError):
        # TLS sockets cannot scatter-gather (and encrypt-copy anyway):
        # join and send -- the one transport where the copy is inherent
        if views:
            metrics.WIRE_PAYLOAD_COPIES.inc(side="encode")
        sock.sendall(b"".join([prefix] + views))


def _recv_exact(sock, n: int) -> bytes:
    """Header reads share the recv_into discipline of the tensor path:
    one preallocated buffer filled in place (delta headers carry the
    dirty-row index list -- KBs at high churn, not worth re-buffering)."""
    buf = bytearray(n)
    _recv_exact_into(sock, memoryview(buf))
    return bytes(buf)


def _recv_exact_into(sock, view: memoryview) -> None:
    """Fill `view` completely from the wire -- the zero-copy receive: the
    destination IS the final tensor buffer, there is no intermediate."""
    got, n = 0, len(view)
    while got < n:
        r = sock.recv_into(view[got:])
        if not r:
            raise ConnectionError("peer closed mid-frame")
        got += r


def _recv_frame(sock, limit: int = MAX_FRAME) -> Tuple[dict, Dict[str, np.ndarray]]:
    failpoints.eval("rpc.recv")
    (hlen,) = _LEN.unpack(_recv_exact(sock, 4))
    if hlen > limit:
        raise ConnectionError(f"oversized header ({hlen} bytes)")
    # a corrupted frame must surface as a CONNECTION error, not a stray
    # JSONDecodeError/TypeError escaping into the solve: the stream is
    # desynchronized either way, and ConnectionError is what every caller
    # (reconnect ladders, the breaker) already handles
    try:
        header = json.loads(_recv_exact(sock, hlen))
        if not isinstance(header, dict):
            raise ValueError("frame header is not an object")
    except ValueError as e:
        raise ConnectionError(f"corrupt frame header: {e}") from None
    tensors: Dict[str, np.ndarray] = {}
    total = 0
    crc = 0
    try:
        for spec in header.get("tensors", ()):
            dtype = np.dtype(spec["dtype"])
            shape = [int(s) for s in spec["shape"]]
            if any(s < 0 for s in shape):
                raise ConnectionError(f"negative dimension in {spec}")
            count = int(np.prod(shape, dtype=np.int64)) if shape else 1
            nbytes = count * dtype.itemsize
            total += nbytes
            # bound the payload BEFORE allocating: a hostile header must not be
            # able to make the sidecar allocate unbounded buffers
            if nbytes > limit or total > limit:
                raise ConnectionError(f"oversized tensor payload ({total} bytes)")
            # receive DIRECTLY into the tensor's own allocation -- the
            # decode-side zero copy -- then hand out a read-only view,
            # mirroring the frombuffer-over-bytes contract every consumer
            # (solve inputs, epoch store, reply decode) already tolerates
            raw = np.empty((nbytes,), dtype=np.uint8)
            mv = memoryview(raw)
            _recv_exact_into(sock, mv)
            crc = zlib.crc32(mv, crc)
            arr = raw.view(dtype).reshape(shape)
            arr.flags.writeable = False
            tensors[spec["name"]] = arr
    except (TypeError, ValueError, KeyError) as e:
        raise ConnectionError(f"corrupt tensor spec: {e}") from None
    want = header.get("crc")
    if want is not None and tensors and crc != int(want):
        raise ConnectionError("frame payload crc mismatch")
    metrics.WIRE_BYTES.inc(
        4 + hlen + total, direction="received", transport=_transport(sock)
    )
    return header, tensors


# -- reply trimming (reply_v2) ------------------------------------------------
#
# The v1 compact reply ships full g_max-row group tensors and the whole
# nnz_max sparse budget even though only n_open groups opened and nnz
# entries are real -- at the 50k tier that is ~120 KB of mostly padding
# and repetition per solve. reply_v2 (feature-negotiated like solve_delta)
# ships only the DECISION ROWS: idx/val truncated to the true nnz, and
# the per-group (survivor mask, zone/captype) rows deduplicated -- FFD
# opens groups in runs, so consecutive groups repeat the same row; the
# unique rows plus a per-group index reconstruct the dense form exactly.
# The client's vectorized reconstruction (expand_reply_v2) rebuilds a
# CompactDecision bit-identical in every decision-bearing lane, so
# expand_compact and the whole decode are unchanged downstream.

def _reply_v2_parts(d: Dict[str, np.ndarray]):
    """(extra header fields, tensor list) for a trimmed v2 reply, from
    the fetched CompactDecision arrays by field name."""
    idx = np.atleast_1d(np.asarray(d["idx"]))
    val = np.atleast_1d(np.asarray(d["val"]))
    unplaced = np.atleast_1d(np.asarray(d["unplaced"]))
    nnz = int(np.asarray(d["nnz"]).reshape(()))
    n_open = int(np.asarray(d["n_open"]).reshape(()))
    hdr = {"v": 2, "nnz": nnz, "n_open": n_open}
    if nnz > idx.shape[0]:
        # sparse-budget overflow: the compact decision is incomplete
        # either way; ship no tensors and let the client's dense-refetch
        # ladder take over (expand_compact returns None on nnz > len(idx))
        return hdr, []
    gmask_bits = np.asarray(d["gmask_bits"])[:n_open]
    gzc = np.asarray(d["gzc"])[:n_open]
    rows = np.concatenate([gmask_bits, gzc[:, None]], axis=1)
    uniq, gid = np.unique(rows, axis=0, return_inverse=True)
    tensors = [
        ("idx", idx[:nnz]), ("val", val[:nnz]), ("unplaced", unplaced),
        ("uniq", np.ascontiguousarray(uniq)),
        ("gid", np.ascontiguousarray(gid.reshape(-1).astype(np.int32))),
    ]
    return hdr, tensors


def expand_reply_v2(header: dict, t: Dict[str, np.ndarray], g_max: int):
    """Vectorized client-side reconstruction of a v2 reply into a
    CompactDecision (numpy leaves). Group rows rebuild as one fancy-index
    over the unique-row table plus zero padding to g_max (decode never
    reads past n_open). An overflow reply reconstructs with an empty idx,
    which expand_compact maps to None -- the existing dense-refetch
    ladder, unchanged."""
    nnz = int(header["nnz"])
    n_open = int(header["n_open"])
    if "idx" not in t:  # overflow: no tensors shipped
        return ffd.CompactDecision(
            idx=np.empty((0,), np.int32), val=np.empty((0,), np.int32),
            nnz=np.int32(max(nnz, 1)), unplaced=np.empty((0,), np.int32),
            n_open=np.int32(n_open), gmask_bits=np.empty((0, 0), np.uint32),
            gzc=np.empty((0,), np.uint32),
        )
    uniq = np.asarray(t["uniq"])
    gid = np.asarray(t["gid"]).reshape(-1)
    kw = max(uniq.shape[1] - 1, 0)
    gmask_bits = np.zeros((g_max, kw), dtype=np.uint32)
    gzc = np.zeros((g_max,), dtype=np.uint32)
    if n_open:
        rows = uniq[gid]
        gmask_bits[:n_open] = rows[:, :kw]
        gzc[:n_open] = rows[:, kw]
    return ffd.CompactDecision(
        idx=t["idx"], val=t["val"], nnz=np.int32(nnz),
        unplaced=t["unplaced"], n_open=np.int32(n_open),
        gmask_bits=gmask_bits, gzc=gzc,
    )


# -- server ------------------------------------------------------------------

class _ReplyBuffer:
    """Capture a coalesced op's reply frames in memory so the SHARED
    dispatcher thread never blocks on one tenant's socket: a stalled
    operator (full TCP window, SIGSTOP'd controller) must cost ITS
    handler thread at flush time, never head-of-line-block every other
    tenant's window. Quacks like the frame wire for _send_frame's
    purposes (sendmsg/sendall + the transport label: the tenant's ring
    or socket); the one buffered copy per reply is the price of the
    isolation and replies are small (reply_v2 trims them to the decision
    rows)."""

    def __init__(self, sock):
        self.transport_label = _transport(sock)
        self._chunks: List[bytes] = []

    def sendmsg(self, bufs) -> int:
        n = 0
        for b in bufs:
            bb = bytes(b)
            self._chunks.append(bb)
            n += len(bb)
        return n

    def sendall(self, data) -> None:
        self._chunks.append(bytes(data))

    def flush_to(self, sock) -> None:
        """Write the buffered frames onto the real wire -- called from
        the submitting connection's own handler thread."""
        for chunk in self._chunks:
            sock.sendall(chunk)
        self._chunks.clear()


class _StagedEntry:
    def __init__(self, staged, offsets, words, tepoch=None, catalog=None):
        self.staged = staged
        self.offsets = offsets
        self.words = words
        # the engine's stamp (a mesh's only): the topology epoch the catalog
        # was staged under, and the HOST catalog tensors so a topology change can be
        # healed server-side (one transparent restage at lookup -- the
        # client keeps its seqnum, no wire round-trip, no restage loop)
        self.tepoch = tepoch
        self.catalog = catalog


class SolverServer:
    """Serves auth/stage/solve/ping over persistent connections. One staged
    catalog per seqnum (bounded LRU of 4: catalogs change 12-hourly).

    Transports: `path` -> UNIX domain socket (mode 0600, the default
    deployment); `host`/`port` -> TCP, which REQUIRES a shared token
    unless `insecure_tcp=True`; `ssl_context` optionally wraps accepted
    TCP connections in TLS. `device`: None = the card, "cpu" = the
    kernels' plain versions (the tests). `coalescer`: a
    fleet.coalesce.DispatchCoalescer batching concurrent per-tenant
    solve ops into shared dispatch windows. `mesh`: a MeshSolveEngine (or
    a Mesh) routing every device dispatch through the sharded entries;
    the server then computes on the mesh's primary device (`device`
    must be None or that device)."""

    def __init__(
        self, host: str = "127.0.0.1", port: int = 0, *,
        path: Optional[str] = None, token: Optional[str] = None,
        insecure_tcp: bool = False, ssl_context=None,
        handshake_timeout: float = 30.0,
        shm: Optional[bool] = None, shm_size: Optional[int] = None,
        shm_dir: Optional[str] = None, device=None,
        mesh=None, coalescer=None,
    ):
        from karpenter_tpu_torch.solver import shm as shm_mod
        from karpenter_tpu_torch.solver.device_engine import DeviceEngine
        from karpenter_tpu_torch.solver.service import resolve_device

        # fleet subsystem (fleet/): `mesh` shards every device op but the
        # convex relaxation -- sharded == unsharded byte identity means the
        # wire contract is byte-unchanged
        if mesh is not None:
            from karpenter_tpu_torch.fleet.shard import MeshSolveEngine

            if not isinstance(mesh, MeshSolveEngine):
                mesh = MeshSolveEngine(mesh)
            from karpenter_tpu_torch.parallel.mesh import _norm_device

            if device is not None and _norm_device(device) != mesh.device:
                raise ValueError(f"SolverServer(device={device!r}) differs from the mesh's "
                                 f"primary device {mesh.device}")
            device = mesh.device
        self._mesh = mesh
        self.device = resolve_device(device)
        self._device_engine = DeviceEngine(self.device)
        self._engine = mesh if mesh is not None else self._device_engine
        # fleet subsystem (fleet/): `coalescer` is a DispatchCoalescer
        # batching concurrent per-tenant solve ops into shared dispatch
        # windows on its one dispatcher thread
        self._coalescer = coalescer
        # shared-memory ring transport (solver/shm.py): advertised in ping
        # features and established per connection via the shm_open op.
        # Default on (the client only asks when IT decides the topology is
        # colocated); $KARPENTER_TPU_SHM=0 or shm=False kills the advert.
        if shm is None:
            shm = os.environ.get(SHM_ENV, "1") != "0"
        self._shm_enabled = bool(shm)
        self._shm_size = shm_size or shm_mod.ring_size()
        self._shm_dir = shm_dir
        # crash janitor: unlink ring segments whose creator pid is dead
        # (a SIGKILL'd sidecar cannot clean after itself). Runs even with
        # shm disabled.
        shm_mod.cleanup_stale(self._shm_dir)
        # live per-connection ring segments: stop() flags them closed so a
        # handler blocked in a ring wait wakes and tears down
        self._live_segs: set = set()
        self._staged: Dict[str, _StagedEntry] = {}
        # class-tensor epochs (solve_delta): epoch id -> {name: np array},
        # the full class tensor set as of that epoch, patched row-wise by
        # delta solves. Same bounded-LRU discipline as the catalog staging.
        self._epochs: Dict[str, Dict[str, np.ndarray]] = {}
        # disrupt leftover epochs (solve_disrupt): depoch id -> [S, C]
        # leftover tensor from a repack pass, referenced by the same
        # sweep's per-pool replacement passes
        self._disrupt: Dict[str, np.ndarray] = {}
        # eviction accounting, mirrored into
        # karpenter_solver_staged_evictions_total and served by "debug"
        self._evictions = {"catalog": 0, "class_epoch": 0, "disrupt": 0}
        self._lock = threading.Lock()
        self._handshake_timeout = handshake_timeout
        self._token = token if token is not None else os.environ.get(TOKEN_ENV)
        # an empty token is UNSET, not a guessable one-value secret
        if not self._token:
            self._token = None
        if path is None and self._token is None and not insecure_tcp:
            raise ValueError(
                "a TCP solver listener requires a shared token (token= or "
                f"${TOKEN_ENV}); pass insecure_tcp=True only as an explicit "
                "operator decision, or use a UNIX socket (path=)"
            )
        outer = self

        class Handler(socketserver.BaseRequestHandler):
            def handle(self):
                # per-connection auth state: with a token configured, the
                # FIRST frame must be a valid auth op; anything else closes
                # the connection. Pre-auth frames are capped at 4 KB.
                authed = outer._token is None
                # the frame wire: the socket, or the ring endpoint after a
                # successful shm_open handshake (the socket stays open as
                # the liveness anchor and the teardown signal)
                wire = self.request
                seg = None
                try:
                    if ssl_context is not None:
                        # handshake in THIS per-connection thread, bounded
                        self.request.settimeout(outer._handshake_timeout)
                        self.request = ssl_context.wrap_socket(
                            self.request, server_side=True
                        )
                        self.request.settimeout(None)
                        wire = self.request
                    while True:
                        # chaos site: a connection-drop closes the stream
                        # mid-conversation (the handler's except path)
                        failpoints.eval("rpc.server.conn")
                        header, tensors = _recv_frame(
                            wire,
                            limit=MAX_FRAME if authed else 4096,
                        )
                        op = header.get("op")
                        if op == "auth":
                            supplied = str(header.get("token", ""))
                            if outer._token is None or hmac.compare_digest(
                                supplied, outer._token
                            ):
                                authed = True
                                _send_frame(wire, {"ok": True})
                                continue
                            _send_frame(
                                wire, {"ok": False, "error": "unauthenticated"}
                            )
                            return
                        if not authed:
                            _send_frame(
                                wire, {"ok": False, "error": "unauthenticated"}
                            )
                            return
                        if op == "shm_open":
                            wire, seg = outer._op_shm_open(self.request, wire, seg)
                            continue
                        outer._dispatch(wire, header, tensors)
                except (ConnectionError, OSError, ValueError):
                    return
                finally:
                    if seg is not None:
                        # per-connection segment: unlink with the stream
                        with outer._lock:
                            outer._live_segs.discard(seg)
                        seg.destroy()

        if path is not None:
            class Server(socketserver.ThreadingUnixStreamServer):
                daemon_threads = True

            try:
                os.unlink(path)
            except OSError:
                pass
            # bind under a restrictive umask: chmod-after-bind leaves a
            # window where any local user could connect
            old_umask = os.umask(0o177)
            try:
                self._server = Server(path, Handler)
            finally:
                os.umask(old_umask)
            os.chmod(path, 0o600)
            self.address = path
            self.path = path
        else:
            class Server(socketserver.ThreadingTCPServer):
                allow_reuse_address = True
                daemon_threads = True

            self._server = Server((host, port), Handler)
            self.address = self._server.server_address
            self.path = None
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "SolverServer":
        self._thread = threading.Thread(target=self._server.serve_forever, daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        if self._coalescer is not None:
            # fail queued tenant submissions first so handler threads
            # blocked in submit() unwind before the listener dies
            self._coalescer.close()
        with self._lock:
            segs = list(self._live_segs)
        for seg in segs:
            # both closed flags: wake EITHER side's ring wait so the
            # handler unblocks, tears down, and unlinks the segment
            seg.set_closed_flags()
        self._server.shutdown()
        self._server.server_close()

    # -- ops ----------------------------------------------------------------
    def _dispatch(self, sock, header: dict, tensors: Dict[str, np.ndarray]) -> None:
        op = header.get("op")
        # trace propagation (tracing.py): a request carrying a "trace"
        # context gets its server-side stages timed and ECHOED in the
        # reply header; untraced requests pay nothing
        wt = tracing.WireTrace(header.get("trace"))
        try:
            # chaos site INSIDE the try: an injected error crosses the wire
            # as an error frame (an erroring solver)
            failpoints.eval("rpc.server.dispatch")
            if op == "ping":
                # features lets a client decide whether semantics it
                # depends on exist server-side (the JAX server's list
                # without a mesh)
                features = [
                    "join_allowed", "trace_echo", "solve_delta", "reply_v2",
                    "solve_disrupt", "packed_masks", "topology_epoch",
                    "convex",
                ]
                if self._shm_enabled:
                    features.append("shm")
                if self._coalescer is not None:
                    features.append("coalesce")
                _send_frame(sock, {"ok": True, "features": features})
            elif op == "stage":
                self._op_stage(sock, header, tensors)
            elif op in ("solve", "solve_compact", "solve_delta", "solve_disrupt",
                        "solve_convex"):
                if self._coalescer is not None:
                    # fleet topology: device dispatches from N tenants
                    # batch into shared windows with deterministic tenant
                    # ordering; a TenantRefusal (breaker open, deadline
                    # blown while queued) or a per-tenant dispatch error
                    # re-raises HERE -- in this tenant's handler thread --
                    # and crosses the wire as ITS error reply below,
                    # never another tenant's. The reply itself buffers
                    # inside the window and flushes from THIS thread, so
                    # a stalled tenant socket can never head-of-line-
                    # block the shared dispatcher.
                    reply = _ReplyBuffer(sock)
                    self._coalescer.submit(
                        str(header.get("tenant", "")),
                        lambda: self._dispatch_solve(reply, op, header, tensors, wt),
                    )
                    reply.flush_to(sock)
                else:
                    self._dispatch_solve(sock, op, header, tensors, wt)
            elif op == "debug":
                self._op_debug(sock)
            else:
                _send_frame(sock, {"ok": False, "error": f"unknown op {op!r}"})
        except Exception as e:  # noqa: BLE001 -- errors cross the wire
            _send_frame(sock, {"ok": False, "error": f"{type(e).__name__}: {e}"})

    def _dispatch_solve(self, sock, op: str, header: dict,
                        tensors: Dict[str, np.ndarray], wt) -> None:
        """The device-dispatching ops (everything the fleet coalescer
        batches); replies stream on the submitting connection's wire."""
        if op == "solve":
            self._op_solve(sock, header, tensors, wt)
        elif op == "solve_compact":
            self._op_solve_compact(sock, header, tensors, wt)
        elif op == "solve_delta":
            self._op_solve_delta(sock, header, tensors, wt)
        elif op == "solve_convex":
            self._op_solve_convex(sock, header, tensors, wt)
        else:
            self._op_solve_disrupt(sock, header, tensors, wt)

    def _sync(self, wt) -> None:
        """Traced requests wait for the card inside the "device" stage, so
        the echo attributes the kernels' time to it rather than to
        "fetch"; untraced requests keep the launch->fetch overlap."""
        if wt.ctx is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _op_shm_open(self, sock, wire, seg):
        """Transport-level handshake for the shared-memory ring (handled
        in the connection loop, not _dispatch: it rebinds the wire). The
        server creates a per-connection segment, names it over the
        SOCKET, and switches to the ring only after the client confirms
        its attach with shm_ready. Returns (wire, seg)."""
        from karpenter_tpu_torch.solver import shm as shm_mod

        if seg is not None or wire is not sock or not self._shm_enabled:
            _send_frame(wire, {"ok": False, "error": "shm-unavailable"})
            return wire, seg
        try:
            new_seg = shm_mod.ShmSegment.create(self._shm_size, self._shm_dir)
        except OSError as e:
            _send_frame(sock, {"ok": False, "error": f"shm-create: {e}"})
            return wire, seg
        try:
            _send_frame(sock, {"ok": True, "path": new_seg.path, "size": new_seg.size})
            # shm_ready rides the socket, BOUNDED: a client that dies
            # mid-handshake must neither pin this thread nor leak the segment
            prev_timeout = sock.gettimeout()
            sock.settimeout(self._handshake_timeout)
            try:
                header, _ = _recv_frame(sock)
            finally:
                sock.settimeout(prev_timeout)
        except BaseException:
            new_seg.destroy()
            raise
        if header.get("op") == "shm_ready" and header.get("ok"):
            with self._lock:
                self._live_segs.add(new_seg)
            # reads park with timeout=None between operator ticks; reply
            # SENDS are bounded by the handshake budget
            return new_seg.endpoint(
                "server", liveness=sock, send_timeout=self._handshake_timeout
            ), new_seg
        new_seg.destroy()
        return sock, None

    def _op_stage(self, sock, header: dict, t: Dict[str, np.ndarray]) -> None:
        seqnum = str(header["seqnum"])
        words = tuple(int(w) for w in header["words"])
        catalog = encode.CatalogTensors(
            names=list(header["names"]), k_real=int(header["k_real"]),
            k_pad=int(t["cap"].shape[0]), cap=t["cap"], tcode=t["tcode"],
            tnum=t["tnum"], tnum_present=t["tnum_present"], tzone=t["tzone"],
            tcap=t["tcap"], price=t["price"], vocabs=[], zones=list(header["zones"]),
            words=list(words),
        )
        # staged once per seqnum; a mesh's epoch stamp keeps the HOST
        # tensors so an epoch change restages at the next lookup
        staged, offsets, words, tepoch = self._engine.stage_catalog_versioned(catalog)
        with self._lock:
            if len(self._staged) >= 4 and seqnum not in self._staged:
                self._staged.pop(next(iter(self._staged)))
                self._evictions["catalog"] += 1
                metrics.SOLVER_STAGED_EVICTIONS.inc(kind="catalog")
            self._staged[seqnum] = _StagedEntry(
                staged, offsets, words, tepoch=tepoch,
                catalog=catalog if tepoch is not None else None,
            )
            self._evict_for_pressure_locked()
            self._staged_bytes_locked()
        reply = {"ok": True, "seqnum": seqnum}
        if tepoch is not None:
            reply["tepoch"] = int(tepoch)
        _send_frame(sock, reply)

    def _staged_bytes_locked(self) -> Dict[str, int]:
        """Staged bytes by owner (obs/hbm.py attribution), mirrored into
        karpenter_solver_staged_bytes{kind}. Caller holds the lock."""
        catalog = sum(obs_hbm.sum_nbytes(e) for e in self._staged.values())
        epochs = sum(obs_hbm.sum_nbytes(e) for e in self._epochs.values())
        disrupt = sum(obs_hbm.sum_nbytes(e) for e in self._disrupt.values())
        metrics.SOLVER_STAGED_BYTES.set(float(catalog), kind="catalog")
        metrics.SOLVER_STAGED_BYTES.set(float(epochs), kind="class_epoch")
        metrics.SOLVER_STAGED_BYTES.set(float(disrupt), kind="disrupt")
        return {
            "catalog": int(catalog), "class_epoch": int(epochs),
            "disrupt": int(disrupt),
        }

    def _evict_for_pressure_locked(self) -> None:
        """Memory-pressure eviction (obs/hbm.py): headroom below the
        evict threshold shrinks every staging LRU to its most recently
        used entry -- dropping the references frees the device tensors.
        No allocator ledger (the CPU) = capacity-only. Caller holds the
        lock."""
        if len(self._staged) <= 1 and len(self._epochs) <= 1 and len(self._disrupt) <= 1:
            return
        if not obs_hbm.under_pressure():
            return
        for kind, lru in (("catalog", self._staged), ("class_epoch", self._epochs),
                          ("disrupt", self._disrupt)):
            while len(lru) > 1:
                lru.pop(next(iter(lru)))
                self._evictions[kind] += 1
                metrics.SOLVER_STAGED_EVICTIONS.inc(kind=kind)
                metrics.SOLVER_STAGED_PRESSURE_EVICTIONS.inc(kind=kind)

    def _op_debug(self, sock) -> None:
        """Staging observability: what the LRUs hold, their bytes by
        owner, and how often they evicted (the sidecar topology's source
        for /debug/solver)."""
        with self._lock:
            doc = {
                "ok": True,
                "staged_seqnums": list(self._staged),
                "class_epochs": list(self._epochs),
                "disrupt_epochs": list(self._disrupt),
                "evictions": dict(self._evictions),
                "staged_bytes": self._staged_bytes_locked(),
            }
        if self._mesh is not None:
            doc["mesh"] = self._mesh.describe()
        if self._coalescer is not None:
            doc["coalescer"] = self._coalescer.describe()
        _send_frame(sock, doc)

    def _op_solve_delta(self, sock, header: dict, t: Dict[str, np.ndarray],
                        wt: Optional[tracing.WireTrace] = None) -> None:
        """Compact solve whose class tensors are staged server-side under a
        class-EPOCH id. base=None ships the full tensor set and
        establishes the epoch; base=<epoch> ships only the dirty rows
        (header "rows") and patches the base epoch. An unknown base is an
        "unknown-epoch" error -- the client full-restages."""
        # catalog gap first: a restarted sidecar lost BOTH stagings, and
        # reporting the seqnum gap restages catalog + epoch in one pass
        with self._lock:
            known = str(header["seqnum"]) in self._staged
        if not known:
            _send_frame(sock, {"ok": False, "error": "unknown-seqnum"})
            return
        full = self._resolve_epoch(sock, header, t)
        if full is None:
            return
        self._op_solve_compact(sock, header, full, wt)

    def _resolve_epoch(self, sock, header: dict, t: Dict[str, np.ndarray]):
        """The full class tensor dict for this solve_delta request, staged
        under header["epoch"], or None after sending the unknown-epoch
        error. A full ship stores the received read-only frame views
        as-is; a delta patch mutates its chain's base IN PLACE (one writer
        per chain: epoch ids are client-unique and one connection is
        served in order), copying a read-only view once on its first
        patch -- counted in karpenter_wire_payload_copies_total
        {side="decode"}."""
        epoch = str(header["epoch"])
        base = header.get("base")
        if base is not None:
            with self._lock:
                ent = self._epochs.get(str(base))
                if ent is not None:
                    # LRU touch, same discipline as the catalog staging
                    self._epochs.pop(str(base))
                    self._epochs[str(base)] = ent
            if ent is None:
                _send_frame(sock, {"ok": False, "error": "unknown-epoch"})
                return None
            full = dict(ent)
            rows = np.asarray([int(r) for r in header.get("rows", ())], dtype=np.int64)
            for name, arr in t.items():
                if name not in PER_CLASS_TENSORS and name not in PACKED_MASK_TENSORS:
                    full[name] = arr  # whole-set tensors replace wholesale
                elif rows.size:
                    cur = full[name]
                    if not cur.flags.writeable:
                        # copy-on-first-write: the base still holds the
                        # full ship's read-only frame views
                        cur = np.array(cur)
                        metrics.WIRE_PAYLOAD_COPIES.inc(side="decode")
                    cur[rows] = arr
                    full[name] = cur
        else:
            full = dict(t)
        with self._lock:
            if base is not None:
                # the patched base is superseded (each client chain diffs
                # against its LAST acknowledged epoch)
                self._epochs.pop(str(base), None)
            self._epochs[epoch] = full
            while len(self._epochs) > 4:
                self._epochs.pop(next(iter(self._epochs)))
                self._evictions["class_epoch"] += 1
                metrics.SOLVER_STAGED_EVICTIONS.inc(kind="class_epoch")
            self._evict_for_pressure_locked()
            self._staged_bytes_locked()
        return full

    def _staged_entry(self, sock, header: dict) -> Optional[_StagedEntry]:
        """The staged catalog named by the header's seqnum (LRU-touched),
        or None after sending the unknown-seqnum error (the client
        re-stages on that contract)."""
        seqnum = str(header["seqnum"])
        with self._lock:
            entry = self._staged.get(seqnum)
            if entry is not None:
                self._staged.pop(seqnum)
                self._staged[seqnum] = entry
            if entry is not None and entry.tepoch != self._engine.epoch:
                # topology changed since this seqnum staged: heal HERE --
                # one transparent restage onto the current mesh, in place,
                # under the lock (exactly once per epoch change; the
                # client keeps its seqnum and never sees a staging gap).
                # A device loss DURING the solve itself still surfaces as
                # StaleTopologyError through the dispatch guard.
                metrics.MESH_STALE_SOLVES.inc(site="server-restage")
                staged, offsets, words, tepoch = (
                    self._engine.stage_catalog_versioned(entry.catalog))
                entry.staged, entry.offsets, entry.words = staged, offsets, words
                entry.tepoch = tepoch
        if entry is None:
            _send_frame(sock, {"ok": False, "error": "unknown-seqnum"})
        return entry

    def _staged_inputs(self, sock, header: dict, t: Dict[str, np.ndarray]):
        """(entry, SolveInputs on the server's device) for the staged
        catalog named by the header's seqnum, or None after sending the
        unknown-seqnum error. Absent node_overhead / open_allowed /
        join_allowed mean no reserve and no restriction, as in the JAX
        server; the masks go to the device bit-packed, whichever form
        they shipped in."""
        entry = self._staged_entry(sock, header)
        if entry is None:
            return None
        inp = ffd._class_inputs(entry.staged, dict(t), True, entry.staged.cap.device)
        return entry, inp

    def _op_solve(self, sock, header: dict, t: Dict[str, np.ndarray],
                  wt: Optional[tracing.WireTrace] = None) -> None:
        """The dense op: SolveOutputs, every field shipped."""
        wt = wt or tracing.WireTrace(None)
        hit = self._staged_inputs(sock, header, t)
        if hit is None:
            return
        entry, inp = hit
        with wt.stage("device", op="solve"):
            kw = dict(g_max=int(header["g_max"]), word_offsets=entry.offsets,
                      words=entry.words, objective=str(header.get("objective", "price")))
            out = self._engine.solve_dense(inp, epoch=entry.tepoch, **kw)
            self._sync(wt)
        with wt.stage("fetch"):
            arrays = [a.cpu().numpy() for a in out]
        _send_frame(
            sock, {"ok": True, **wt.echo()},
            list(zip(ffd.SolveOutputs._fields, arrays)),
        )

    def _op_solve_compact(self, sock, header: dict, t: Dict[str, np.ndarray],
                          wt: Optional[tracing.WireTrace] = None) -> None:
        """The wire-efficient solve: the decision returns as a
        CompactDecision -- trimmed to its decision rows (reply_v2) when
        the client asks -- instead of the dense SolveOutputs."""
        wt = wt or tracing.WireTrace(None)
        hit = self._staged_inputs(sock, header, t)
        if hit is None:
            return
        entry, inp = hit
        with wt.stage("device", op="solve_compact"):
            kw = dict(g_max=int(header["g_max"]), nnz_max=int(header["nnz_max"]),
                      word_offsets=entry.offsets, words=entry.words,
                      objective=str(header.get("objective", "price")))
            dec = self._engine.solve_compact(inp, epoch=entry.tepoch, **kw)
            self._sync(wt)
        with wt.stage("fetch"):
            arrays = ffd.fetch_compact(dec)
        if int(header.get("reply", 1)) >= 2:
            hdr2, tensors2 = _reply_v2_parts(arrays)
            _send_frame(sock, {"ok": True, **hdr2, **wt.echo()}, tensors2)
            return
        _send_frame(
            sock, {"ok": True, **wt.echo()},
            [(n, np.atleast_1d(arrays[n])) for n in ffd.CompactDecision._fields],
        )

    def _op_solve_convex(self, sock, header: dict, t: Dict[str, np.ndarray],
                         wt: Optional[tracing.WireTrace] = None) -> None:
        """The convex global-solve op: ONE roundtrip runs the FFD scan,
        the LP relaxation behind it, the deterministic rounding and the
        never-worse differential, and replies with the CHOSEN dense
        decision plus the certificate (winner, lower bound, iterations)
        in the header. A rounding failure is the FFD rung, flagged with
        fallback=True."""
        from karpenter_tpu_torch.solver.convex import relax as convex_relax
        from karpenter_tpu_torch.solver.convex import rounding as convex_rounding
        from karpenter_tpu_torch.solver.convex import tier as convex_tier

        wt = wt or tracing.WireTrace(None)
        hit = self._staged_inputs(sock, header, t)
        if hit is None:
            return
        entry, inp = hit
        g_max = int(header["g_max"])
        iters = int(header.get("iters", convex_relax.DEFAULT_ITERS))
        objective = str(header.get("objective", "price"))
        with wt.stage("device", op="solve_convex"):
            out = self._engine.solve_dense(
                inp, g_max=g_max, word_offsets=entry.offsets, words=entry.words,
                objective=objective, epoch=entry.tepoch,
            )
            cx = self._device_engine.convex_relax(
                inp, iters=iters, word_offsets=entry.offsets, words=entry.words,
            )
            self._sync(wt)
        with wt.stage("fetch"):
            f = ffd.SolveOutputs(*(a.cpu().numpy() for a in out))
            dense_ffd = (f.take, f.unplaced, int(f.n_open), f.gmask, f.gzone, f.gcap)
            x, lower, trace = convex_relax.fetch_relax(cx)
            feas = cx.feas.cpu().numpy()
            cap = inp.cap.cpu().numpy()
            price = inp.price.cpu().numpy()
            tzone = inp.tzone.cpu().numpy()
            tcap = inp.tcap.cpu().numpy()
            overhead = inp.node_overhead.cpu().numpy()
        cap_eff = np.maximum(cap.astype(np.float64) - overhead[None, :], 0.0)
        try:
            dense_cx = convex_rounding.round_arrays(
                x, feas=feas, cap_eff=cap_eff, price=price,
                req=t["req"], count=t["count"],
                azone=t["azone"], acap=t["acap"],
                tzone=tzone, tcap=tcap, g_max=g_max,
            )
        except Exception:  # noqa: BLE001 -- the FFD rung owns the reply
            # (OperatorCrashed is BaseException and still flies)
            dense_cx = None
        fallback = dense_cx is None
        winner, dense, p_ffd, p_cx = convex_tier.choose(dense_ffd, dense_cx, price)
        take, unplaced, n_open, gmask, gzone, gcap = dense
        _send_frame(
            sock,
            {
                "ok": True, "winner": winner, "n_open": int(n_open),
                "lower": float(lower),
                "iterations": int(convex_relax.iterations_to_convergence(trace)),
                "fallback": bool(fallback),
                "price_ffd": float(p_ffd),
                "price_convex": (None if not np.isfinite(p_cx) else float(p_cx)),
                **wt.echo(),
            },
            [
                ("take", np.asarray(take, dtype=np.int32)),
                ("unplaced", np.asarray(unplaced, dtype=np.int32)),
                ("gmask", np.asarray(gmask)),
                ("gzone", np.asarray(gzone)),
                ("gcap", np.asarray(gcap)),
            ],
        )

    def _put(self, a, dtype) -> torch.Tensor:
        return ffd._to_device(np.asarray(a, dtype=dtype), self.device)

    def _op_solve_disrupt(self, sock, header: dict, t: Dict[str, np.ndarray],
                          wt: Optional[tracing.WireTrace] = None) -> None:
        """Batched consolidation solve: kernel B repacks every candidate
        set against the surviving headroom, plus an optional replacement
        search against the catalog ALREADY STAGED under the header's
        seqnum. The repacked leftover stages under the header's
        ``depoch`` so the same sweep's later per-pool replacement passes
        ship only the class masks (a shipped ``leftover`` tensor is the
        fallback when the depoch was evicted mid-sweep)."""
        from karpenter_tpu_torch.apis import labels as wk

        wt = wt or tracing.WireTrace(None)
        depoch = header.get("depoch")
        reply: List[Tuple[str, np.ndarray]] = []
        left_dev = None
        if "member" in t:  # the repack half
            with wt.stage("device", op="solve_disrupt"):
                left_dev = self._engine.repack_leftover(
                    t["headroom"], t["feas"], t["req"], t["member"], t["excl"])
                self._sync(wt)
            with wt.stage("fetch"):
                leftover = left_dev.cpu().numpy()
            if depoch is not None:
                with self._lock:
                    self._disrupt[str(depoch)] = leftover
                    while len(self._disrupt) > 4:
                        self._disrupt.pop(next(iter(self._disrupt)))
                        self._evictions["disrupt"] += 1
                        metrics.SOLVER_STAGED_EVICTIONS.inc(kind="disrupt")
                    self._evict_for_pressure_locked()
                    self._staged_bytes_locked()
            reply.append(("leftover", leftover))
        else:  # replacement-only pass of an in-flight sweep
            leftover = None
            if depoch is not None:
                with self._lock:
                    leftover = self._disrupt.get(str(depoch))
                    if leftover is not None:  # LRU touch
                        self._disrupt.pop(str(depoch))
                        self._disrupt[str(depoch)] = leftover
            if leftover is None:
                leftover = t.get("leftover")
            if leftover is None:
                _send_frame(sock, {"ok": False, "error": "unknown-depoch"})
                return
        if "compat" in t:  # the replacement half, against the staged catalog
            entry = self._staged_entry(sock, header)
            if entry is None:
                return
            od_col = int(encode.CAPTYPE_INDEX[wk.CAPACITY_TYPE_ON_DEMAND])
            with wt.stage("device", op="disrupt_replace"):
                if left_dev is None:
                    left_dev = self._put(leftover, np.int32)
                args = (
                    left_dev, self._put(t["creq"], np.float32), self._put(t["compat"], bool),
                    self._put(t["azone"], bool), self._put(t["acap"], bool),
                    entry.staged.cap, self._put(t["ovh"], np.float32), entry.staged.price,
                )
                out = self._engine.replace(*args, od_col=od_col, epoch=entry.tepoch)
                self._sync(wt)
            with wt.stage("fetch"):
                arrays = [a.cpu().numpy() for a in out]
            reply.extend(
                (n, np.atleast_1d(a))
                for n, a in zip(("best", "best_od", "best_k"), arrays)
            )
        _send_frame(sock, {"ok": True, **wt.echo()}, reply)


# -- client ------------------------------------------------------------------

class StaleSeqnumError(RuntimeError):
    """The sidecar does not know the staged-catalog seqnum an ASYNC solve
    named: it restarted or evicted the catalog while the request was in
    flight. The pipelined path surfaces this instead of silently
    re-staging (a restage cannot be spliced in front of a frame that has
    already streamed); the caller decides -- TorchSolver._finish_remote
    falls back to the synchronous op, which restages and retries."""


class StaleEpochError(StaleSeqnumError):
    """The class-epoch analogue of StaleSeqnumError: the sidecar no longer
    knows the base epoch a pipelined DELTA solve patched against (restart,
    or LRU eviction of the epoch). Subclasses StaleSeqnumError so every
    existing ladder that handles a mid-flight staging gap handles this one
    identically: the synchronous retry full-restages the class tensors
    (the client dropped its base on this error)."""


class StaleTopologyError(StaleSeqnumError):
    """The MESH-topology analogue of StaleSeqnumError: the device mesh a
    sharded solve was staged under changed mid-flight (a device was lost,
    quarantined, or returned -- fleet/topology.py bumps the topology
    epoch on any membership change). Staged state from the old epoch
    belongs to a mesh that no longer exists, so the solve cannot be
    completed as issued. Subclasses StaleSeqnumError so every existing
    recovery rung -- the synchronous restage-and-retry ladder, the
    pipelined barrier fallback, the breaker, the delta-epoch drop --
    handles a topology change exactly like any other staging gap: the
    retry restages onto the CURRENT mesh (fleet/shard.py reshards
    lazily at the next dispatch) and re-solves byte-identically."""


class _PendingReply:
    """One in-flight request's reply slot. `outcome` is filled by the FIFO
    drain: ("ok", header, tensors) or ("err", exception). `seqnum` names
    the staged catalog the request referenced -- the claim side drops the
    matching delta base on staging-gap errors."""

    __slots__ = ("outcome", "seqnum", "g_max")

    def __init__(self, seqnum: str = "", g_max: int = 0):
        self.outcome = None
        self.seqnum = seqnum
        # the request's group budget: a reply_v2 reconstruction needs it
        # to rebuild the dense g_max-row group tensors client-side
        self.g_max = g_max


class SolverClient:
    """Drop-in backend for TorchSolver-shaped solves over the wire.
    Maintains one persistent connection; `solve_classes` mirrors the
    tensor half of the solve (the caller does host-side encode/decode).
    Speaks to the port's server and to the JAX package's alike."""

    def __init__(
        self, host: Optional[str] = None, port: Optional[int] = None,
        timeout: float = 30.0, *, path: Optional[str] = None,
        token: Optional[str] = None, ssl_context=None,
        server_hostname: Optional[str] = None,
        connect_timeout: float = DEFAULT_CONNECT_TIMEOUT,
        delta: Optional[bool] = None,
        shm: Optional[bool] = None, reply_v2: Optional[bool] = None,
        track_transport: bool = True, tenant: Optional[str] = None,
        packed_masks: Optional[bool] = None,
    ):
        self.addr = (host, port) if path is None else None
        self.path = path
        # fleet topology (fleet/): the tenant id this replica's solve ops
        # carry -- the shared sidecar's coalescer keys its deterministic
        # ordering, deadline budget, and per-tenant breaker on it. None
        # (the single-cluster default) omits the field; the server then
        # treats the connection as the anonymous tenant, which is exactly
        # the pre-fleet behavior.
        self.tenant = str(tenant) if tenant else None
        # karpenter_wire_transport_in_use is process-global: only the
        # PRIMARY client (the solver's real wire) reports to it. Throwaway
        # connections -- the breaker's half-open probe, ad-hoc tooling --
        # pass False so they never clobber the operator's degrade signal.
        self._track_transport = bool(track_transport)
        # shared-memory ring transport (solver/shm.py): negotiated per
        # connection when the server advertises it. Default: ask only on
        # a UNIX-socket transport (the colocated-sidecar topology -- a
        # remote TCP sidecar cannot share memory); $KARPENTER_TPU_SHM=1
        # forces the ask over TCP (colocated-by-config), =0 kills it.
        # The socket stays the portable fallback: attach failures keep
        # the connection on it, and SHM_MAX_FAILURES consecutive shm
        # stream failures (e.g. crc mismatches from a corrupt segment)
        # stop the client re-negotiating -- the automatic degrade to TCP.
        if shm is None:
            env = os.environ.get(SHM_ENV)
            shm = (path is not None) if env is None else env != "0"
        self.shm = bool(shm) and ssl_context is None
        self._shm_failures = 0
        self._ring = None          # live RingEndpoint (shm mode)
        self._ring_seg = None      # its segment mapping
        self._wire = None          # the frame wire: ring or socket
        # trimmed compact replies (reply_v2): on when the server
        # advertises the feature; $KARPENTER_TPU_REPLY_V2=0 kills
        if reply_v2 is None:
            reply_v2 = os.environ.get(REPLY_V2_ENV, "1") != "0"
        self.reply_v2 = bool(reply_v2)
        # reply observability for the LAST decision decoded (bench reads
        # it): payload bytes on the wire and the reply shape version
        self.last_reply = {"bytes": 0, "v": 0}
        # timeout = the per-solve READ budget; connect_timeout bounds
        # connection establishment (connect + TLS + auth). They were one
        # knob before, which made a dead sidecar cost the full solve
        # budget per reconnect attempt instead of ~1s.
        self.timeout = timeout
        self.connect_timeout = connect_timeout
        # True while the LAST _apply_budget_timeout clamped the read
        # budget below `timeout` (an active tick-deadline budget): a
        # timeout in that state is deliberate shedding, and _wire_failed
        # exempts it from the shm degrade ladder
        self._budget_clamped = False
        self.token = (token if token is not None else os.environ.get(TOKEN_ENV)) or None
        self._ssl_context = ssl_context
        self._server_hostname = server_hostname or (host if host else None)
        self._sock: Optional[socket.socket] = None
        self._staged_seqnums: set = set()
        # mesh topology epoch each seqnum was staged under, as reported in
        # the stage reply (feature-negotiated "topology_epoch"; an
        # unsharded server omits the field). Informational: the SERVER
        # owns restaging across topology changes -- this is the observable
        # half, so operators and tests can see which device set a staged
        # catalog targeted.
        self._staged_tepochs: Dict[str, int] = {}
        self._features: Optional[frozenset] = None  # per-connection, lazy
        # delta class shipping (the incremental-tick wire layer): when the
        # server advertises solve_delta, compact solves stage the class
        # tensors under a class-epoch id and subsequent solves ship only
        # the dirty rows. Default on; delta=False or $KARPENTER_TPU_DELTA=0
        # forces the full ship (the two are bit-identical by construction
        # -- the server reassembles the same tensors either way).
        if delta is None:
            delta = os.environ.get(DELTA_ENV, "1") != "0"
        self.delta = bool(delta)
        # bit-packed mask wire form (solver/packing.py): when the server
        # advertises "packed_masks", the [C, K] open/join masks ship as
        # [C, KW] uint32 words -- 8x less payload AND row-patchable by
        # the delta path (full-width bool masks bypass it). Bit-identical
        # by construction: the kernel unpacks in-jit. Default on;
        # packed_masks=False or $KARPENTER_TPU_PACKED_MASKS=0 forces the
        # full-width ship (and an older server simply never negotiates).
        if packed_masks is None:
            packed_masks = os.environ.get(PACKED_MASKS_ENV, "1") != "0"
        self.packed_masks = bool(packed_masks)
        # seqnum -> (epoch id, {name: array copy}): the last class tensor
        # state the server is known to hold for that catalog. Bounded LRU;
        # dropped eagerly on close() and on any staging-gap error.
        self._epoch_bases: Dict[str, tuple] = {}
        import uuid as _uuid

        self._epoch_prefix = _uuid.uuid4().hex[:12]
        self._epoch_counter = 0
        # shipping observability for the LAST solve dispatched (read by
        # the solver's metrics/span wiring and the bench's delta stage)
        self.last_delta = {"mode": "bypass", "rows": -1, "payload_bytes": 0, "full_bytes": 0}
        # one reentrant lock serializes the socket AND the staging set: the
        # protocol is strictly request/response on one connection, so a
        # whole roundtrip (and the stage-then-solve sequence inside
        # solve_classes) must be atomic across threads
        self._lock = threading.RLock()
        # request-pipelining FIFO (begin_solve_compact): replies come back
        # in request order on the one stream, so each dispatched frame's
        # reply slot queues here until a drain claims it
        from collections import deque

        self._pending: "deque[_PendingReply]" = deque()
        # one solve computing + one frame streaming behind it -- the depth
        # at which the RTT fully overlaps compute; anything deeper only
        # buffers latency (and decisions) without adding overlap
        self.MAX_INFLIGHT = 2

    def _conn(self):
        """The frame wire for this connection: the shared-memory ring
        endpoint when negotiation succeeded, the socket otherwise."""
        if self._sock is None:
            failpoints.eval("rpc.client.connect")
            # the WHOLE establishment sequence (connect, TLS handshake,
            # auth roundtrip, shm negotiation) runs under connect_timeout;
            # only then does the wire get the long per-solve read budget
            if self.path is not None:
                sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
                try:
                    sock.settimeout(self.connect_timeout)
                    sock.connect(self.path)
                except OSError:
                    # close on the error edge too: a reconnect storm
                    # against a dead sidecar must not dangle one fd per
                    # attempt until GC (reslife/leak-on-error)
                    sock.close()
                    raise
            else:
                sock = socket.create_connection(self.addr, timeout=self.connect_timeout)
                try:
                    sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                    if self._ssl_context is not None:
                        sock = self._ssl_context.wrap_socket(
                            sock, server_hostname=self._server_hostname
                        )
                except OSError:
                    sock.close()
                    raise
            self._sock = sock
            self._wire = sock
            self._staged_seqnums.clear()
            try:
                if self.token:
                    # prove the shared token before any op (the server closes
                    # unauthenticated connections on the first non-auth frame)
                    _send_frame(sock, {"op": "auth", "token": self.token})
                    header, _ = _recv_frame(sock)
                    if not header.get("ok"):
                        raise ConnectionError("solver auth rejected")
                if self.shm and self._shm_failures < SHM_MAX_FAILURES:
                    self._try_shm(sock)
            except (ConnectionError, OSError):
                sock.close()
                self._sock = None
                self._wire = None
                raise
            sock.settimeout(self.timeout)
            if self._ring is not None:
                self._ring.settimeout(self.timeout)
            if self._track_transport:
                metrics.WIRE_TRANSPORT.set(
                    1.0 if self._ring is not None else 0.0, transport="shm"
                )
                metrics.WIRE_TRANSPORT.set(
                    0.0 if self._ring is not None else 1.0, transport="tcp"
                )
        return self._wire

    def _try_shm(self, sock) -> None:
        """Negotiate the shared-memory ring on a fresh connection. Every
        failure mode leaves the SOCKET stream intact and usable:
        - an injected rpc.shm.attach fault or a local attach failure fires
          BEFORE/AFTER complete roundtrips, and shm_ready(ok=False) tells
          the server to unlink the segment and stay on the socket;
        - a server without the op answers with an error frame ("unknown
          op"), which reads as a refusal."""
        from karpenter_tpu_torch.solver import shm as shm_mod

        try:
            failpoints.eval("rpc.shm.attach")
        except (ConnectionError, OSError, RuntimeError):
            return  # injected attach failure: stay on the socket
        _send_frame(sock, {"op": "shm_open"})
        header, _ = _recv_frame(sock)
        if not header.get("ok") or "path" not in header:
            return  # refused / old server: the socket is the transport
        try:
            seg = shm_mod.ShmSegment.attach(str(header["path"]), int(header["size"]))
        except (shm_mod.ShmAttachError, ValueError, KeyError,
                ConnectionError, OSError, RuntimeError):
            # the wide net matters: attach re-evals the rpc.shm.attach
            # failpoint, and an injected ConnectionError must degrade to
            # the socket here, not tear down the whole connection
            _send_frame(sock, {"op": "shm_ready", "ok": False})
            return
        try:
            _send_frame(sock, {"op": "shm_ready", "ok": True})
        except BaseException:
            # the socket died between attach and ready: the segment was
            # never adopted (self._ring_seg unset), so close the mapping
            # here or its fd leaks for the life of the process under a
            # reconnect storm against a crashing sidecar
            seg.close()
            raise
        self._ring_seg = seg
        self._ring = seg.endpoint("client", liveness=sock, timeout=self.connect_timeout)
        self._wire = self._ring

    def _apply_budget_timeout(self) -> None:
        """Per-tick deadline budgets (overload.py): clamp
        this roundtrip's READ budget to the active tick budget's
        remaining time, so a tick that is going to blow its deadline
        fails the wire EARLY -- the expiring timeout surfaces as the same
        OSError every degrade ladder (reconnect, breaker, CPU fallback)
        already handles -- instead of timing out late. No active budget
        (the default, and every deterministic test) leaves the configured
        solve timeout untouched. Caller holds the lock."""
        wire = self._wire
        if wire is None:
            return
        t = overload.clamp_timeout(self.timeout)
        # remembered for _wire_failed: a timeout under a clamped budget is
        # OUR impatience, not transport evidence
        self._budget_clamped = t < self.timeout
        if wire.gettimeout() != t:
            wire.settimeout(t)

    def _wire_failed(self, exc: Optional[BaseException] = None) -> None:
        """Stream-failure accounting for the shm degrade ladder: failures
        WHILE the ring was the wire count toward SHM_MAX_FAILURES (after
        which reconnects stay on the socket); socket failures do not.
        Neither does a peer found ALREADY dead before the frame went onto
        the ring (ShmPeerGoneError) -- every reconnect gets a fresh
        segment, so a crash-looping sidecar must not permanently cost the
        ring. Failures once bytes are in flight DO count: a server hangs
        up on a corrupt stream, so a reply-wait EOF is ambiguous with
        corruption, and crc/decode failures and wedged-peer timeouts are
        direct evidence.

        A TIMEOUT while the tick-deadline budget had CLAMPED the read
        below the configured solve timeout is OUR deliberate impatience
        (overload early-shed), not transport evidence -- counting it
        would let one slow storm permanently degrade the ring to tcp for
        the client's lifetime (there is no shm re-promotion probe)."""
        from karpenter_tpu_torch.solver import shm as shm_mod

        if self._ring is None or isinstance(exc, shm_mod.ShmPeerGoneError):
            return
        if isinstance(exc, TimeoutError) and getattr(self, "_budget_clamped", False):
            return
        self._shm_failures += 1

    def cancel_inflight(self) -> None:
        """Out-of-band cancellation for the stuck-tick watchdog
        (overload.py): tear the TRANSPORT down WITHOUT
        taking the client lock -- the wedged thread holds it across its
        blocking read, so close() here would block the watchdog instead
        of unsticking the tick. Closing the ring endpoint flips its
        closed flag (the blocked ring wait's liveness check raises
        ShmError within milliseconds) and shutting the socket down makes
        a blocked recv return EOF; either way the wedged call surfaces a
        ConnectionError into the normal degrade ladder, which then
        closes the client PROPERLY under the lock."""
        ring, sock = self._ring, self._sock
        try:
            if ring is not None:
                ring.close()
        except Exception:  # noqa: BLE001 -- cancellation is best-effort
            metrics.HANDLED_ERRORS.inc(site="rpc.cancel_inflight")
        try:
            if sock is not None:
                sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass

    def close(self) -> None:
        with self._lock:
            # replies can no longer arrive on this stream: fail their slots
            # so a later finish_solve_compact raises instead of hanging
            for h in self._pending:
                if h.outcome is None:
                    h.outcome = ("err", ConnectionError("connection closed with reply in flight"))
            self._pending.clear()
            if self._ring is not None:
                self._ring.close()      # sets the client-closed flag
                self._ring = None
            if self._ring_seg is not None:
                self._ring_seg.close()  # unmap only; the server unlinks
                self._ring_seg = None
            self._wire = None
            if self._track_transport:
                metrics.WIRE_TRANSPORT.set(0.0, transport="shm")
                metrics.WIRE_TRANSPORT.set(0.0, transport="tcp")
            if self._sock is not None:
                self._sock.close()
                self._sock = None
            self._features = None  # the replacement server may differ
            # eager, not on-reconnect: between close() and the next _conn()
            # a begin_solve_compact checks membership BEFORE connecting, and
            # a stale hit would skip the re-stage the replacement sidecar
            # needs (the breaker's promotion hook relies on this to gate
            # re-promotion on a catalog re-stage)
            self._staged_seqnums.clear()
            self._staged_tepochs.clear()
            # delta bases die with the connection for the same reason: the
            # replacement sidecar holds no epochs, and a stale base would
            # cost one unknown-epoch roundtrip per seqnum before recovering
            self._epoch_bases.clear()

    # -- request pipelining (the async solve path) ---------------------------
    def _op_header(self, **fields) -> dict:
        """An op header carrying this replica's tenant id (fleet
        topology); single-cluster clients omit the field entirely so the
        frames are byte-identical to the pre-fleet protocol."""
        if self.tenant is not None:
            fields["tenant"] = self.tenant
        return fields

    def _drain_pending(self, target: Optional[_PendingReply] = None) -> None:
        """Receive outstanding replies in FIFO order (all of them, or up to
        and including `target`). MUST run before any synchronous roundtrip
        so a pipelined reply is never misattributed to a later request.
        Caller holds the lock."""
        self._apply_budget_timeout()
        while self._pending:
            head = self._pending[0]
            if head.outcome is None:
                try:
                    header, tensors = _recv_frame(self._wire)
                    head.outcome = ("ok", header, tensors)
                    if self._ring is not None:
                        self._shm_failures = 0
                except (ConnectionError, OSError) as e:
                    # the stream is unrecoverable mid-pipeline: every
                    # outstanding reply is lost with it
                    self._wire_failed(e)
                    for h in self._pending:
                        if h.outcome is None:
                            h.outcome = ("err", e)
                    self._pending.clear()
                    self.close()
                    return
            done = self._pending.popleft()
            if target is not None and done is target:
                return

    def begin_solve_compact(
        self, seqnum: str, catalog: encode.CatalogTensors, class_set: encode.PodClassSet,
        g_max: int = 1024, nnz_max: int = 0, objective: str = "price",
    ) -> _PendingReply:
        """Dispatch a compact solve WITHOUT waiting for the reply: the
        request frame streams to the sidecar while it may still be
        computing a prior in-flight solve (request pipelining on the
        strict request/response framing -- replies return in request
        order). At most MAX_INFLIGHT (2: one computing, one streaming)
        may be outstanding; a deeper dispatch raises rather than silently
        buffering stale decisions. Claim the reply with
        finish_solve_compact. Unlike the synchronous op, an unknown
        seqnum surfaces as StaleSeqnumError -- no silent restage."""
        if not nnz_max:
            nnz_max = ffd.nnz_budget(class_set.c_pad, g_max)
        header = self._op_header(
            op="solve_compact", seqnum=seqnum, g_max=g_max,
            nnz_max=nnz_max, objective=objective,
        )
        # trace-id propagation: the DISPATCHING tick's context rides the
        # request header; the server echoes it (plus its stage timings)
        # in the reply, so the claim side can graft the stages even when
        # the reply is drained a tick later under a different trace
        ctx = tracing.TRACER.inject()
        if ctx is not None:
            header["trace"] = ctx
        with self._lock:
            if len(self._pending) >= self.MAX_INFLIGHT:
                raise RuntimeError(
                    f"solve pipeline full: {len(self._pending)} requests already in flight"
                )
            if seqnum not in self._staged_seqnums:
                # staging is a synchronous roundtrip: the pipe must be
                # clear first or the stage reply would interleave
                self._drain_pending()
                self.stage_catalog(seqnum, catalog)
            # delta class shipping: may rewrite the header into a
            # solve_delta op and return only the dirty rows (feature-gated;
            # full ship otherwise -- the server reassembles identically)
            tensors = self._delta_request(seqnum, class_set, header)
            self._maybe_reply_v2(header)
            sock = self._conn()
            try:
                _send_frame(sock, header, tensors)
            except (ConnectionError, OSError) as e:
                # a PARTIAL frame may be on the wire: the stream is
                # desynchronized, and a later synchronous fallback would
                # write its frame into the torn one's remainder -- close
                # so that fallback reconnects onto a clean stream
                self._wire_failed(e)
                self.close()
                raise
            handle = _PendingReply(seqnum, g_max=g_max)
            self._pending.append(handle)
            return handle

    def finish_solve_compact(self, handle: _PendingReply) -> ffd.CompactDecision:
        """Claim a begin_solve_compact reply (blocking until it arrives).
        Raises StaleSeqnumError on unknown-seqnum, ConnectionError when
        the stream died with the reply in flight."""
        with self._lock:
            if handle.outcome is None:
                self._drain_pending(target=handle)
            if handle.outcome is None:
                raise ConnectionError("reply lost: not in the pipeline FIFO")
        kind, *rest = handle.outcome
        if kind == "err":
            raise rest[0]
        header, out = rest
        if not header.get("ok"):
            err = str(header.get("error", ""))
            if err.startswith("StaleTopologyError"):
                # the sidecar's device mesh changed membership while this
                # solve was in flight (server errors cross the wire as
                # "ClassName: message"). The server restages the seqnum
                # onto the surviving devices at its next touch, so the
                # typed re-raise rides the existing StaleSeqnumError
                # barrier-fallback rung -- one synchronous retry against
                # the SAME seqnum lands on the new topology epoch.
                metrics.MESH_STALE_SOLVES.inc(site="client-wire")
                raise StaleTopologyError(err)
            if err == "unknown-epoch":
                # the sidecar lost the base epoch mid-flight: drop the
                # client base so the synchronous retry ships full, and
                # surface the gap on the StaleSeqnumError contract
                self._drop_epoch(handle.seqnum)
                metrics.DELTA_EPOCH_RESTAGES.inc()
                raise StaleEpochError(err)
            if err == "unknown-seqnum":
                self._drop_epoch(handle.seqnum)
                raise StaleSeqnumError(err)
            raise RuntimeError(f"solve failed: {err}")
        # graft the echoed server-side stage spans under the span covering
        # this claim (the solver's "wire" span); the echo's trace context
        # links back to the dispatching tick when that differs
        tracing.TRACER.graft(header)
        return self._compact_from_reply(header, out, handle.g_max)

    def _compact_from_reply(self, header: dict, out: Dict[str, np.ndarray],
                            g_max: int) -> "ffd.CompactDecision":
        """A CompactDecision from a solve reply of either shape (v1 dense
        or v2 trimmed), recording the reply's wire payload bytes."""
        self.last_reply = {
            "bytes": int(sum(a.nbytes for a in out.values())),
            "v": int(header.get("v", 1)),
        }
        if int(header.get("v", 1)) >= 2:
            return expand_reply_v2(header, out, g_max)
        fields = {n: out[n] for n in ffd.CompactDecision._fields}
        fields["nnz"] = fields["nnz"].reshape(())
        fields["n_open"] = fields["n_open"].reshape(())
        return ffd.CompactDecision(**fields)

    def _maybe_reply_v2(self, header: dict) -> None:
        """Request the trimmed reply shape when the op supports it and
        the server advertises the feature (cached per connection -- the
        probe rides the same ping `features()` already uses)."""
        if not self.reply_v2 or header.get("op") not in ("solve_compact", "solve_delta"):
            return
        try:
            if "reply_v2" in self.features():
                header["reply"] = 2
        except (ConnectionError, OSError):
            # let the solve's own send surface the connection state
            pass

    def features(self) -> frozenset:
        """Server feature set, probed once per connection via ping (an
        older server omits the field -> empty set). Callers that DEPEND on
        a semantic the server may lack check here and fall back -- e.g.
        taint-gated merged batches go to the oracle when 'join_allowed' is
        absent, because an old server would silently drop the mask and
        pack pods into pools whose taints they do not tolerate."""
        with self._lock:
            if self._features is None:
                header, _ = self._roundtrip({"op": "ping"})
                self._features = frozenset(header.get("features", ()))
            return self._features

    def _packed_wire(self) -> bool:
        """True when class masks should ship bit-packed: enabled on this
        client AND negotiated with the server. A wire error here answers
        False (full-width is always understood) and lets the solve's own
        send surface the connection state -- same discipline as the
        solve_delta gate in _delta_request."""
        if not self.packed_masks:
            return False
        try:
            return "packed_masks" in self.features()
        except (ConnectionError, OSError):
            return False

    def _roundtrip(self, header, tensors=()):
        with self._lock:
            # pipelined replies still on the stream MUST drain first, or
            # this request would read an earlier solve's reply as its own
            self._drain_pending()
            sock = self._conn()
            self._apply_budget_timeout()
            try:
                _send_frame(sock, header, tensors)
                out = _recv_frame(sock)
                if self._ring is not None:
                    self._shm_failures = 0
                return out
            except (ConnectionError, OSError) as e:
                self._wire_failed(e)
                self.close()  # one reconnect attempt per call
                sock = self._conn()
                self._apply_budget_timeout()
                try:
                    _send_frame(sock, header, tensors)
                    out = _recv_frame(sock)
                except (ConnectionError, OSError) as e2:
                    # the retry leg's stream failures count toward the shm
                    # degrade ladder too, or a persistently corrupt ring
                    # takes twice the documented failures to stick to tcp
                    self._wire_failed(e2)
                    self.close()  # leave a clean slate for the next call
                    raise
                if self._ring is not None:
                    self._shm_failures = 0
                return out

    def ping(self) -> bool:
        header, _ = self._roundtrip({"op": "ping"})
        return bool(header.get("ok"))

    def stage_catalog(self, seqnum: str, catalog: encode.CatalogTensors) -> None:
        header = {
            "op": "stage", "seqnum": seqnum, "names": catalog.names,
            "k_real": catalog.k_real, "zones": catalog.zones, "words": catalog.words,
        }
        tensors = [
            ("cap", catalog.cap), ("tcode", catalog.tcode), ("tnum", catalog.tnum),
            ("tnum_present", catalog.tnum_present), ("tzone", catalog.tzone),
            ("tcap", catalog.tcap), ("price", catalog.price),
        ]
        resp, _ = self._roundtrip(header, tensors)
        if not resp.get("ok"):
            raise RuntimeError(f"stage failed: {resp.get('error')}")
        with self._lock:
            self._staged_seqnums.add(seqnum)
            if resp.get("tepoch") is not None:
                self._staged_tepochs[seqnum] = int(resp["tepoch"])

    @staticmethod
    def _class_tensors(class_set: encode.PodClassSet, packed: bool = False):
        """The pod-class tensor list both solve ops ship (ONE copy: a new
        class tensor must appear here or the dense and compact paths
        desynchronize). With `packed` (the negotiated "packed_masks" wire
        form) the [C, K] bool masks ship as [C, KW] uint32 words -- the
        server's kernels dispatch on dtype, so no header flag is needed
        and the decision is bit-identical either way."""

        def _mask(m):
            if packed and not packing.is_packed(m):
                return packing.pack_mask(m)
            if not packed and packing.is_packed(m):
                # a pre-packed class set meeting a server that never
                # negotiated the form: ship the full-width bool rows the
                # old server understands (KW*32 == k_pad exactly -- k_pad
                # is a multiple of 128)
                return packing.unpack_mask(m, m.shape[-1] * packing.WORD_BITS)
            return m

        return [
            ("req", class_set.req), ("count", class_set.count),
            ("env_count", class_set.env_count),
            ("allowed", np.concatenate(class_set.allowed, axis=1)),
            ("num_lo", class_set.num_lo), ("num_hi", class_set.num_hi),
            ("azone", class_set.azone), ("acap", class_set.acap),
            ("schedulable", class_set.schedulable),
            ("node_overhead", class_set.node_overhead),
        ] + (
            [("open_allowed", _mask(class_set.open_allowed))]
            if getattr(class_set, "open_allowed", None) is not None else []
        ) + (
            [("join_allowed", _mask(class_set.join_allowed))]
            if getattr(class_set, "join_allowed", None) is not None else []
        )

    # -- delta class shipping (the incremental-tick wire layer) ---------------
    def _next_epoch(self) -> str:
        self._epoch_counter += 1
        return f"{self._epoch_prefix}-{self._epoch_counter}"

    def _drop_epoch(self, seqnum: str) -> None:
        with self._lock:
            self._epoch_bases.pop(seqnum, None)

    def _store_base(self, seqnum: str, epoch: str, named: Dict[str, np.ndarray]) -> None:
        """Record the class tensor state the server now holds for this
        seqnum (one copy per tensor: the caller's arrays belong to a live
        PodClassSet). Caller holds the lock."""
        self._epoch_bases.pop(seqnum, None)  # LRU refresh
        self._epoch_bases[seqnum] = (
            epoch, {n: np.array(a) for n, a in named.items()}
        )
        while len(self._epoch_bases) > 4:
            self._epoch_bases.pop(next(iter(self._epoch_bases)))

    def _patch_base(self, seqnum: str, epoch: str, b: Dict[str, np.ndarray],
                    rows: np.ndarray, named: Dict[str, np.ndarray],
                    row_names=PER_CLASS_TENSORS) -> None:
        """Advance a delta chain's stored base IN PLACE: O(dirty rows)
        host work per tick, like everything else in the engine -- a full
        re-copy here would spend memory bandwidth on exactly the bytes
        the delta ship avoids. Caller holds the lock; `b` is this
        client's private copy (never aliased into a frame)."""
        if rows.size:
            for name in row_names:
                b[name][rows] = named[name][rows]
        b["node_overhead"] = np.array(named["node_overhead"])
        self._epoch_bases.pop(seqnum, None)  # LRU refresh
        self._epoch_bases[seqnum] = (epoch, b)

    def _bypass_delta(self, full_bytes: int):
        self.last_delta = {
            "mode": "bypass", "rows": -1,
            "payload_bytes": full_bytes, "full_bytes": full_bytes,
        }
        metrics.DELTA_SOLVES.inc(mode="bypass")
        metrics.DELTA_PAYLOAD_BYTES.observe(full_bytes, mode="bypass")

    def _delta_request(self, seqnum: str, class_set: encode.PodClassSet, header: dict):
        """The tensors to ship for one compact solve, rewriting `header`
        into a solve_delta op when the delta path applies. Three modes
        (last_delta["mode"], mirrored into karpenter_scheduler_delta_*):

        - "delta": a base epoch for this seqnum exists with matching
          shapes and few rows changed -- ship only the dirty rows plus
          the epoch being patched;
        - "full": ship everything, establishing a new epoch server-side
          (the steady state's first tick, a shape change, or a high-churn
          tick past DELTA_MAX_DIRTY_FRACTION);
        - "bypass": delta not applicable (disabled, dense op, server
          without the feature, or merged-multipool masks present).

        The server reassembles the identical tensor set in every mode, so
        the decision is bit-identical by construction (tests/test_torch_wire.py
        asserts it differentially). Caller holds the lock."""
        tensors = self._class_tensors(class_set, packed=self._packed_wire())
        full_bytes = int(sum(a.nbytes for _, a in tensors))
        if not self.delta or header.get("op") != "solve_compact":
            self._bypass_delta(full_bytes)
            return tensors
        if overload.sheds_delta():
            # brownout ladder rung 3 (overload.py): under
            # sustained deadline pressure the delta-epoch machinery stands
            # down -- no staging diffs, no epoch bookkeeping, and above
            # all no unknown-epoch restage retry roundtrips. The full ship
            # is bit-identical by construction; the ladder's hysteretic
            # recovery restores delta shipping (the first solve after
            # re-entry establishes a fresh epoch).
            self._bypass_delta(full_bytes)
            return tensors
        named = dict(tensors)
        if any(
            n in named and not packing.is_packed(named[n])
            for n in PACKED_MASK_TENSORS
        ):
            # merged multi-pool, FULL-WIDTH masks: the bool [C, K] rows
            # dominate the payload and are re-derived per tick -- the
            # delta path stands down. Packed [C, KW] uint32 masks are an
            # eighth the size and row-patch below like any class tensor.
            self._bypass_delta(full_bytes)
            return tensors
        row_names = list(PER_CLASS_TENSORS) + [
            n for n in PACKED_MASK_TENSORS if n in named
        ]
        try:
            if "solve_delta" not in self.features():
                self._bypass_delta(full_bytes)
                return tensors
        except (ConnectionError, OSError):
            # let the solve's own send surface the connection state
            self._bypass_delta(full_bytes)
            return tensors
        epoch = self._next_epoch()
        base = self._epoch_bases.get(seqnum)
        if base is not None:
            b = base[1]
            if set(b) == set(named) and all(
                b[n].shape == named[n].shape and b[n].dtype == named[n].dtype
                for n in named
            ):
                changed = np.zeros((named["req"].shape[0],), dtype=bool)
                for name in row_names:
                    diff = named[name] != b[name]
                    if diff.ndim > 1:
                        diff = diff.any(axis=tuple(range(1, diff.ndim)))
                    changed |= diff
                rows = np.nonzero(changed)[0]
                if rows.size <= int(changed.size * DELTA_MAX_DIRTY_FRACTION):
                    header["op"] = "solve_delta"
                    header["epoch"] = epoch
                    header["base"] = base[0]
                    header["rows"] = [int(r) for r in rows]
                    out = [
                        (name, np.ascontiguousarray(named[name][rows]))
                        for name in row_names
                    ]
                    # whole-set tensors always ship (tiny [R] vector)
                    out.append(("node_overhead", named["node_overhead"]))
                    self._patch_base(seqnum, epoch, b, rows, named, row_names)
                    payload = int(sum(a.nbytes for _, a in out))
                    self.last_delta = {
                        "mode": "delta", "rows": int(rows.size),
                        "payload_bytes": payload, "full_bytes": full_bytes,
                    }
                    metrics.DELTA_SOLVES.inc(mode="delta")
                    metrics.DELTA_ROWS_SHIPPED.inc(int(rows.size))
                    metrics.DELTA_PAYLOAD_BYTES.observe(payload, mode="delta")
                    return out
        # full ship, establishing the epoch the next tick patches
        header["op"] = "solve_delta"
        header["epoch"] = epoch
        header["base"] = None
        self._store_base(seqnum, epoch, named)
        self.last_delta = {
            "mode": "full", "rows": int(class_set.c_pad),
            "payload_bytes": full_bytes, "full_bytes": full_bytes,
        }
        metrics.DELTA_SOLVES.inc(mode="full")
        metrics.DELTA_PAYLOAD_BYTES.observe(full_bytes, mode="full")
        return tensors

    def debug_info(self) -> dict:
        """The server's staging debug document (the "debug" op: staged
        seqnums, class epochs, LRU eviction counts) -- the sidecar-topology
        source for /debug/solver."""
        header, _ = self._roundtrip({"op": "debug"})
        return header

    def _solve_op(self, op_header: dict, seqnum: str, catalog, class_set):
        """Shared stage-if-needed + solve + staging-gap retry ladder:
        unknown-epoch drops the delta base and re-ships full; unknown-
        seqnum re-stages the catalog and retries (the full reship also
        re-establishes the class epoch). Each rung fires at most once."""
        ctx = tracing.TRACER.inject()
        if ctx is not None:
            op_header = dict(op_header, trace=ctx)
        with self._lock:  # atomic stage-then-solve (reentrant)
            if seqnum not in self._staged_seqnums:
                self.stage_catalog(seqnum, catalog)
            header = dict(op_header)
            tensors = self._delta_request(seqnum, class_set, header)
            self._maybe_reply_v2(header)
            resp, out = self._roundtrip(header, tensors)
            if not resp.get("ok") and resp.get("error") == "unknown-epoch":
                self._drop_epoch(seqnum)
                metrics.DELTA_EPOCH_RESTAGES.inc()
                header = dict(op_header)
                tensors = self._delta_request(seqnum, class_set, header)
                self._maybe_reply_v2(header)
                resp, out = self._roundtrip(header, tensors)
            if not resp.get("ok") and resp.get("error") == "unknown-seqnum":
                # server restarted / evicted: re-stage once and retry with
                # a full class ship (the old epoch died with the staging)
                self._drop_epoch(seqnum)
                self.stage_catalog(seqnum, catalog)
                header = dict(op_header)
                tensors = self._delta_request(seqnum, class_set, header)
                self._maybe_reply_v2(header)
                resp, out = self._roundtrip(header, tensors)
            if (
                not resp.get("ok")
                and str(resp.get("error", "")).startswith("StaleTopologyError")
            ):
                # the sidecar's device mesh changed membership mid-solve
                # (device lost, quarantine, or return). Its staging layer
                # restages the seqnum onto the current device set on the
                # next touch, so one retry -- same seqnum, same tensors --
                # lands on the new topology epoch. At most once: a second
                # stale answer surfaces as the failure it is and rides the
                # breaker ladder like any other wire fault.
                metrics.MESH_STALE_SOLVES.inc(site="client-sync")
                header = dict(op_header)
                tensors = self._delta_request(seqnum, class_set, header)
                self._maybe_reply_v2(header)
                resp, out = self._roundtrip(header, tensors)
            if not resp.get("ok"):
                raise RuntimeError(f"solve failed: {resp.get('error')}")
            tracing.TRACER.graft(resp)
            return resp, out

    def solve_classes(
        self, seqnum: str, catalog: encode.CatalogTensors, class_set: encode.PodClassSet,
        g_max: int = 512, objective: str = "price",
    ) -> ffd.SolveOutputs:
        header = self._op_header(
            op="solve", seqnum=seqnum, g_max=g_max, objective=objective
        )
        _, out = self._solve_op(header, seqnum, catalog, class_set)
        return ffd.SolveOutputs(**{n: out[n] for n in ffd.SolveOutputs._fields})

    def solve_classes_compact(
        self, seqnum: str, catalog: encode.CatalogTensors, class_set: encode.PodClassSet,
        g_max: int = 1024, nnz_max: int = 0, objective: str = "price",
    ) -> ffd.CompactDecision:
        """The ~50 KB response variant of solve_classes (the deployed
        sidecar topology's hot path); the caller expands with
        ffd.expand_compact and falls back to solve_classes on overflow."""
        if not nnz_max:
            nnz_max = ffd.nnz_budget(class_set.c_pad, g_max)
        header = self._op_header(
            op="solve_compact", seqnum=seqnum, g_max=g_max,
            nnz_max=nnz_max, objective=objective,
        )
        resp, out = self._solve_op(header, seqnum, catalog, class_set)
        return self._compact_from_reply(resp, out, g_max)

    def solve_convex(
        self, seqnum: str, catalog: encode.CatalogTensors, class_set: encode.PodClassSet,
        g_max: int = 1024, iters: Optional[int] = None, objective: str = "price",
    ):
        """The convex tier's wire solve: one synchronous roundtrip through
        the same stage-if-needed + staging-gap retry ladder as every solve
        op. Returns (dense decode tuple, info dict) where the dense tuple
        is the differential WINNER the sidecar chose and info carries the
        certificate: winner, lower (the LP bound, $/h), iterations,
        fallback (rounding produced no candidate), price_ffd /
        price_convex. Callers gate on `\"convex\" in features()` first --
        an old sidecar answers unknown-op and this raises RuntimeError."""
        fields = dict(
            op="solve_convex", seqnum=seqnum, g_max=g_max, objective=objective,
        )
        if iters is not None:
            fields["iters"] = int(iters)
        header = self._op_header(**fields)
        resp, out = self._solve_op(header, seqnum, catalog, class_set)
        dense = (
            np.asarray(out["take"]), np.asarray(out["unplaced"]),
            int(resp["n_open"]), np.asarray(out["gmask"]),
            np.asarray(out["gzone"]), np.asarray(out["gcap"]),
        )
        info = {
            "winner": str(resp.get("winner", "ffd")),
            "lower": resp.get("lower"),
            "iterations": int(resp.get("iterations", 0)),
            "fallback": bool(resp.get("fallback", False)),
            "price_ffd": resp.get("price_ffd"),
            "price_convex": resp.get("price_convex"),
        }
        return dense, info

    # -- batched consolidation (solver/disrupt, the solve_disrupt op) ---------
    def _disrupt_roundtrip(self, header: dict, tensors, seqnum, catalog):
        """stage-if-needed + solve + one unknown-seqnum restage retry:
        the disrupt op's staging ladder, the same contract as _solve_op
        (the depoch fallback tensor makes a lost disrupt epoch a
        non-error, so only the catalog gap needs a rung)."""
        with self._lock:  # atomic stage-then-solve (reentrant)
            if seqnum is not None and seqnum not in self._staged_seqnums:
                self.stage_catalog(seqnum, catalog)
            resp, out = self._roundtrip(header, tensors)
            if (
                not resp.get("ok") and resp.get("error") == "unknown-seqnum"
                and seqnum is not None
            ):
                # sidecar restarted / evicted: re-stage once and retry
                self.stage_catalog(seqnum, catalog)
                resp, out = self._roundtrip(header, tensors)
            if (
                not resp.get("ok")
                and str(resp.get("error", "")).startswith("StaleTopologyError")
            ):
                # mesh membership changed mid-dispatch: server-side
                # restage is transparent on the next touch, retry once
                metrics.MESH_STALE_SOLVES.inc(site="client-disrupt")
                resp, out = self._roundtrip(header, tensors)
            if not resp.get("ok"):
                raise RuntimeError(f"solve_disrupt failed: {resp.get('error')}")
            tracing.TRACER.graft(resp)
            return out

    def solve_disrupt_repack(
        self, repack: Dict[str, np.ndarray], *,
        seqnum: Optional[str] = None, catalog=None,
        replace: Optional[Dict[str, np.ndarray]] = None,
    ):
        """Dispatch one batched consolidation repack (and, when `replace`
        names a staged catalog context, the first pool's replacement
        search in the same roundtrip). Returns (depoch, reply tensors):
        the depoch names the leftover tensor now staged sidecar-side for
        this sweep's later replacement passes."""
        failpoints.eval("rpc.disrupt.dispatch")
        with self._lock:
            depoch = self._next_epoch()
            header = self._op_header(op="solve_disrupt", depoch=depoch)
            tensors = list(repack.items())
            if replace is not None and seqnum is not None:
                header["seqnum"] = seqnum
                tensors += list(replace.items())
            out = self._disrupt_roundtrip(header, tensors, seqnum, catalog)
            return depoch, out

    def solve_disrupt_replace(
        self, depoch: str, *, seqnum: str, catalog,
        replace: Dict[str, np.ndarray],
        leftover: Optional[np.ndarray] = None,
    ) -> Dict[str, np.ndarray]:
        """One pool's replacement search against an in-flight sweep's
        staged leftover (`depoch`) and the catalog staged under `seqnum`.
        `leftover` rides along as the stateless fallback for a
        pressure-evicted depoch."""
        failpoints.eval("rpc.disrupt.dispatch")
        header = self._op_header(op="solve_disrupt", depoch=depoch, seqnum=seqnum)
        tensors = list(replace.items())
        if leftover is not None:
            tensors.append(("leftover", leftover))
        return self._disrupt_roundtrip(header, tensors, seqnum, catalog)



def serve_main(argv=None) -> int:
    """`python -m karpenter_tpu_torch.solver.rpc` -- run the solver sidecar
    on the card. The JAX binary's flags, plus --device (default cuda):
    --coalesce and --tenant-budget serve N tenants through one
    DispatchCoalescer; --mesh (and $KARPENTER_TPU_MESH) shards every
    solve over that many real devices of --device's kind and exits
    non-zero, naming the count, when there are fewer. Default transport: a mode-0600 UNIX socket. TCP
    (--host/--port) requires --token-file / $KARPENTER_TPU_SOLVER_TOKEN, or
    the explicit --insecure flag; --tls-cert/--tls-key add TLS on top.
    Without a card the sidecar exits non-zero: it never moves to the CPU
    unless --device cpu asks for it."""
    import argparse

    parser = argparse.ArgumentParser(prog="karpenter-tpu-torch-solver")
    parser.add_argument(
        "--socket", default=None, metavar="PATH",
        help="UNIX socket path (default: $XDG_RUNTIME_DIR/karpenter-tpu-solver.sock, "
             "or a per-user /tmp dir; ignored when --host is given)",
    )
    parser.add_argument("--host", default=None, help="TCP bind address (requires a token)")
    parser.add_argument("--port", type=int, default=7077)
    parser.add_argument(
        "--token-file", default=None,
        help=f"file holding the shared token (or set ${TOKEN_ENV})",
    )
    parser.add_argument(
        "--insecure", action="store_true",
        help="allow a tokenless TCP listener (explicit operator decision)",
    )
    parser.add_argument("--tls-cert", default=None)
    parser.add_argument("--tls-key", default=None)
    parser.add_argument(
        "--handshake-timeout", type=float, default=30.0,
        help="TLS-handshake budget per connection (seconds)",
    )
    parser.add_argument(
        "--shm", action=argparse.BooleanOptionalAction, default=None,
        help="advertise the shared-memory ring transport for colocated "
        f"clients (default on; ${SHM_ENV}=0 also disables)",
    )
    parser.add_argument(
        "--shm-dir", default=None, metavar="DIR",
        help="ring-segment directory (default /dev/shm, else a per-user dir)",
    )
    parser.add_argument(
        "--shm-size", type=int, default=None, metavar="BYTES",
        help="ring size per direction (default 8 MiB or $KARPENTER_TPU_SHM_SIZE)",
    )
    parser.add_argument(
        "--mesh", default=None, metavar="SPEC",
        help="shard the production solve across a device mesh: a count "
        "('8') or NxM hosts-x-devices layout ('2x4') of real devices of "
        "--device's kind; default $KARPENTER_TPU_MESH, else single-device",
    )
    parser.add_argument(
        "--coalesce", action="store_true",
        help="fleet topology: batch concurrent solves from N operator "
        "replicas into shared dispatch windows (deterministic tenant "
        "ordering, per-tenant breaker; see docs/operations.md)",
    )
    parser.add_argument(
        "--tenant-budget", type=float, default=0.0, metavar="SECONDS",
        help="per-tenant dispatch deadline budget under --coalesce "
        "(0 = unbounded); a blown budget refuses THAT tenant's solve "
        "into its client's overload ladder",
    )
    parser.add_argument(
        "--device", default="cuda",
        help="torch device the kernels run on (default cuda; cpu runs their "
        "plain versions and must be asked for)",
    )
    args = parser.parse_args(argv)

    device = torch.device(args.device)
    mesh = None
    mesh_spec = args.mesh if args.mesh is not None else os.environ.get("KARPENTER_TPU_MESH")
    if mesh_spec:
        from karpenter_tpu_torch.fleet.shard import parse_mesh_spec

        try:
            mesh = parse_mesh_spec(mesh_spec, device)
        except ValueError as e:
            # more shards than real devices: a configuration error, never
            # a quiet shrink
            parser.error(str(e))
    if device.type == "cuda" and not torch.cuda.is_available():
        print("karpenter-tpu-torch-solver: no CUDA device is available; "
              "the sidecar does not move to the CPU unless --device cpu asks for it",
              file=sys.stderr, flush=True)
        return 2
    if device.type == "cuda":
        # the versioned kernel-library store, prepared before the first
        # dispatch (the JAX sidecar enables its compilation cache here):
        # a restarted sidecar loads the kernels without nvcc. Failure
        # returns None and the kernels build on first use
        from karpenter_tpu_torch.utils import enable_compilation_cache

        enable_compilation_cache()
    token = None
    if args.token_file:
        with open(args.token_file) as f:
            token = f.read().strip()
    ctx = None
    if args.tls_cert:
        import ssl

        ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
        ctx.load_cert_chain(args.tls_cert, args.tls_key)
    shm_kw = dict(shm=args.shm, shm_dir=args.shm_dir, shm_size=args.shm_size, device=device)
    if mesh is not None:
        shm_kw["mesh"] = mesh
    if args.coalesce:
        from karpenter_tpu_torch.fleet.coalesce import DispatchCoalescer

        shm_kw["coalescer"] = DispatchCoalescer(budget_s=args.tenant_budget)
    if args.host is not None:
        server = SolverServer(
            args.host, args.port, token=token,
            insecure_tcp=args.insecure, ssl_context=ctx,
            handshake_timeout=args.handshake_timeout, **shm_kw,
        ).start()
        print(
            f"solver service listening on {server.address[0]}:{server.address[1]}",
            flush=True,
        )
    else:
        if args.tls_cert or args.tls_key or args.insecure:
            # accepting-and-ignoring a security flag is how plaintext
            # traffic ships with an operator believing it is encrypted
            parser.error("--tls-cert/--tls-key/--insecure apply to TCP mode (--host)")
        path = args.socket or default_socket_path()
        if args.socket:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        else:
            ensure_socket_dir(path)  # squatting defense for the default dir
        server = SolverServer(path=path, token=token, **shm_kw).start()
        print(f"solver service listening on {path}", flush=True)
    # SIGTERM stops the server like ^C: live ring segments are flagged
    # closed and unlinked by their handlers
    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: stop.set())
    try:
        stop.wait()
    except KeyboardInterrupt:
        pass
    server.stop()
    return 0


if __name__ == "__main__":
    sys.exit(serve_main())
