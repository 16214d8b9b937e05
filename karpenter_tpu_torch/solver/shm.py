"""Shared-memory ring transport for the colocated solver sidecar.

Copy of karpenter_tpu/solver/shm.py, whole, with the port's failpoints
and metrics: the segment layout, magic, file names and ring protocol are
the JAX package's byte for byte, so a JAX client attaches the port
server's segments and the reverse (tests/test_torch_wire.py).

The wire round-trip is the dominant warm-tick term after the delta-solve
work (ROADMAP "Where the time goes now": ~67 ms wire vs ~8 ms device
exec), and for the deployed topology -- reconcilers and solver sidecar
sharing one TPU VM -- most of that is loopback socket machinery moving
bytes both processes could simply share. This module provides that
sharing as a BYTE TRANSPORT under the existing RPC framing (rpc.py):
one mmap'd file carries two single-producer/single-consumer byte rings
(client->server and server->client), and a `RingEndpoint` exposes the
socket surface the framing layer already speaks (`sendall`, `sendmsg`,
`recv`, `recv_into`, `settimeout`, `close`).

Because the framing -- length-prefixed JSON header, tensor payload,
crc32 -- is unchanged, every contract layered on it carries over
untouched: request pipelining, `StaleSeqnumError`/`StaleEpochError`
recovery, delta class epochs, the circuit breaker. Corruption in the
ring (torn write, bit rot, the `rpc.shm.corrupt` failpoint) surfaces
exactly as socket corruption does: a crc/JSON mismatch raising
ConnectionError, which the client ladder answers by reconnecting --
after `SolverClient`'s consecutive-shm-failure budget, WITHOUT shm
(the automatic degrade to the portable socket path).

Layout of the segment file (little-endian, sized 192 + 2*ring_size):

    0:8     magic  b"KTPUSHM1"
    8:16    ring_size (u64, per direction)
    16:24   creator pid (u64; also encoded in the filename for the
            stale-segment janitor)
    24      server-closed flag (u8)
    25      client-closed flag (u8)
    64:80   ring A header: head u64, tail u64   (client -> server)
    128:144 ring B header: head u64, tail u64   (server -> client)
    192:+S  ring A data
    192+S:  ring B data

head/tail are monotonically increasing byte counters (position =
counter % ring_size); a single writer advances head after the bytes
land, a single reader advances tail after copying out. Aligned 8-byte
loads/stores are atomic on every platform this runs on, and the frame
crc is the backstop for the (theoretical) torn read.

The segment lives in /dev/shm when available (tmpfs -- this IS shared
memory; an mmap'd file there avoids the multiprocessing.shared_memory
resource-tracker coupling), else a mode-0700 per-user directory. The
server creates one segment per connection, mode 0600, and unlinks it on
connection teardown; `cleanup_stale` sweeps segments whose creating pid
is dead (the crash-leftover case -- see the docs/operations.md runbook,
which ties this into the restart recovery sweep).
"""
from __future__ import annotations

import mmap
import os
import re
import select
import socket
import struct
import time
import uuid
from typing import Optional

from karpenter_tpu_torch import failpoints, metrics

MAGIC = b"KTPUSHM1"
SIZE_ENV = "KARPENTER_TPU_SHM_SIZE"
# 8 MiB per direction: >= 2x the largest production frame (a full
# 50k-tier catalog stage is a few hundred KB; delta solves ship ~KBs).
# Sizing guidance lives in docs/operations.md.
DEFAULT_RING_SIZE = 8 * 1024 * 1024
MIN_RING_SIZE = 64 * 1024

# ring-full SEND bound: a send blocked on a wedged reader (the peer
# stopped draining but its process is alive, so no liveness signal fires)
# must abandon within this budget when the endpoint carries no timeout of
# its own -- the server's reply sends were previously unbounded
SEND_TIMEOUT_DEFAULT = 30.0

PREFIX = "karpenter-tpu-ring-"
_NAME_RE = re.compile(rf"^{re.escape(PREFIX)}(\d+)-[0-9a-f]+$")

_Q = struct.Struct("<Q")
_HDR_BYTES = 192
_OFF_SIZE = 8
_OFF_PID = 16
_OFF_SERVER_CLOSED = 24
_OFF_CLIENT_CLOSED = 25
_RING_A_HDR = 64   # client -> server
_RING_B_HDR = 128  # server -> client


class ShmError(ConnectionError):
    """Shared-memory transport failure. A ConnectionError on purpose:
    every caller ladder (reconnect, breaker, pipelined barrier) already
    degrades on that type, so shm failures recover identically."""


class ShmAttachError(ShmError):
    """The segment could not be attached/validated (missing file, magic
    or geometry mismatch, injected `rpc.shm.attach` fault). The client
    answers by staying on the socket transport for the connection."""


class ShmSendTimeoutError(ShmError, TimeoutError):
    """Ring-full send abandoned at the send deadline (a wedged reader).
    Also a TimeoutError on purpose: the client's tick-budget exemption
    (rpc.SolverClient._wire_failed) recognizes timeouts that fired under
    a CLAMPED budget as deliberate overload shedding -- without the dual
    parentage, one storm's clamped send waits would count toward
    SHM_MAX_FAILURES and permanently degrade the ring to tcp, the exact
    outcome the exemption exists to prevent on the read path."""


class ShmPeerGoneError(ShmError):
    """Peer death detected BEFORE any byte of the current frame went onto
    the ring -- pure peer death, not evidence the ring is bad, and NOT
    counted toward the shm degrade ladder (a crash-looping sidecar gets a
    fresh segment per reconnect, so deaths between solves must not make
    the tcp fallback sticky). Peer loss mid-frame or while a reply is
    owed stays plain ShmError: the server hangs up on a corrupt stream,
    so from the sender's side that EOF is ambiguous with corruption and
    must count."""


def default_dir() -> str:
    """Segment directory: /dev/shm (tmpfs) when present, else the same
    per-user directory discipline as the RPC socket (rpc.py) -- never a
    shared world-writable path."""
    if os.path.isdir("/dev/shm"):
        return "/dev/shm"
    return os.environ.get("XDG_RUNTIME_DIR") or f"/tmp/karpenter-tpu-{os.getuid()}"


def ring_size() -> int:
    try:
        n = int(os.environ.get(SIZE_ENV, DEFAULT_RING_SIZE))
    except ValueError:
        n = DEFAULT_RING_SIZE
    return max(MIN_RING_SIZE, n)


def cleanup_stale(directory: Optional[str] = None) -> int:
    """Unlink ring segments whose creating pid is dead -- the crash
    leftovers a SIGKILL'd sidecar cannot clean after itself. Runs at
    server start (the transport-level analogue of the restart recovery
    sweep); entirely best-effort, a janitor must never fail a boot."""
    directory = directory or default_dir()
    removed = 0
    try:
        # sorted: the sweep's unlink order (and its log lines) must not
        # depend on readdir order -- the janitor runs inside seeded tests
        names = sorted(os.listdir(directory))
    except OSError:
        return 0
    for name in names:
        m = _NAME_RE.match(name)
        if m is None:
            continue
        pid = int(m.group(1))
        try:
            os.kill(pid, 0)
            continue  # creator alive: the segment may be in use
        except ProcessLookupError:
            pass
        except OSError:
            continue  # EPERM: someone else's process -- leave it alone
        try:
            os.unlink(os.path.join(directory, name))
            removed += 1
        except OSError:
            pass
    return removed


class ShmSegment:
    """One mmap'd ring-pair segment. The server `create()`s it per
    connection; the client `attach()`es by path. Both sides build
    endpoints over the same mapping via `endpoint()`."""

    def __init__(self, path: str, fd: int, mm: mmap.mmap, size: int, owner: bool):
        self.path = path
        self.size = size
        self._fd = fd
        self._mm = mm
        self.mv = memoryview(mm)
        self._owner = owner
        self._closed = False

    # -- construction --------------------------------------------------------
    @classmethod
    def create(cls, size: Optional[int] = None, directory: Optional[str] = None) -> "ShmSegment":
        size = size or ring_size()
        directory = directory or default_dir()
        os.makedirs(directory, mode=0o700, exist_ok=True)
        if directory not in ("/dev/shm", "/tmp", "/run", "."):
            # same squatting defense as rpc.ensure_socket_dir: makedirs'
            # mode is ignored for a PRE-EXISTING directory, and the /tmp
            # fallback path is guessable -- chmod on another user's
            # squatted directory raises EPERM instead of silently
            # trusting it with our segment files
            os.chmod(directory, 0o700)
        name = f"{PREFIX}{os.getpid()}-{uuid.uuid4().hex[:8]}"
        path = os.path.join(directory, name)
        fd = os.open(path, os.O_CREAT | os.O_EXCL | os.O_RDWR, 0o600)
        try:
            os.ftruncate(fd, _HDR_BYTES + 2 * size)
            mm = mmap.mmap(fd, _HDR_BYTES + 2 * size)
        except OSError:
            os.close(fd)
            os.unlink(path)
            raise
        seg = cls(path, fd, mm, size, owner=True)
        seg.mv[0:8] = MAGIC
        _Q.pack_into(seg.mv, _OFF_SIZE, size)
        _Q.pack_into(seg.mv, _OFF_PID, os.getpid())
        return seg

    @classmethod
    def attach(cls, path: str, size: int) -> "ShmSegment":
        """Map an existing segment, validating magic and geometry. Any
        mismatch is ShmAttachError: attaching a hostile or stale file
        must degrade to the socket, never desynchronize the stream."""
        failpoints.eval("rpc.shm.attach")
        try:
            fd = os.open(path, os.O_RDWR)
        except OSError as e:
            raise ShmAttachError(f"shm attach: {e}") from None
        try:
            st = os.fstat(fd)
            if st.st_size != _HDR_BYTES + 2 * size:
                os.close(fd)
                raise ShmAttachError(
                    f"shm attach: {path} is {st.st_size} bytes, geometry wants "
                    f"{_HDR_BYTES + 2 * size}"
                )
            mm = mmap.mmap(fd, st.st_size)
        except ShmAttachError:
            raise
        except (OSError, ValueError) as e:
            os.close(fd)
            raise ShmAttachError(f"shm attach: {e}") from None
        seg = cls(path, fd, mm, size, owner=False)
        if bytes(seg.mv[0:8]) != MAGIC or _Q.unpack_from(seg.mv, _OFF_SIZE)[0] != size:
            seg.close()
            raise ShmAttachError(f"shm attach: {path} magic/size mismatch")
        return seg

    # -- lifecycle -----------------------------------------------------------
    def endpoint(self, role: str, liveness: Optional[socket.socket] = None,
                 timeout: Optional[float] = None,
                 send_timeout: Optional[float] = None) -> "RingEndpoint":
        return RingEndpoint(self, role, liveness=liveness, timeout=timeout,
                            send_timeout=send_timeout)

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        try:
            self.mv.release()
        except (BufferError, ValueError):
            pass  # releasing twice (or with exports live) is harmless
        try:
            self._mm.close()
        except (BufferError, OSError):
            pass
        try:
            os.close(self._fd)
        except OSError:
            pass

    def set_closed_flags(self) -> None:
        """Flag BOTH sides closed so any endpoint blocked in a ring wait
        (either direction, either process) wakes with a peer-closed
        error -- the server's stop() uses this to unstick handler
        threads it cannot otherwise reach."""
        try:
            self.mv[_OFF_SERVER_CLOSED] = 1
            self.mv[_OFF_CLIENT_CLOSED] = 1
        except (ValueError, IndexError):
            pass  # already unmapped

    def destroy(self) -> None:
        """close + unlink (the owner's teardown). Unlinking an already-
        gone file is fine: the janitor may have raced us after a crash."""
        self.close()
        try:
            os.unlink(self.path)
        except OSError:
            pass


class RingEndpoint:
    """Socket-shaped endpoint over one segment: writes go to this role's
    TX ring, reads come from its RX ring. Single producer and single
    consumer per ring by construction (one client connection, one server
    handler thread). Blocking semantics mirror a socket: sends block on
    ring-full (backpressure, counted -- not an error), reads block on
    ring-empty; both honor `settimeout` by raising socket.timeout (an
    OSError, so every existing reconnect/breaker ladder handles it)."""

    transport_label = "shm"

    def __init__(self, seg: ShmSegment, role: str,
                 liveness: Optional[socket.socket] = None,
                 timeout: Optional[float] = None,
                 send_timeout: Optional[float] = None):
        if role not in ("client", "server"):
            raise ValueError(f"unknown ring role {role!r}")
        self._seg = seg
        self.role = role
        size = seg.size
        if role == "client":
            self._tx_hdr, self._tx_data = _RING_A_HDR, _HDR_BYTES
            self._rx_hdr, self._rx_data = _RING_B_HDR, _HDR_BYTES + size
            self._own_flag, self._peer_flag = _OFF_CLIENT_CLOSED, _OFF_SERVER_CLOSED
        else:
            self._tx_hdr, self._tx_data = _RING_B_HDR, _HDR_BYTES + size
            self._rx_hdr, self._rx_data = _RING_A_HDR, _HDR_BYTES
            self._own_flag, self._peer_flag = _OFF_SERVER_CLOSED, _OFF_CLIENT_CLOSED
        self._size = size
        self._liveness = liveness
        self._timeout = timeout
        # dedicated SEND bound for the ring-full wait: a server handler
        # legitimately parks in recv with timeout=None between operator
        # ticks, but its reply SENDS must never block forever on a reader
        # that stopped draining -- see _send_budget
        self._send_timeout = send_timeout
        self._closed = False

    # -- ring-pointer accessors (aligned u64 loads/stores) --------------------
    def _load(self, off: int) -> int:
        return _Q.unpack_from(self._seg.mv, off)[0]

    def _store(self, off: int, val: int) -> None:
        _Q.pack_into(self._seg.mv, off, val)

    def settimeout(self, timeout: Optional[float]) -> None:
        self._timeout = timeout

    def gettimeout(self) -> Optional[float]:
        return self._timeout

    # -- liveness ------------------------------------------------------------
    def _check_peer(self) -> None:
        if self._closed:
            raise ShmError("shm endpoint closed")
        if self._seg.mv[self._peer_flag]:
            raise ShmError("shm peer closed")
        sock = self._liveness
        if sock is not None:
            # the anchor socket carries no frames after the switch; it
            # exists exactly so a SIGKILL'd peer (which can never set its
            # closed flag) is still detected -- EOF here means the peer
            # process is gone
            eof = False
            try:
                # poll, not select: a controller process routinely holds
                # >1024 fds, and select.select raises ValueError past
                # FD_SETSIZE -- which would read as peer death here and
                # doom every ring negotiation in a big process
                poller = select.poll()
                poller.register(sock, select.POLLIN)
                if poller.poll(0):
                    eof = sock.recv(1, socket.MSG_PEEK | socket.MSG_DONTWAIT) == b""
            except BlockingIOError:
                pass  # raced the readability hint; the peer is alive
            except (OSError, ValueError) as e:
                raise ShmError(f"shm liveness check: {e}") from None
            if eof:
                raise ShmError("shm peer connection closed")

    _USE_ENDPOINT_TIMEOUT = object()  # sentinel: _wait uses self._timeout

    def _wait(self, avail, what: str, timeout=_USE_ENDPOINT_TIMEOUT) -> int:
        """Spin-then-sleep until `avail()` returns nonzero. The first
        ~200 iterations yield only (the peer is usually mid-memcpy);
        past that the poll backs off to 200 us, then 2 ms, then -- after
        ~1.5 s of sustained idleness -- 10 ms: a handler parked in recv
        between operator ticks must idle at ~100 wakeups/s, not burn a
        core. Peer-liveness checks ride the poll (denser on the deep
        rung), so a dead peer surfaces in well under a second and a
        wedged one at the configured timeout. `timeout` overrides the
        endpoint timeout for waits with their own budget (the ring-full
        send bound)."""
        if timeout is RingEndpoint._USE_ENDPOINT_TIMEOUT:
            timeout = self._timeout
        deadline = None if timeout is None else time.monotonic() + timeout
        spins = 0
        while True:
            n = avail()
            if n:
                return n
            spins += 1
            if spins < 200:
                sleep = 0.0
            elif spins < 2000:
                sleep = 0.0002
            elif spins < 2700:  # ~1.4 s cumulative on the 2 ms rung
                sleep = 0.002
            else:
                sleep = 0.01
            if spins % (16 if sleep >= 0.01 else 64) == 0:
                self._check_peer()
                if deadline is not None and time.monotonic() > deadline:
                    raise socket.timeout(f"shm {what} timed out")
            time.sleep(sleep)

    # -- send ----------------------------------------------------------------
    def _tx_free(self) -> int:
        return self._size - (self._load(self._tx_hdr) - self._load(self._tx_hdr + 8))

    def _send_budget(self) -> float:
        """The ring-full send bound: the endpoint's dedicated send
        timeout, else its read timeout, else the module default -- NEVER
        unbounded. A reader that stopped draining but whose process is
        alive defeats every liveness check; without this bound a reply
        send into its full ring blocked forever (and the server handler
        thread with it)."""
        if self._send_timeout is not None:
            return self._send_timeout
        if self._timeout is not None:
            return self._timeout
        return SEND_TIMEOUT_DEFAULT

    def _write_buf(self, mv: memoryview) -> None:
        off, n = 0, len(mv)
        data0, size = self._tx_data, self._size
        # ONE deadline for the whole buffer send, armed at the FIRST
        # ring-full stall: a reader that frees a trickle of space before
        # each wait must not reset the budget per stall, or a
        # mostly-wedged reader keeps a multi-chunk send (and the handler
        # thread behind it) blocked for its lifetime -- the bound is per
        # SEND, not per wait
        send_deadline = None
        while off < n:
            free = self._tx_free()
            if not free:
                # backpressure, not an error: the reader is draining.
                # Counted so an undersized segment is visible in metrics.
                metrics.WIRE_SHM_RING_FULL.inc()
                if send_deadline is None:
                    send_deadline = time.monotonic() + self._send_budget()
                try:
                    remaining = send_deadline - time.monotonic()
                    if remaining <= 0:
                        raise socket.timeout("shm send budget spent")
                    free = self._wait(self._tx_free, "send", timeout=remaining)
                except socket.timeout:
                    # a WEDGED reader (alive process, stopped draining):
                    # surface as a counted ConnectionError so the client's
                    # shm degrade ladder (SHM_MAX_FAILURES -> tcp) and the
                    # server's handler teardown both take over, instead of
                    # this thread blocking for the reader's lifetime
                    metrics.WIRE_SHM_SEND_TIMEOUTS.inc()
                    raise ShmSendTimeoutError(
                        f"shm ring-full send timed out after "
                        f"{self._send_budget()}s (peer reader wedged)"
                    ) from None
            head = self._load(self._tx_hdr)
            pos = head % size
            chunk = min(free, n - off, size - pos)
            self._seg.mv[data0 + pos : data0 + pos + chunk] = mv[off : off + chunk]
            # publish AFTER the bytes land (single writer; the frame crc
            # backstops any torn read)
            self._store(self._tx_hdr, head + chunk)
            off += chunk

    def sendmsg(self, buffers) -> int:
        """Scatter-gather write: each buffer memcpys straight into the
        ring (the one unavoidable transport write -- there is no
        intermediate assembly buffer)."""
        try:
            self._check_peer()
        except ShmError as e:
            # nothing of this frame is on the ring yet: the peer was
            # ALREADY gone, which is not evidence the ring is bad
            raise ShmPeerGoneError(str(e)) from None
        views = [b if isinstance(b, memoryview) else memoryview(b) for b in buffers]
        if failpoints.live("rpc.shm.corrupt") is not None:
            # chaos path: the corrupt site flips one byte of the frame as
            # written INTO the ring -- the reader's crc/JSON checks must
            # detect it, exactly as socket-level bit rot would land; a
            # drill on an unrelated site, or one already spent, must not
            # cost the zero-copy path. The joining copy counts like every
            # other encode copy.
            data = failpoints.corrupt("rpc.shm.corrupt", b"".join(views))
            metrics.WIRE_PAYLOAD_COPIES.inc(side="encode")
            views = [memoryview(data)]
        total = 0
        for v in views:
            if v.format != "B" or v.ndim != 1:
                v = v.cast("B")
            self._write_buf(v)
            total += len(v)
        return total

    def sendall(self, data) -> None:
        self.sendmsg([data])

    # -- receive -------------------------------------------------------------
    def _rx_avail(self) -> int:
        return self._load(self._rx_hdr) - self._load(self._rx_hdr + 8)

    def recv_into(self, view) -> int:
        """Fill `view` with up to len(view) available bytes (blocking
        until at least one is readable) -- socket.recv_into semantics,
        copying straight from the ring into the caller's buffer (the
        final tensor buffer in the framing layer: no intermediate)."""
        if not isinstance(view, memoryview):
            view = memoryview(view)
        if view.format != "B" or view.ndim != 1:
            view = view.cast("B")
        want = len(view)
        if want == 0:
            return 0
        avail = self._rx_avail()
        if not avail:
            avail = self._wait(self._rx_avail, "recv")
        tail = self._load(self._rx_hdr + 8)
        pos = tail % self._size
        chunk = min(avail, want, self._size - pos)
        data0 = self._rx_data
        view[:chunk] = self._seg.mv[data0 + pos : data0 + pos + chunk]
        self._store(self._rx_hdr + 8, tail + chunk)
        return chunk

    def recv(self, n: int) -> bytes:
        buf = bytearray(min(n, 65536))
        got = self.recv_into(memoryview(buf))
        return bytes(buf[:got])

    # -- teardown ------------------------------------------------------------
    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        try:
            self._seg.mv[self._own_flag] = 1
        except (ValueError, IndexError):
            pass  # segment already unmapped
