"""Liveness/readiness endpoints for the deployed controller.

The reference inherits /healthz+pprof from its core operator manager
(SURVEY §5: controller-runtime health probes; the chart wires kubelet
probes to them). The equivalent here is a tiny stdlib HTTP server the
binary starts next to the run loop, with TWO heartbeats so leader
election composes correctly:

- `beat_loop()` fires every run-loop iteration, leader or standby:
  it proves the PROCESS is turning.
- `beat_sweep()` fires only when a full controller sweep ran (the
  elected leader): it proves the replica is SERVING.

Probes:

- `/healthz` (liveness): 503 when the run loop has not turned within
  `stall_after` seconds -- a wedged loop (hung cloud call, deadlock) or
  a cold start stuck past `startup_grace` before the loop ever began.
  A healthy STANDBY keeps beating the loop and stays 200 forever.
- `/readyz` (readiness): 200 while a full sweep completed within
  `stall_after` -- standbys and demoted ex-leaders report 503 (not
  serving), which is endpoint semantics, not a restart signal.
- `/metrics`: the Prometheus registry.
- `/debug/` (and every route under it): the loopback-only debug surface.
  The index route enumerates every endpoint with a one-line description
  (DEBUG_ENDPOINTS below is the single source; docs/observability.md
  carries the matching table and tests/test_obs.py parametrizes the
  loopback-enforcement suite over it). /healthz also carries the breaker
  state in its body -- an OPEN breaker is a degraded-but-alive condition
  (CPU fallback serving), never a liveness failure.

Heartbeats are plain float timestamps; reads are lock-free (float
stores are atomic in CPython).

Copy of karpenter_tpu/operator/health.py, imports rewritten to the port's.
`/debug/profile` arms the port's torch.profiler capture
(obs/profiler.py); `/debug/aot` serves `TorchSolver.describe_aot` (the
warm-up ladder and the kernel-library store, solver/aot.py).
"""
from __future__ import annotations

import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, urlparse

from karpenter_tpu_torch.logging import get_logger

# the loopback-only debug surface, enumerated: path -> one-line
# description. Served as JSON by the index routes (`/debug`, `/debug/`),
# mirrored as a table in docs/observability.md (test-pinned), and the
# loopback-enforcement tests parametrize over exactly this dict -- a new
# endpoint that skips it ships without enforcement coverage and fails
# the suite.
DEBUG_ENDPOINTS = {
    "/debug/stacks": (
        "every thread's current stack (the pprof-goroutine analogue)"),
    "/debug/traces": (
        "slow-tick trace recorder: the last N span trees whose sweep "
        "exceeded the slow threshold, plus the worst-ever tree "
        "(karpenter_tpu_torch/tracing.py)"),
    "/debug/breaker": (
        "solver-wire circuit breaker state: consecutive failures, "
        "backoff, probe history (solver/breaker.py)"),
    "/debug/solver": (
        "incremental-tick engine + observatory state: grouping churn, "
        "delta shipping, staged bytes by kind, the per-jit-entry cost "
        "table, staging LRUs and eviction counters (solver/service.py)"),
    "/debug/journal": (
        "crash-consistency intent journal: open write-ahead intents + "
        "the recently-resolved ring (karpenter_tpu_torch/journal.py)"),
    "/debug/overload": (
        "overload control: deadline/admission bounds, brownout ladder "
        "level + overrun EWMA, watchdog escalations "
        "(karpenter_tpu_torch/overload.py)"),
    "/debug/flightdata": (
        "always-on flight-data recorder: one compact record per tick "
        "for the last 256 ticks -- the black box the crash paths flush "
        "to JSONL (karpenter_tpu_torch/obs/flight.py)"),
    "/debug/profile": (
        "on-demand torch.profiler capture: ?ticks=N arms a trace "
        "bracketing the next N production ticks (a Chrome trace per "
        "capture); without ?ticks reads the capture state "
        "(karpenter_tpu_torch/obs/profiler.py)"),
    "/debug/quality": (
        "solution-quality observatory: the last solve's optimality gap "
        "(realized fleet price / fractional bound), waste attribution "
        "(stranded CPU/mem, fragmentation index), price by pool and "
        "capacity type (karpenter_tpu_torch/obs/quality.py)"),
    "/debug/aot": (
        "compile-cache subsystem: cache fingerprint + exec store, "
        "armed-executable coverage per jit entry, warmup-ladder "
        "progress and duty cycle, deserialize/dispatch fallback "
        "counts (karpenter_tpu_torch/solver/aot.py)"),
}


class HealthServer:
    log = get_logger("health")

    def __init__(
        self, port: int = 8081, stall_after: float = 300.0,
        startup_grace: float = 600.0,
    ):
        self.port = port
        self.stall_after = stall_after
        self.startup_grace = startup_grace
        # optional () -> dict with the solver-wire breaker's state
        # (CircuitBreaker.describe); wired by the binary after the
        # operator graph builds. None = no wire configured.
        self.breaker_info = None
        # optional () -> dict with the incremental-tick engine's state
        # (TorchSolver.describe_wire: grouping churn, delta shipping mode,
        # staged seqnums/epochs, sidecar eviction counters). Served by
        # /debug/solver, loopback-only.
        self.solver_info = None
        # optional () -> dict with the intent journal's state (IntentJournal
        # .describe: open write-ahead intents off the coordination bus plus
        # the recently-resolved ring). Served by /debug/journal,
        # loopback-only -- the runbook's first stop after an operator
        # restart (docs/operations.md).
        self.journal_info = None
        # optional () -> dict with the overload-control state (Operator
        # .describe_overload: deadline/admission bounds, brownout ladder
        # level + overrun EWMA, watchdog escalations). Served by
        # /debug/overload, loopback-only -- the overload runbook's first
        # stop during a storm (docs/operations.md).
        self.overload_info = None
        # optional () -> dict with the cold-start state (TorchSolver
        # .describe_aot: store fingerprint, armed graphs per entry, ladder
        # progress, fallback counts). Served by /debug/aot, loopback-only
        # -- the cold-start runbook's first stop when a restart is slow.
        self.aot_info = None
        # whether the run loop actually brackets ticks with the profiler
        # (Options.observatory): with the observatory off, an armed
        # capture would wait forever, so /debug/profile must report
        # unconfigured instead of arming into the void. The binary wires
        # this from its flags; standalone servers (tests) default on.
        self.profile_enabled = True
        self._started_at = time.monotonic()
        self._last_loop: float = 0.0   # 0 = run loop has not turned yet
        self._last_sweep: float = 0.0  # 0 = no full sweep completed yet
        self._server: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    # -- heartbeats (called by the run loop) --------------------------------
    def beat_loop(self) -> None:
        self._last_loop = time.monotonic()

    def beat_sweep(self) -> None:
        self._last_sweep = time.monotonic()

    # -- probe logic --------------------------------------------------------
    def alive(self) -> bool:
        now = time.monotonic()
        last = self._last_loop
        if last == 0.0:
            # cold start: alive until the startup grace runs out, so a
            # build that NEVER reaches the loop still gets restarted
            # (no separate startupProbe needed -- one that targeted
            # readiness would kill healthy standbys)
            return (now - self._started_at) < self.startup_grace
        return (now - last) < self.stall_after

    def ready(self) -> bool:
        last = self._last_sweep
        return last != 0.0 and (time.monotonic() - last) < self.stall_after

    def _breaker_doc(self) -> Optional[dict]:
        fn = self.breaker_info
        if fn is None:
            return None
        try:
            return fn()
        except Exception:  # noqa: BLE001 -- a probe must never 500 on this
            from karpenter_tpu_torch import metrics

            metrics.HANDLED_ERRORS.inc(site="health.breaker_doc")
            return None

    # -- server -------------------------------------------------------------
    def start(self) -> "HealthServer":
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _send(self, code: int, body: str, ctype: str = "text/plain"):
                data = body.encode()
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def _loopback_only(self) -> bool:
                """ONE guard for every /debug endpoint: stack traces and
                span attributes are an information-disclosure surface, and
                `kubectl port-forward`/`exec` reach loopback while
                arbitrary pod-network peers do not. Sends the 403 itself
                when the peer is not local."""
                if self.client_address[0] in ("127.0.0.1", "::1"):
                    return True
                self._send(403, "debug endpoints are loopback-only")
                return False

            def _debug_json(self, fn) -> None:
                """Shared serving for callback-backed /debug endpoints:
                loopback guard, never-500 evaluation, JSON body. fn may be
                None (not configured) or raise (reported as unconfigured)."""
                if not self._loopback_only():
                    return
                import json

                try:
                    doc = fn() if fn is not None else None
                except Exception:  # noqa: BLE001 -- debug must never 500
                    from karpenter_tpu_torch import metrics

                    metrics.HANDLED_ERRORS.inc(site="health.debug_endpoint")
                    doc = None
                self._send(
                    200,
                    json.dumps(doc if doc is not None else {"configured": False}, indent=2),
                    ctype="application/json",
                )

            def do_GET(self):
                # /debug/profile carries a query string; everything else
                # matches on the bare path
                url = urlparse(self.path)
                if url.path in ("/debug", "/debug/"):
                    # the index: every debug endpoint with its one-line
                    # description (loopback-only like its members)
                    self._debug_json(lambda: {"endpoints": DEBUG_ENDPOINTS})
                    return
                if url.path == "/debug/flightdata":
                    # always-on flight-data ring (karpenter_tpu_torch/obs/
                    # flight.py): one compact record per tick, the black
                    # box the crash paths flush
                    if not self._loopback_only():
                        return
                    from karpenter_tpu_torch.obs import flight

                    self._send(
                        200, flight.dump_json(indent=2),
                        ctype="application/json",
                    )
                    return
                if url.path == "/debug/quality":
                    # solution-quality observatory (karpenter_tpu_torch/obs/
                    # quality.py): the last solve's gap + waste
                    # attribution document, recorded process-wide by
                    # solve_finish -- no binary wiring needed
                    if not self._loopback_only():
                        return
                    from karpenter_tpu_torch.obs import quality

                    self._send(
                        200, quality.dump_json(indent=2),
                        ctype="application/json",
                    )
                    return
                if url.path == "/debug/profile":
                    # on-demand torch.profiler capture (karpenter_tpu_torch/obs/
                    # profiler.py): ?ticks=N arms the next N production
                    # ticks; no query = read the capture state
                    if not self._loopback_only():
                        return
                    import json

                    if not outer.profile_enabled:
                        # observatory off: no tick would ever service a
                        # capture -- never arm, report unconfigured
                        self._send(
                            200, json.dumps({"configured": False}, indent=2),
                            ctype="application/json",
                        )
                        return
                    from karpenter_tpu_torch.obs.profiler import PROFILER

                    query = parse_qs(url.query)
                    ticks_raw = (query.get("ticks") or [""])[0]
                    if ticks_raw:
                        try:
                            ticks = int(ticks_raw)
                            if ticks <= 0:
                                raise ValueError(ticks_raw)
                        except ValueError:
                            self._send(400, "ticks must be a positive integer")
                            return
                        doc = PROFILER.request(ticks)
                    else:
                        doc = PROFILER.describe()
                    self._send(
                        200, json.dumps(doc, indent=2),
                        ctype="application/json",
                    )
                    return
                if self.path == "/healthz":
                    # alive() evaluated ONCE: body and status must agree
                    # even when the stall window flips mid-request
                    alive = outer.alive()
                    body = (
                        "ok" if alive
                        else "run loop stalled (or startup grace exceeded)"
                    )
                    # breaker state rides the liveness body: an OPEN
                    # breaker means degraded (CPU fallback serving), not
                    # dead -- the status code never changes for it
                    doc = outer._breaker_doc()
                    if doc is not None:
                        body += f"\nsolver-wire-breaker: {doc.get('state', 'unknown')}"
                    self._send(200 if alive else 503, body)
                elif self.path == "/readyz":
                    if outer.ready():
                        self._send(200, "ok")
                    else:
                        self._send(503, "no recent sweep (standby or not started)")
                elif self.path == "/metrics":
                    from karpenter_tpu_torch import metrics

                    self._send(200, metrics.REGISTRY.expose())
                elif self.path == "/debug/breaker":
                    # solver-wire circuit breaker (solver/breaker.py):
                    # state, consecutive failures, backoff, probe history
                    self._debug_json(outer._breaker_doc)
                elif self.path == "/debug/solver":
                    # incremental-tick engine state (solver/service.py
                    # describe_wire): grouping churn, delta shipping, the
                    # staging LRUs and their eviction counters
                    self._debug_json(outer.solver_info)
                elif self.path == "/debug/overload":
                    # overload control (karpenter_tpu_torch/overload.py):
                    # deadline/admission bounds, brownout ladder state,
                    # watchdog escalation counts
                    self._debug_json(outer.overload_info)
                elif self.path == "/debug/aot":
                    # the cold-start layer (solver/aot.py): armed graphs
                    # per entry, the library store, warm-up ladder state,
                    # fallback counts
                    self._debug_json(outer.aot_info)
                elif self.path == "/debug/journal":
                    # crash-consistency intent journal (karpenter_tpu_torch/
                    # journal.py): open write-ahead intents + the
                    # recently-resolved ring
                    self._debug_json(outer.journal_info)
                elif self.path == "/debug/traces":
                    # slow-tick flight recorder (karpenter_tpu_torch/tracing.py):
                    # the last N span trees whose sweep exceeded the slow
                    # threshold, plus the worst-ever tree
                    if not self._loopback_only():
                        return
                    from karpenter_tpu_torch import tracing

                    self._send(
                        200, tracing.dump_json(indent=2), ctype="application/json"
                    )
                elif self.path == "/debug/stacks":
                    # the pprof-goroutine analogue (the reference gets
                    # /debug/pprof from its operator manager): every
                    # thread's current stack, for diagnosing exactly the
                    # wedge /healthz reports
                    if not self._loopback_only():
                        return
                    import sys
                    import traceback

                    frames = sys._current_frames()
                    names = {t.ident: t.name for t in threading.enumerate()}
                    out = []
                    for ident, frame in frames.items():
                        out.append(f"--- thread {names.get(ident, ident)} ({ident}) ---")
                        out.extend(l.rstrip() for l in traceback.format_stack(frame))
                    self._send(200, "\n".join(out) + "\n")
                else:
                    self._send(404, "not found")

        self._server = ThreadingHTTPServer(("0.0.0.0", self.port), Handler)
        self.port = self._server.server_address[1]  # resolved when port=0
        self._thread = threading.Thread(target=self._server.serve_forever, daemon=True)
        self._thread.start()
        self.log.info("health endpoints up", port=self.port)
        return self

    def stop(self) -> None:
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None
