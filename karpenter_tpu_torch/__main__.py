"""Binary entry point: compose the operator and run the controller loop.

The analogue of cmd/controller/main.go:30-84 (operator construction, flag
parsing, controller registration, manager start) combined with kwok/main.go
(the in-memory cloud stands in for a real account, so the full stack --
providers, batchers, CloudProvider, all reconcilers, the TPU decision
plane -- runs self-contained). Flags mirror pkg/operator/options/options.go.

    python -m karpenter_tpu_torch --help
    python -m karpenter_tpu_torch --max-ticks 50 --tick-interval 0.1
    python -m karpenter_tpu_torch --device cpu --max-ticks 3 --health-port 0
    python -m karpenter_tpu_torch --kubeconfig ~/.kube/config
    python -m karpenter_tpu_torch --sim-record trace.jsonl --max-ticks 50
    python -m karpenter_tpu_torch sim replay --differential trace.jsonl

Copy of karpenter_tpu/__main__.py, imports rewritten to the port's. The
decision plane is `TorchSolver` and `ConsolidationEvaluator` on the card
(or behind the port's sidecar: $KARPENTER_TPU_SOLVER_SOCKET /
$KARPENTER_TPU_SOLVER_ADDR, with the port's client and breaker).
Differences from the JAX binary:

- a CUDA probe (`utils.probe_cuda_device`, in a subprocess) in place of
  the JAX backend probe, and NO fallback: without a card the binary
  exits 2 before building anything, naming `--device cpu`, which is the
  only way to run the kernels' plain versions on the host;
- `--device cuda|cpu` is new; `--mesh-devices` (default
  $KARPENTER_TPU_MESH) counts real devices of `--device`'s kind (the
  cards, or one CPU) and raises when there are too few -- several
  shards on one device come only from `parallel.mesh.make_mesh(n,
  devices=...)`;
- the cold-start layer as the JAX binary's: on the card the versioned
  kernel-library store is prepared under $KARPENTER_TPU_COMPILE_CACHE
  (`utils.enable_compilation_cache`), and an in-process solver is built
  with `auto_warm` and `enable_aot(store)` (the warm-up ladder, solver/
  aot.py) unless KARPENTER_TPU_AOT=0; /debug/aot serves its document. On
  `--device cpu` there is no store and no background warm-up (no library,
  no allocator to warm, and the plain scan at 1,024 classes costs the host
  seconds per bucket); the ladder still arms its plain closures.

`--kubeconfig PATH` / `--in-cluster` run the operator over a real
apiserver (`kube.KubeCluster`) as the JAX binary does: apply the port's
CRD copy, karpenter_tpu_torch/apis/crds/*.yaml, first. The CUDA probe
comes first in that mode too.
"""
from __future__ import annotations

import argparse
import signal
import sys


def build_operator(args):
    from karpenter_tpu_torch.operator import Operator, Options

    options = Options(
        cluster_name=args.cluster_name,
        interruption_queue=args.interruption_queue,
        vm_memory_overhead_percent=args.vm_memory_overhead_percent,
        reserved_nics=args.reserved_nics,
        isolated_network=args.isolated_network,
        pipelined_scheduling=getattr(args, "pipelined_scheduling", True),
        tick_deadline=getattr(args, "tick_deadline", 0.0),
        admission_max_pods=getattr(args, "admission_max_pods", 0),
        launch_max_groups=getattr(args, "launch_max_groups", 0),
        tracing=getattr(args, "tracing", True),
        tracing_sample=getattr(args, "trace_sample", 0.2),
        tracing_slow_ms=getattr(args, "trace_slow_ms", 1000.0),
        observatory=getattr(args, "observatory", True),
        seed=getattr(args, "seed", None),
    )
    # feature gates merge over the defaults (reference: the core's
    # --feature-gates flag, checked e.g. at cmd/controller/main.go:45-47)
    for pair in filter(None, (args.feature_gates or "").split(",")):
        name, sep, value = pair.partition("=")
        value = value.strip().lower()
        # malformed pairs fail startup loudly (the core's map-flag
        # semantics): a bare gate name or a typo'd boolean silently
        # becoming False would disable the feature the operator asked for
        if not sep or value not in ("true", "false", "1", "0", "yes", "no"):
            raise SystemExit(
                f"--feature-gates: malformed pair {pair!r} (want Name=true|false)"
            )
        options.feature_gates[name.strip()] = value in ("true", "1", "yes")
    solver = None
    evaluator = None
    if args.tpu_solver:
        from karpenter_tpu_torch.solver.consolidate import ConsolidationEvaluator
        from karpenter_tpu_torch.solver.service import TorchSolver

        # sidecar topology (deploy/controller.yaml): the solver process
        # owns the card; this process ships tensors over its UNIX socket
        import os as _os

        sock = _os.environ.get("KARPENTER_TPU_SOLVER_SOCKET", "")
        addr = _os.environ.get("KARPENTER_TPU_SOLVER_ADDR", "")
        solver_timeouts = dict(
            timeout=getattr(args, "solver_timeout", 30.0),
            connect_timeout=getattr(args, "solver_connect_timeout", 1.0),
        )
        client = None
        if sock:
            from karpenter_tpu_torch.solver.rpc import SolverClient

            client = SolverClient(path=sock, **solver_timeouts)
        elif addr:
            # TCP sidecar (deploy/values.yaml solver.tcp): the shared
            # token rides $KARPENTER_TPU_SOLVER_TOKEN on both ends; TLS
            # verifies the solver against $KARPENTER_TPU_SOLVER_TLS_CA
            # (the cert's SAN must cover
            # $KARPENTER_TPU_SOLVER_TLS_SERVERNAME, default the host)
            from karpenter_tpu_torch.solver.rpc import SolverClient

            host, _, port = addr.rpartition(":")
            ctx = None
            ca = _os.environ.get("KARPENTER_TPU_SOLVER_TLS_CA", "")
            if ca:
                import ssl

                ctx = ssl.create_default_context(cafile=ca)
            client = SolverClient(
                host or "127.0.0.1", int(port), ssl_context=ctx,
                server_hostname=_os.environ.get("KARPENTER_TPU_SOLVER_TLS_SERVERNAME") or None,
                **solver_timeouts,
            )
        breaker = None
        if client is not None:
            # wire circuit breaker (solver/breaker.py): K consecutive RPC
            # failures open it and solves short-circuit to the in-process
            # path on this process's device; a background jittered-backoff
            # probe re-tests the sidecar and re-promotion restages the
            # catalog
            from karpenter_tpu_torch.solver.breaker import CircuitBreaker

            breaker_kw = {}
            if getattr(args, "seed", None) is not None:
                # seed discipline: the backoff jitter joins the Options.seed
                # derivation chain (the breaker takes an injected rng, so
                # the seed is applied where the breaker is built)
                from karpenter_tpu_torch.seeding import seeded_rng

                breaker_kw["rng"] = seeded_rng("breaker", args.seed).random
            breaker = CircuitBreaker(
                failure_threshold=getattr(args, "breaker_failures", 3),
                backoff_base=getattr(args, "breaker_backoff", 0.5),
                backoff_max=getattr(args, "breaker_backoff_max", 30.0),
                auto_probe=True,
                **breaker_kw,
            )
        from karpenter_tpu_torch.solver.service import resolve_device

        device = resolve_device(getattr(args, "device", None))
        on_card = device.type == "cuda"
        # mesh-sharded production solve (fleet/): in-process mode only --
        # a sidecar owns its own mesh via `python -m
        # karpenter_tpu_torch.solver.rpc --mesh`
        mesh = None
        if client is None:
            from karpenter_tpu_torch.fleet.shard import mesh_from_env, parse_mesh_spec

            spec = getattr(args, "mesh_devices", None)
            mesh = parse_mesh_spec(spec, device) if spec else mesh_from_env(device)
        solver = TorchSolver(
            client=client, breaker=breaker, tier=getattr(args, "solve_tier", "ffd"),
            device=device, auto_warm=client is None and on_card, mesh=mesh,
        )
        # the cold-start layer (solver/aot.py): the kernel-library store
        # (libraries load at start, no nvcc on a restart), then the warm-up
        # ladder over every staged catalog. In-process solves only (a
        # sidecar owns its own); KARPENTER_TPU_AOT=0 opts out
        cache_home = None
        if on_card:
            from karpenter_tpu_torch.utils import enable_compilation_cache

            cache_home = enable_compilation_cache()
        if client is None and _os.environ.get("KARPENTER_TPU_AOT", "1") != "0":
            solver.enable_aot(cache_home)
        # the consolidation engine rides the SAME wire as the scheduling
        # solve: with a sidecar configured, candidate-set sweeps dispatch
        # as the solve_disrupt op against the catalogs already staged per
        # seqnum, and the breaker's degrade ladder covers both paths
        evaluator = ConsolidationEvaluator(solver=solver, mesh=mesh)
    cluster = None
    if getattr(args, "kubeconfig", None) or getattr(args, "in_cluster", False):
        # real coordination bus (the reference's kwok deployment topology:
        # live apiserver, emulated cloud). Apply apis/crds/*.yaml first.
        from karpenter_tpu_torch.kube import KubeClient, KubeConfig, KubeCluster

        cfg = (
            KubeConfig.in_cluster()
            if getattr(args, "in_cluster", False)
            else KubeConfig.from_kubeconfig(args.kubeconfig)
        )
        cluster = KubeCluster(KubeClient(cfg))
        # over a real bus, on_event handlers fire from watch threads (the
        # in-memory store dispatches synchronously from writes); without
        # this the pod-arrival wake-up and its batching window never engage
        from karpenter_tpu_torch.apis import Pod

        cluster.watch_events([Pod])
    return Operator(
        options=options, solver=solver, consolidation_evaluator=evaluator,
        cluster=cluster,
        identity=getattr(args, "identity", ""),
    )


def main(argv=None) -> int:
    if argv is None:
        argv = sys.argv[1:]
    if argv and argv[0] == "sim":
        # the simulation subsystem has its own verb-style CLI (generate /
        # replay / shrink / corpus) -- see karpenter_tpu_torch/sim/cli.py
        from karpenter_tpu_torch.sim.cli import main as sim_main

        return sim_main(argv[1:])
    parser = argparse.ArgumentParser(
        prog="karpenter-tpu-torch",
        description="node provisioning controller on the H100 port (kwok rig)"
    )
    parser.add_argument("--cluster-name", default="kwok-cluster")
    parser.add_argument(
        "--identity", default="",
        help="replica identity for leader election (empty = single replica, no election)",
    )
    parser.add_argument("--interruption-queue", default="interruption-queue")
    parser.add_argument("--vm-memory-overhead-percent", type=float, default=0.075)
    parser.add_argument("--reserved-nics", type=int, default=0)
    parser.add_argument("--isolated-network", action="store_true")
    parser.add_argument(
        "--feature-gates",
        default="",
        help="comma-separated Name=true|false (e.g. SpotToSpotConsolidation=true)",
    )
    parser.add_argument(
        "--tpu-solver", action=argparse.BooleanOptionalAction, default=True,
        help="route scheduling + consolidation decisions through the solver "
        "(TorchSolver on --device); --no-tpu-solver decides on the host "
        "oracle alone",
    )
    parser.add_argument(
        "--solve-tier", choices=("ffd", "convex"), default="ffd",
        help="solver decision tier: 'convex' runs the device-resident LP "
        "relaxation + deterministic rounding beside every FFD solve and "
        "ships whichever decision prices lower (never worse than FFD by "
        "construction), tightens the optimality-gap bound, and arms the "
        "global repack oracle in the disruption sweep; 'ffd' (default) "
        "is the plain fused first-fit-decreasing solve",
    )
    parser.add_argument(
        "--device", choices=("cuda", "cpu"), default=None,
        help="where the solver runs: the card by default (the binary "
        "probes it and refuses to start without one); 'cpu' runs the "
        "kernels' plain versions on the host (tests, a rig without a card)",
    )
    parser.add_argument(
        "--mesh-devices", default=None, metavar="SPEC",
        help="shard the in-process production solve across a device mesh: "
        "a count ('8') or NxM hosts-x-devices layout ('2x4') of real devices "
        "of --device's kind; default $KARPENTER_TPU_MESH, else single-device "
        "(ignored with a sidecar configured -- run the sidecar with --mesh "
        "instead)",
    )
    parser.add_argument(
        "--pipelined-scheduling", action=argparse.BooleanOptionalAction, default=True,
        help="double-buffer the provisioner tick under sustained load (the "
        "device solve overlaps the rest of the sweep; --no-pipelined-scheduling "
        "pins the synchronous dispatch+barrier path)",
    )
    parser.add_argument(
        "--solver-timeout", type=float, default=30.0,
        help="per-solve READ budget on the solver wire (seconds)",
    )
    parser.add_argument(
        "--solver-connect-timeout", type=float, default=1.0,
        help="solver-wire connection-establishment budget: connect + TLS + "
        "auth (seconds; split from --solver-timeout so a dead sidecar "
        "fails a degraded tick in ~1s, not the solve budget)",
    )
    parser.add_argument(
        "--breaker-failures", type=int, default=3,
        help="consecutive solver-wire failures that OPEN the circuit "
        "breaker (solves then fall back to the in-process CPU path "
        "instantly until a probe re-promotes)",
    )
    parser.add_argument(
        "--breaker-backoff", type=float, default=0.5,
        help="initial half-open probe backoff (seconds; doubles per failed "
        "probe with 0-50%% jitter)",
    )
    parser.add_argument(
        "--breaker-backoff-max", type=float, default=30.0,
        help="half-open probe backoff cap (seconds)",
    )
    parser.add_argument(
        "--tick-deadline", type=float, default=0.0,
        help="per-tick deadline budget in seconds (0 disables): arms the "
        "overload subsystem -- hierarchical stage budgets that clamp the "
        "solver wire's read timeout, deadline-sized admission shedding, "
        "the brownout ladder (disruption -> tracing -> delta staging), "
        "and the stuck-tick watchdog (cancel -> breaker-open -> crash)",
    )
    parser.add_argument(
        "--admission-max-pods", type=int, default=0,
        help="bounded admission: at most this many pending pods solved "
        "per tick; over the cap a deterministic priority/age-ordered "
        "prefix solves and the rest defer to later ticks (0 = unbounded)",
    )
    parser.add_argument(
        "--launch-max-groups", type=int, default=0,
        help="bounded launch fan-out: at most this many decision groups "
        "launch per tick; deferred groups' pods stay pending (0 = unbounded)",
    )
    parser.add_argument(
        "--failpoints", default="",
        help="arm fault-injection sites for game-day drills, e.g. "
        "'rpc.server.dispatch=latency(0.05):p=0.3;instance.launch="
        "error(InsufficientCapacityError):times=5' (also via "
        "$KARPENTER_TPU_FAILPOINTS; see karpenter_tpu_torch/failpoints.py)",
    )
    parser.add_argument(
        "--kubeconfig", default="",
        help="run against a REAL apiserver via this kubeconfig (apply "
        "karpenter_tpu_torch/apis/crds/*.yaml first)",
    )
    parser.add_argument(
        "--in-cluster", action="store_true",
        help="use the pod serviceaccount to reach the apiserver",
    )
    parser.add_argument("--tick-interval", type=float, default=1.0, help="seconds between sweeps")
    parser.add_argument(
        "--health-port", type=int, default=8081,
        help="liveness/readiness/metrics HTTP port (0 disables)",
    )
    parser.add_argument("--max-ticks", type=int, default=0, help="stop after N sweeps (0 = run forever)")
    parser.add_argument("--metrics-dump", action="store_true", help="print Prometheus metrics on exit")
    parser.add_argument(
        "--tracing", action=argparse.BooleanOptionalAction, default=True,
        help="scheduling-tick span tracing + slow-tick flight recorder "
        "(/debug/traces); sampled -- see --trace-sample",
    )
    parser.add_argument(
        "--trace-sample", type=float, default=0.2,
        help="fraction of sweeps feeding the per-span stats/metrics volume "
        "(the flight recorder judges EVERY sweep regardless; default 0.2)",
    )
    parser.add_argument(
        "--trace-slow-ms", type=float, default=1000.0,
        help="flight-recorder threshold: retain span trees for sweeps slower than this",
    )
    parser.add_argument(
        "--trace-dump", action="store_true",
        help="print the slow-tick flight recorder (JSON span trees) on exit",
    )
    parser.add_argument(
        "--observatory", action=argparse.BooleanOptionalAction, default=True,
        help="device performance observatory (karpenter_tpu_torch/obs/): per-tick "
        "HBM accounting, the always-on flight-data ring behind "
        "/debug/flightdata (crash-flushed to $KARPENTER_TPU_FLIGHTDATA), "
        "and profiler tick bracketing",
    )
    parser.add_argument(
        "--profile-ticks", type=int, default=0, metavar="N",
        help="arm an on-demand torch.profiler capture bracketing the first N "
        "production ticks (trace dir under $KARPENTER_TPU_PROFILE_DIR, "
        "default profiles/; same machinery as GET /debug/profile?ticks=N)",
    )
    parser.add_argument(
        "--seed", type=int, default=None,
        help="determinism root: every RNG on the replay path (object-name "
        "suffixes, failpoint schedules, trace sampling, breaker jitter) "
        "derives from this one seed (karpenter_tpu_torch/sim/)",
    )
    parser.add_argument(
        "--sim-record", default="", metavar="PATH",
        help="capture this run as a replayable JSONL trace at the cluster/"
        "cloud seam (pod arrivals/deletes, kills, interruptions, ICE, "
        "pricing, clock advances); replay with `sim replay PATH`",
    )
    args = parser.parse_args(argv)

    if args.failpoints:
        # arm BEFORE the operator graph builds so cold-start paths
        # (catalog hydration, first connects) are injectable too
        from karpenter_tpu_torch.failpoints import FAILPOINTS

        # seed FIRST: a Failpoint captures the registry seed at arm time,
        # so arming before the Operator's seed fan-out would build the
        # fault schedule from the default seed and break --seed replays
        if args.seed is not None:
            FAILPOINTS.seed = args.seed
        FAILPOINTS.arm_spec(args.failpoints)

    if args.tpu_solver and args.device != "cpu":
        # the card or nothing: probe CUDA in a subprocess (a wedged driver
        # cannot hang the binary) and refuse to start without a card --
        # the JAX binary degrades to the host CPU here; the port never
        # falls back, so a missing card is a startup failure
        from karpenter_tpu_torch.logging import get_logger
        from karpenter_tpu_torch.utils import probe_cuda_device

        name, err = probe_cuda_device()
        if name is None:
            print(
                "karpenter_tpu_torch: no usable CUDA device "
                f"({(err or '').splitlines()[-1] if err else 'probe failed'}); "
                "pass --device cpu to run the kernels' plain versions on the host",
                file=sys.stderr,
            )
            return 2
        get_logger("operator").info("CUDA probe", device=name)

    # health endpoints come up BEFORE the operator graph builds: a slow
    # or wedged cold start (catalog hydration, a hung cloud call) must
    # answer liveness 200 (readiness stays 503 until the first sweep) --
    # no listener at all reads as probe failure and restart-loops the pod
    health = None
    if args.health_port:
        from karpenter_tpu_torch.operator.health import HealthServer

        # the stall window scales with the configured sweep cadence: a
        # long --tick-interval is a HEALTHY quiet loop, not a wedge
        health = HealthServer(
            port=args.health_port,
            stall_after=max(300.0, 5 * args.tick_interval),
        ).start()

    op = build_operator(args)
    if health is not None:
        breaker = getattr(op.solver, "breaker", None)
        if breaker is not None:
            # /healthz carries the breaker state; /debug/breaker serves the
            # full document (loopback-only)
            health.breaker_info = breaker.describe
        if hasattr(op.solver, "describe_wire"):
            # /debug/solver: incremental-tick engine + staging LRU state
            health.solver_info = op.solver.describe_wire
        if hasattr(op.solver, "describe_aot"):
            # /debug/aot: armed graphs per entry + the warm-up ladder
            health.aot_info = op.solver.describe_aot
        # /debug/journal: the crash-consistency intent journal (open
        # write-ahead records + the recently-resolved ring)
        health.journal_info = op.journal.describe
        # /debug/overload: deadline/admission bounds + brownout/watchdog
        health.overload_info = op.describe_overload
        # /debug/profile only arms captures a tick will actually service
        health.profile_enabled = args.observatory
    if args.profile_ticks > 0 and args.observatory:
        # same machinery the /debug/profile endpoint arms -- here it
        # brackets the FIRST ticks, so warmup compiles land in the trace
        from karpenter_tpu_torch.obs.profiler import PROFILER

        PROFILER.request(args.profile_ticks)
    if op.watchdog is not None:
        # the stuck-tick watchdog's background thread is a wall-clock
        # deployment concern -- deterministic rigs drive check_now().
        # Its crash escalation raises OperatorCrashed in the run loop
        # below; nothing here may catch it (the process dies, the
        # supervisor restarts it, and the recovery sweep takes over).
        op.watchdog.start()
    # latency GC policy: the provider graph and the torch runtime are
    # now the long-lived baseline; freeze it and stop gen2 collections
    # from landing inside scheduling ticks
    from karpenter_tpu_torch.utils import configure_gc_for_latency

    configure_gc_for_latency()
    # a default NodeClass + NodePool so the RIG provisions out of the box.
    # Never against a real apiserver: auto-writing a provisioning policy
    # into live infrastructure is an operator decision, not a default.
    from karpenter_tpu_torch.apis import NodePool, TPUNodeClass

    kube_mode = bool(args.kubeconfig or args.in_cluster)
    if not kube_mode and not op.cluster.list(TPUNodeClass):
        op.cluster.create(TPUNodeClass("default"))
    if not kube_mode and not op.cluster.list(NodePool):
        op.cluster.create(NodePool("default"))

    stop = {"flag": False}

    def on_signal(signum, frame):
        stop["flag"] = True

    signal.signal(signal.SIGINT, on_signal)
    signal.signal(signal.SIGTERM, on_signal)

    recorder = None
    if args.sim_record:
        # capture hook at the cluster/cloud seam (sim subsystem): external
        # events become a replayable trace, dumped on exit
        from karpenter_tpu_torch.sim.trace import TraceRecorder

        recorder = TraceRecorder(
            op.cluster, op.clock, scenario="recorded", seed=args.seed
        ).attach(op.cloud if not kube_mode else None)

    ticks = 0
    op.watch_pods()   # pod arrivals wake the loop through the batch window
    try:
        while not stop["flag"]:
            swept = op.tick()
            if recorder is not None and swept:
                recorder.record_tick()
            if health is not None:
                # the LOOP beat proves the process turns (leader or standby:
                # liveness); the SWEEP beat only on a real sweep (readiness)
                health.beat_loop()
                if swept:
                    health.beat_sweep()
            ticks += 1
            if args.max_ticks and ticks >= args.max_ticks:
                break
            op.wait_for_work(args.tick_interval)
    except BaseException:
        # OperatorCrashed (and any other death) still propagates -- the
        # process must die loudly for the supervisor -- but the black
        # box's location goes to stderr first so the postmortem knows
        # where to start (Operator.tick already flushed it)
        from karpenter_tpu_torch.obs.flight import RECORDER as _flight

        if _flight.flushes:
            print(
                f"flight data: {_flight.dump()['last_flush_path']}",
                file=sys.stderr,
            )
        raise
    if op.watchdog is not None:
        op.watchdog.stop()
    if hasattr(op.solver, "stop_warm_up"):
        # let a capture or a warm call in flight end before the
        # interpreter tears CUDA down
        op.solver.stop_warm_up(timeout_s=60.0)
    if health is not None:
        health.stop()
    if recorder is not None:
        n = recorder.dump(args.sim_record)
        print(f"sim trace: {n} events -> {args.sim_record}", file=sys.stderr)

    if args.metrics_dump:
        from karpenter_tpu_torch import metrics

        print(metrics.REGISTRY.expose())
    if args.trace_dump:
        from karpenter_tpu_torch import tracing

        print(tracing.dump_json(indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
