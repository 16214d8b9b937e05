"""Scenario DSL: seeded, composable workload generators that compile to traces.

A scenario is a set of generator calls placed on one sim-time timeline;
`build()` quantizes the timeline into ticks and emits a flat JSONL-able
event list (every gap becomes `advance` events, so replay reproduces the
cadence exactly). All randomness flows from the scenario seed through one
numpy Generator, so a scenario name + seed IS the trace -- the committed
corpus under tests/golden/scenarios/ can always be regenerated with
`python -m karpenter_tpu_torch sim generate --all`.

Generators (composable; each returns self for chaining):

    poisson_arrivals   -- memoryless pod arrivals at a fixed rate
    diurnal            -- sinusoidal rate ramp (the day/night traffic shape)
    spread_burst       -- one burst of zone-topology-spread pods
    binpack_adversarial-- sizes just over half/third of common node shapes
                          (worst case for FFD-family packers)
    interruption_wave  -- a volley of spot-interruption messages
    ice_storm          -- exhaust capacity pools, then restore them
    price_shock        -- multiplicative price moves on named types
    pod_churn          -- delete a fraction of previously generated pods
    device_lost/
      device_returned  -- mesh device leaves/rejoins (topology epoch bump;
                          only the mesh backend reshards -- the degrade
                          ladder is decision-invisible by contract)

Chaos events (interruptions, kills) are scheduled into QUIET windows --
the generators leave a settle gap after arrivals -- because the pipelined
backend legally trails the synchronous ones by one tick while load is
sustained; firing chaos mid-burst would make victim picks diverge between
backends by construction, not by bug (sim/replay docstring).

Copy of karpenter_tpu/sim/scenario.py, imports rewritten to the port's;
it cuts nothing. It reads the port's catalog (`_cheap_types`), so
`sim generate --all` rebuilds tests/golden/scenarios/*.jsonl byte for
byte (tests/test_torch_scenario.py).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from karpenter_tpu_torch.apis.labels import ZONE_LABEL
from karpenter_tpu_torch.sim.trace import TRACE_VERSION

# (cpu, memory) pod shapes, small enough that scenarios pack several per node
SIZES: Tuple[Tuple[str, str], ...] = (
    ("250m", "512Mi"), ("500m", "1Gi"), ("1", "2Gi"), ("2", "4Gi"),
)


class ScenarioBuilder:
    def __init__(self, name: str, seed: int = 0, tick_seconds: float = 3.0):
        self.name = name
        self.seed = seed
        self.tick_seconds = tick_seconds
        self.rng = np.random.default_rng(seed)
        self._timed: List[Tuple[float, int, dict]] = []  # (t, seq, event)
        self._seq = 0
        self._pods: List[Tuple[float, str]] = []  # (arrival t, name)
        self._pod_i = 0
        # Operator Options overrides carried in the trace header; replay
        # whitelists the COUNT-based overload knobs (admission_max_pods,
        # launch_max_groups) -- see sim/trace.py
        self._options: Dict[str, float] = {}
        # differential backend set carried in the header (None = the
        # default trio). Scenarios whose MAIN phase consolidates restrict
        # to the synchronous backends: in-phase consolidation churn on
        # the pipelined backend legally picks different same-shaped
        # survivors (the drain-phase precedent in sim/replay.py), so
        # comparing its placements would flag a legal shift as a bug.
        self._backends: Optional[Tuple[str, ...]] = None

    # -- primitives ----------------------------------------------------------
    def at(self, t: float, event: dict) -> "ScenarioBuilder":
        self._timed.append((float(t), self._seq, event))
        self._seq += 1
        return self

    def _pod(self, t: float, cpu: str, mem: str, labels: Optional[Dict] = None,
             spread: Optional[List[dict]] = None) -> str:
        name = f"{self.name}-{self._pod_i}"
        self._pod_i += 1
        pod = {"name": name, "requests": {"cpu": cpu, "memory": mem}}
        if labels:
            pod["labels"] = dict(labels)
        if spread:
            pod["spread"] = spread
        self.at(t, {"ev": "pod_add", "pod": pod})
        self._pods.append((float(t), name))
        return name

    def _random_size(self) -> Tuple[str, str]:
        return SIZES[int(self.rng.integers(0, len(SIZES)))]

    def options(self, **kw) -> "ScenarioBuilder":
        """Operator Options overrides for the replay, carried in the
        trace header (whitelisted there to the overload knobs)."""
        self._options.update(kw)
        return self

    def backends(self, *names: str) -> "ScenarioBuilder":
        """Restrict this scenario's differential replay to the named
        backends (carried in the trace header; the corpus gate honors
        it). Use for scenarios whose main phase consolidates -- see the
        _backends comment above."""
        self._backends = tuple(names)
        return self

    # -- workload generators -------------------------------------------------
    def poisson_arrivals(self, start: float, duration: float, rate_per_s: float,
                         labels: Optional[Dict] = None) -> "ScenarioBuilder":
        n = int(self.rng.poisson(rate_per_s * duration))
        for t in sorted(self.rng.uniform(start, start + duration, n)):
            cpu, mem = self._random_size()
            self._pod(float(t), cpu, mem, labels)
        return self

    def diurnal(self, start: float, duration: float, base_rate: float,
                peak_rate: float, period: Optional[float] = None) -> "ScenarioBuilder":
        """Arrivals whose rate follows base + (peak-base) * sin^2(pi t/period):
        the classic day/night traffic shape, one full cycle by default.
        Implemented by thinning a Poisson stream at the peak rate."""
        period = period or duration
        n = int(self.rng.poisson(peak_rate * duration))
        times = np.sort(self.rng.uniform(start, start + duration, n))
        accept = self.rng.uniform(0.0, 1.0, n)
        for t, u in zip(times, accept):
            rate = base_rate + (peak_rate - base_rate) * float(
                np.sin(np.pi * (t - start) / period) ** 2
            )
            if u * peak_rate <= rate:
                cpu, mem = self._random_size()
                self._pod(float(t), cpu, mem)
        return self

    def spread_burst(self, t: float, n: int, app: Optional[str] = None,
                     max_skew: int = 1) -> "ScenarioBuilder":
        app = app or f"{self.name}-spread-{self._seq}"
        spread = [{
            "key": ZONE_LABEL, "max_skew": max_skew,
            "when_unsatisfiable": "DoNotSchedule", "selector": {"app": app},
        }]
        for _ in range(n):
            self._pod(t, "500m", "1Gi", labels={"app": app}, spread=spread)
        return self

    def binpack_adversarial(self, t: float, n: int) -> "ScenarioBuilder":
        """Pods sized just over 1/2 and 1/3 of the common node shapes, the
        classic adversarial input for first-fit-decreasing packers: a
        greedy mis-ordering strands near-half of every node."""
        shapes = (("1100m", "2200Mi"), ("700m", "1400Mi"), ("1700m", "3400Mi"))
        for i in range(n):
            cpu, mem = shapes[i % len(shapes)]
            self._pod(t, cpu, mem)
        return self

    def sustained_storm(self, start: float, duration: float, rate_per_s: float,
                        labels: Optional[Dict] = None) -> "ScenarioBuilder":
        """An arrival storm well past solver capacity -- the overload
        family's driver. Same memoryless shape as poisson_arrivals; a
        separate verb so scenarios read as what they model (the rate is
        expected to exceed what bounded admission will take per tick, so
        the pending set backs up and shedding engages)."""
        return self.poisson_arrivals(start, duration, rate_per_s, labels)

    def slow_sidecar(self, t: float, latency_s: float = 0.003,
                     times: int = 12) -> "ScenarioBuilder":
        """Arm wire latency at the sidecar dispatch site: each of the
        next `times` solves pays `latency_s` before replying -- the
        slow-sidecar half of the overload family. Wall-clock only: the
        decisions (and therefore the digests) are identical on every
        backend; what it exercises is the deadline budget's early-shed
        path under a degraded wire."""
        self.at(t, {
            "ev": "failpoint",
            "spec": f"rpc.server.dispatch=latency({latency_s}):times={times}",
        })
        return self

    # -- chaos generators ----------------------------------------------------
    def interruption_wave(self, t: float, count: int) -> "ScenarioBuilder":
        """`count` spot-interruption messages, victims picked by seeded
        rank into the ready fleet at apply time (trace.py `pick`)."""
        for _ in range(count):
            self.at(t, {"ev": "interruption", "pick": int(self.rng.integers(0, 1 << 16))})
        return self

    def node_kills(self, t: float, count: int) -> "ScenarioBuilder":
        for _ in range(count):
            self.at(t, {"ev": "kill_node", "pick": int(self.rng.integers(0, 1 << 16))})
        return self

    def operator_crash(self, t: float, site: str = "crash.launch") -> "ScenarioBuilder":
        """Arm a one-shot crash failpoint: the next tick that reaches
        `site` abandons the operator mid-flight and the replay engine
        restarts it over the surviving cluster/cloud state -- the
        crash-consistency drill (journal + recovery sweep + fencing)."""
        self.at(t, {"ev": "crash", "site": site})
        return self

    def operator_restart(self, t: float) -> "ScenarioBuilder":
        """Clean operator restart between ticks (kill -9 while idle):
        nothing mid-flight, but caches are cold, the lease must be
        re-won, and the recovery sweep runs on the win."""
        self.at(t, {"ev": "operator_restart"})
        return self

    def device_lost(self, t: float, device: int) -> "ScenarioBuilder":
        """Declare mesh device `device` lost at `t`: on the mesh backend
        the topology epoch bumps and the next solve reshards onto the
        survivors (2D layouts collapse a row first); every other backend
        takes the event as a decision-log line alone. The degrade ladder
        is decision-invisible by contract, so digests stay
        backend-identical -- which is exactly what the corpus pins.
        Schedule into QUIET windows like every other chaos verb."""
        self.at(t, {"ev": "device_lost", "device": int(device)})
        return self

    def device_returned(self, t: float, device: int) -> "ScenarioBuilder":
        """Device `device` comes back at `t`: the mesh backend
        re-promotes up the ladder (back to the full mesh -- and its warm
        jit cache -- once every device is healthy again)."""
        self.at(t, {"ev": "device_returned", "device": int(device)})
        return self

    def ice_storm(self, t: float, pools: List[Tuple[str, str, str]],
                  restore_at: Optional[float] = None,
                  restore_count: int = 1_000_000) -> "ScenarioBuilder":
        """Exhaust the named (instance_type, zone, capacity_type) pools at
        `t` -- launches ICE, the scheduler routes around them -- and
        restore at `restore_at` (unrestored pools risk non-convergence,
        which replay treats as an invariant violation)."""
        for itype, zone, ct in pools:
            self.at(t, {"ev": "ice", "instance_type": itype, "zone": zone,
                        "capacity_type": ct, "count": 0})
            if restore_at is not None:
                self.at(restore_at, {"ev": "ice", "instance_type": itype,
                                     "zone": zone, "capacity_type": ct,
                                     "count": restore_count})
        return self

    def price_shock(self, t: float, instance_types: List[str],
                    factor: float) -> "ScenarioBuilder":
        for itype in instance_types:
            self.at(t, {"ev": "price", "instance_type": itype, "factor": factor})
        return self

    def pod_churn(self, t: float, fraction: float) -> "ScenarioBuilder":
        """Delete a seeded fraction of the pods that ARRIVE before `t`
        (a delete sorting ahead of its pod's arrival would no-op at
        replay): the workload-shrinks-behind-us shape consolidation
        feeds on."""
        candidates = [(at, name) for at, name in self._pods if at < t]
        n = int(len(candidates) * fraction)
        if not n:
            return self
        idx = self.rng.choice(len(candidates), size=n, replace=False)
        for i in sorted(int(j) for j in idx):
            self.at(t, {"ev": "pod_delete", "name": candidates[i][1]})
            self._pods.remove(candidates[i])
        return self

    # -- compilation ---------------------------------------------------------
    def build(self) -> List[dict]:
        """Quantize the timeline into ticks: events land in the tick bucket
        covering their timestamp, each bucket is followed by one `advance`
        of the tick interval. Event order inside a bucket is (t, insertion
        seq) -- fully deterministic."""
        events: List[dict] = [{
            "ev": "header", "version": TRACE_VERSION, "scenario": self.name,
            "seed": self.seed, "tick_seconds": self.tick_seconds,
            **({"options": dict(self._options)} if self._options else {}),
            **({"backends": list(self._backends)} if self._backends else {}),
        }]
        if not self._timed:
            return events
        timed = sorted(self._timed, key=lambda x: (x[0], x[1]))
        horizon = timed[-1][0]
        n_ticks = int(horizon // self.tick_seconds) + 1
        i = 0
        for k in range(n_ticks):
            boundary = (k + 1) * self.tick_seconds
            while i < len(timed) and timed[i][0] < boundary:
                events.append(timed[i][2])
                i += 1
            events.append({"ev": "advance", "dt": self.tick_seconds})
        return events


# -- the standard corpus -----------------------------------------------------

def _cheap_types(n: int = 3) -> List[str]:
    """The n cheapest on-demand types in the static catalog -- the pools
    the lowest-price strategy hits first, so exhausting them actually
    bites. Deterministic: the catalog pipeline is."""
    from karpenter_tpu_torch.providers.instancetype import gen_catalog

    types = gen_catalog.generate_instance_types()
    ranked = sorted(types, key=lambda t: (gen_catalog.on_demand_price(t), t.name))
    return [t.name for t in ranked[:n]]


def _scenario_diurnal_small(seed: int) -> ScenarioBuilder:
    return ScenarioBuilder("diurnal-small", seed).diurnal(
        start=0.0, duration=60.0, base_rate=0.1, peak_rate=0.8)


def _scenario_diurnal_medium(seed: int) -> ScenarioBuilder:
    b = ScenarioBuilder("diurnal-medium", seed)
    b.diurnal(start=0.0, duration=240.0, base_rate=0.3, peak_rate=3.0)
    b.pod_churn(t=300.0, fraction=0.3)
    return b


def _scenario_ice_storm(seed: int) -> ScenarioBuilder:
    b = ScenarioBuilder("ice-storm", seed)
    pools = []
    for itype in _cheap_types(2):
        for zone in ("us-central-1a", "us-central-1b", "us-central-1c",
                     "us-central-1d"):
            pools.append((itype, zone, "spot"))
            pools.append((itype, zone, "on-demand"))
    # storm FIRST, then the burst arrives into the outage; restore later
    b.ice_storm(t=1.0, pools=pools, restore_at=45.0)
    b.poisson_arrivals(start=3.0, duration=15.0, rate_per_s=1.0)
    return b


def _scenario_interruption_wave(seed: int) -> ScenarioBuilder:
    b = ScenarioBuilder("interruption-wave", seed)
    b.poisson_arrivals(start=0.0, duration=20.0, rate_per_s=0.8)
    # quiet window (fleet settled, pipeline drained) before the wave
    b.interruption_wave(t=60.0, count=3)
    return b


def _scenario_spread_burst(seed: int) -> ScenarioBuilder:
    b = ScenarioBuilder("spread-burst", seed)
    b.spread_burst(t=1.0, n=9, app="web")
    b.spread_burst(t=20.0, n=6, app="api")
    return b


def _scenario_binpack_adversarial(seed: int) -> ScenarioBuilder:
    b = ScenarioBuilder("binpack-adversarial", seed)
    b.binpack_adversarial(t=1.0, n=18)
    b.price_shock(t=40.0, instance_types=_cheap_types(1), factor=3.0)
    return b


def _scenario_binpack_adversarial_convex(seed: int) -> ScenarioBuilder:
    """Convex-tier family: a pure adversarial bin-packing burst, the
    input first-fit-decreasing handles WORST (pods just over 1/2 and 1/3
    of the common node shapes strand near-half of every node). The
    corpus gate replays this trace through the `convex` backend (LP
    relaxation + deterministic rounding beside every FFD solve) and
    asserts cost DOMINANCE over the committed host golden -- convex
    fleet $/pod-hour strictly below FFD's, optimality gap never worse --
    plus byte-determinism of the convex decision digest. Host-only in
    the differential (the point is the two TIERS diverging, not the
    transports agreeing; the standard trio rides the other scenarios)."""
    b = ScenarioBuilder("binpack-adversarial-convex", seed)
    b.binpack_adversarial(t=1.0, n=30)
    b.backends("host")
    return b


def _scenario_crash_restart(seed: int) -> ScenarioBuilder:
    """Crash-consistency drill: a burst arrives, the operator dies
    mid-launch (open intents + uncommitted instances left behind), a
    fresh one takes the lease, recovers, and serves a second burst; a
    clean restart then lands mid-drain of an interruption. Exercised by
    the crash soak (tests/test_crash_chaos.py), not the differential
    corpus -- a crash's dead-standby ticks legally shift decisions."""
    b = ScenarioBuilder("crash-restart", seed)
    b.poisson_arrivals(start=0.0, duration=10.0, rate_per_s=0.8)
    b.operator_crash(t=11.0, site="crash.launch")
    b.poisson_arrivals(start=40.0, duration=8.0, rate_per_s=0.6)
    b.interruption_wave(t=80.0, count=1)
    b.operator_restart(t=85.0)
    return b


def _scenario_diurnal_consolidation(seed: int) -> ScenarioBuilder:
    """Consolidation family: a diurnal ramp-down that leaves the fleet
    underutilized. The day's peak builds nodes; the churn at the start of
    the trough strands their survivors across too many of them; the quiet
    tail (plus the drain) is where the batched consolidation engine must
    fold the fleet back down. The differential corpus pins host == wire
    == pipelined decision digests THROUGH the consolidation decisions
    (every disrupted claim and replaced node is a decision-log line), and
    tests/test_sim.py asserts the KPI shape: the hourly fleet price at
    convergence sits below the peak, i.e. cost_per_pod_hour actually
    drops in the trough instead of paying for the day's peak forever."""
    b = ScenarioBuilder("diurnal-consolidation", seed)
    b.diurnal(start=0.0, duration=90.0, base_rate=0.2, peak_rate=2.2)
    # ramp-down into the trough: most of the peak's pods leave, their
    # nodes stay -- the workload-shrinks-behind-us shape
    b.pod_churn(t=120.0, fraction=0.55)
    # a trough trickle keeps the fleet serving...
    b.poisson_arrivals(start=150.0, duration=9.0, rate_per_s=0.2)
    # ...and a DECISION-FREE timeline extension (a no-op price event)
    # carries the quiet trough past MIN_NODE_LIFETIME for the day's
    # nodes (5 min), so the consolidation age gate opens IN the trough
    # and the fold-down is part of the pinned decision digest, not just
    # drain-phase cleanup. An arrival here instead would overlap the
    # consolidation window, where the pipelined tick's legal one-tick
    # bind shift can change WHICH same-shaped node a pod lands on --
    # chaos-in-quiet-windows discipline (module docstring) applies to
    # consolidation exactly like it applies to kills.
    b.price_shock(t=450.0, instance_types=_cheap_types(1), factor=1.0)
    # synchronous backends only (plus the corpus's delta gate, which
    # replays this trace): in-phase consolidation on the pipelined
    # backend legally shifts WHICH same-shaped node survives, exactly
    # like drain-phase churn -- invariants still hold there, but
    # placement equality is a sync-backend contract for this family
    b.backends("host", "wire")
    return b


def _scenario_overload_storm(seed: int) -> ScenarioBuilder:
    """Overload family: a sustained arrival storm well past what bounded
    admission takes per tick, plus a slow-sidecar latency window. The
    admission cap rides the trace header's options, so every backend
    sheds the SAME deterministic priority/age prefix each tick -- the
    committed golden digest pins that shed pods are re-admitted and
    placed once the storm subsides, bit-identically across backends."""
    b = ScenarioBuilder("overload-storm", seed)
    b.options(admission_max_pods=12)
    b.sustained_storm(start=0.0, duration=18.0, rate_per_s=4.0)
    b.slow_sidecar(t=6.0, latency_s=0.003, times=12)
    return b


def _scenario_multi_cluster_storm(seed: int) -> ScenarioBuilder:
    """Fleet family: ONE cluster's slice of a multi-cluster arrival storm.
    The fleet replay (sim/fleet.py) derives N tenant variants of this
    scenario (per-tenant seeds -> staggered storm starts and distinct pod
    mixes) and drives them through ONE coalescing solver sidecar; each
    tenant's digest is pinned per seed in multi-cluster-storm.digests.json
    and must equal its isolated single-sidecar replay bit-for-bit
    (multi-tenant == isolated). The base trace also rides the standard
    corpus differential (host == wire == pipelined) like every scenario."""
    b = ScenarioBuilder("multi-cluster-storm", seed)
    # synchronous duo, like diurnal-consolidation: a storm's per-tick
    # batch composition legitimately shifts under the pipelined tick's
    # one-tick decision lag, so pod->group placements differ while both
    # stay individually correct; the pipelined path keeps its corpus
    # coverage via the other scenarios, and THIS scenario's job is the
    # host == wire golden plus the multi-tenant fleet gate.
    b.backends("host", "wire")
    stagger = float(seed % 5) * 1.5
    b.sustained_storm(start=stagger, duration=9.0, rate_per_s=2.5)
    b.poisson_arrivals(start=stagger + 12.0, duration=6.0, rate_per_s=1.0)
    b.pod_churn(t=stagger + 21.0, fraction=0.3)
    return b


def _scenario_mesh_device_loss(seed: int) -> ScenarioBuilder:
    """Mesh fault-tolerance family: the fleet serves a burst, loses the
    highest-index mesh device in a quiet window (reshard onto seven
    survivors; 2D layouts collapse a row), serves on the shrunk mesh,
    loses a SECOND device (deeper down the ladder), then both return and
    the full mesh is re-promoted for the final burst. The differential
    corpus pins host == wire == pipelined THROUGH the loss events (every
    backend logs them; only the mesh backend reshards), and the corpus's
    device-loss mesh gate replays this trace through the mesh backend --
    its digest must equal the committed host golden bit-for-bit, i.e.
    the whole degrade ladder is decision-invisible."""
    b = ScenarioBuilder("mesh-device-loss", seed)
    b.poisson_arrivals(start=0.0, duration=12.0, rate_per_s=0.8)
    # quiet window (fleet settled, pipeline drained) before each
    # topology transition -- chaos-in-quiet-windows discipline
    b.device_lost(t=30.0, device=7)
    b.poisson_arrivals(start=36.0, duration=9.0, rate_per_s=0.6)
    b.device_lost(t=60.0, device=3)
    b.poisson_arrivals(start=66.0, duration=6.0, rate_per_s=0.5)
    b.device_returned(t=90.0, device=3)
    b.device_returned(t=90.0, device=7)
    b.poisson_arrivals(start=96.0, duration=9.0, rate_per_s=0.6)
    return b


STANDARD_SCENARIOS = {
    "diurnal-small": _scenario_diurnal_small,
    "diurnal-medium": _scenario_diurnal_medium,
    "diurnal-consolidation": _scenario_diurnal_consolidation,
    "ice-storm": _scenario_ice_storm,
    "interruption-wave": _scenario_interruption_wave,
    "spread-burst": _scenario_spread_burst,
    "binpack-adversarial": _scenario_binpack_adversarial,
    "binpack-adversarial-convex": _scenario_binpack_adversarial_convex,
    "crash-restart": _scenario_crash_restart,
    "overload-storm": _scenario_overload_storm,
    "multi-cluster-storm": _scenario_multi_cluster_storm,
    "mesh-device-loss": _scenario_mesh_device_loss,
}

# the committed corpus (tests/golden/scenarios/): small, fast, and one per
# chaos family; diurnal-medium stays generate-on-demand (bench's stage)
CORPUS_SCENARIOS = (
    "diurnal-small", "diurnal-consolidation", "ice-storm",
    "interruption-wave", "overload-storm", "multi-cluster-storm",
    "mesh-device-loss", "binpack-adversarial-convex",
)
DEFAULT_SEED = 20260803


def build_scenario(name: str, seed: int = DEFAULT_SEED) -> List[dict]:
    if name not in STANDARD_SCENARIOS:
        raise KeyError(
            f"unknown scenario {name!r} (have {sorted(STANDARD_SCENARIOS)})")
    return STANDARD_SCENARIOS[name](seed).build()
