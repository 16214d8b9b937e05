"""Deterministic scenario simulation & trace replay.

The subsystem that lets every solver/policy change be judged against a
committed scenario corpus instead of vibes (the role CvxCluster's replayed
cluster snapshots and KubePACS's interruption traces play for those
systems -- PAPERS.md): an event-sourced trace format drives the REAL
operator stack (provisioner -> solver -> bind -> disruption -> termination)
under FakeClock, so a live incident, a chaos run, or a synthetic workload
all replay bit-identically.

Four parts:

- `trace`: the JSONL event vocabulary (pod arrival/delete, node kills,
  interruption messages, ICE/pricing mutations, clock advances) plus the
  capture hook at the kwok-cluster/cloud seam (`TraceRecorder`;
  `python -m karpenter_tpu_torch --sim-record out.jsonl` dumps a live run).
- `scenario`: seeded, composable workload generators (Poisson arrivals,
  diurnal ramp, spread bursts, interruption waves, ICE storms,
  binpack-adversarial mixes) that compile to traces.
- `replay`: the replay engine -- applies a trace to a freshly built
  operator on one of three backends (host-FFD in-process, wire sidecar,
  pipelined wire), logging one canonical decision line per tick, checking
  the chaos invariants every tick, and emitting fleet KPIs. Differential
  mode replays the same trace across backends and asserts bit-identical
  placements.
- `shrink`: delta-debugging over the event list -- minimizes any
  diverging or invariant-violating trace to a small repro for the corpus.

Determinism rests on the seed discipline in `Operator(Options(seed=...))`:
object-name generation, failpoint schedules, trace sampling, and breaker
backoff jitter all derive from the one seed, so two replays of the same
trace produce byte-identical decision logs (tests/test_sim.py).

Copy of karpenter_tpu/sim/__init__.py, imports rewritten to the port's.
The fleet replay (`fleet`, and the CLI's `corpus` and `fleet` verbs)
waits for A11 (ROADMAP).
"""
from karpenter_tpu_torch.sim.trace import (
    TRACE_VERSION,
    TraceRecorder,
    read_trace,
    write_trace,
)
from karpenter_tpu_torch.sim.replay import (
    BACKENDS,
    DifferentialDivergence,
    InvariantViolation,
    ReplayResult,
    differential,
    replay,
)
from karpenter_tpu_torch.sim.scenario import STANDARD_SCENARIOS, ScenarioBuilder, build_scenario
from karpenter_tpu_torch.sim.shrink import ddmin

__all__ = [
    "TRACE_VERSION",
    "TraceRecorder",
    "read_trace",
    "write_trace",
    "BACKENDS",
    "DifferentialDivergence",
    "InvariantViolation",
    "ReplayResult",
    "differential",
    "replay",
    "STANDARD_SCENARIOS",
    "ScenarioBuilder",
    "build_scenario",
    "ddmin",
]
