"""Trace shrinker: delta-debugging over the event list.

Given a trace whose replay fails -- a differential divergence or an
invariant violation -- `shrink` minimizes the event list to a 1-minimal
repro (removing any single remaining chunk makes the failure disappear)
via Zeller's ddmin, then writes it to the repro corpus. Each predicate
probe is a full replay (or a full differential replay), so the cost is
O(rounds x replays); scenario-scale traces shrink in seconds-to-minutes.

Structural rules the reducer respects:

- the header line is pinned (never removed, never counted);
- `advance` events are fair game -- many failures are TIMING failures,
  and dropping ticks is how the reducer proves it;
- no other dependency bookkeeping: replay is total (a pod_delete for an
  unknown pod, a pick into an empty fleet, an ICE for an absent pool are
  all well-defined no-ops), which is precisely what makes naive ddmin
  sound here.

Copy of karpenter_tpu/sim/shrink.py, imports rewritten to the port's. Its
predicates replay through the port's `replay` / `differential`, whose
engines run on `device` (None, the default, is the card; "cpu" runs the
kernels' plain versions).
"""
from __future__ import annotations

import json
import os
from typing import Callable, List, Optional

Predicate = Callable[[List[dict]], bool]  # True = still failing


def ddmin(events: List[dict], failing: Predicate,
          max_probes: int = 2_000) -> List[dict]:
    """Zeller's ddmin over `events` (header excluded and re-attached).
    `failing(candidate)` must return True when the candidate trace still
    reproduces the failure. Returns a 1-minimal failing subsequence."""
    from karpenter_tpu_torch import metrics

    header = [e for e in events if e.get("ev") == "header"][:1]
    body = [e for e in events if e.get("ev") != "header"]

    def probe(candidate: List[dict]) -> bool:
        metrics.SIM_SHRINK_ROUNDS.inc()
        return failing(header + candidate)

    probes = 0
    n = 2
    while len(body) >= 2 and probes < max_probes:
        chunk = max(1, len(body) // n)
        reduced = False
        for start in range(0, len(body), chunk):
            complement = body[:start] + body[start + chunk:]
            if not complement:
                continue
            probes += 1
            if probe(complement):
                body = complement
                n = max(2, n - 1)
                reduced = True
                break
            if probes >= max_probes:
                break
        if not reduced:
            if n >= len(body):
                break
            n = min(len(body), 2 * n)
    return header + body


def differential_failing(seed: int, backends=None, device=None) -> Predicate:
    """Predicate for `ddmin`: the trace still produces a differential
    divergence (or an invariant violation on any backend)."""
    from karpenter_tpu_torch.sim.replay import BACKENDS, differential

    backends = tuple(backends or BACKENDS)

    def failing(events: List[dict]) -> bool:
        try:
            return not differential(events, seed=seed, backends=backends,
                                    device=device).ok
        except Exception:  # noqa: BLE001 -- a crash still reproduces "bad"
            return True

    return failing


def invariant_failing(backend: str, seed: int, device=None) -> Predicate:
    """Predicate for `ddmin`: single-backend replay still violates an
    invariant (no pod lost / double launch / convergence / fit)."""
    from karpenter_tpu_torch.sim.replay import InvariantViolation, replay

    def failing(events: List[dict]) -> bool:
        try:
            replay(events, backend=backend, seed=seed, device=device)
            return False
        except InvariantViolation:
            return True
        except Exception:  # noqa: BLE001
            return True

    return failing


def shrink_to_repro(events: List[dict], failing: Predicate, out_dir: str,
                    name: str, max_probes: int = 2_000) -> Optional[str]:
    """Minimize and write `<out_dir>/<name>-shrunk.jsonl`; returns the
    path, or None when the input does not fail at all (nothing to shrink
    -- the caller's failure was not reproducible, which is itself worth
    surfacing loudly rather than writing an empty repro)."""
    from karpenter_tpu_torch.sim.trace import write_trace

    if not failing(events):
        return None
    reduced = ddmin(events, failing, max_probes=max_probes)
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{name}-shrunk.jsonl")
    write_trace(path, reduced)
    meta = {
        "original_events": len(events),
        "shrunk_events": len(reduced),
    }
    with open(os.path.join(out_dir, f"{name}-shrunk.meta.json"), "w") as f:
        json.dump(meta, f, indent=2, sort_keys=True)
    return path
