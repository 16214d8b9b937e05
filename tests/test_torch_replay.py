"""The golden sim corpus replayed through the port's own operator, on the CPU.

`karpenter_tpu_torch.sim.replay.replay(events, backend, seed,
device="cpu")` builds the port's whole stack -- its Operator, kwok
cluster and cloud, controllers, `TorchSolver` and `DisruptEngine`, and
for the wire backends the port's `SolverServer`, `SolverClient` and
`CircuitBreaker` -- and hashes every tick's decisions. Each digest must
equal `tests/golden/scenarios/digests.json` exactly: the 8 host digests
and `convex:binpack-adversarial-convex`, and the host digest again on
the `wire`, `delta`, `tcp` and `packed` backends (host == wire, as in
the JAX corpus gate; the port's `packed` backend is its host path).
Nothing of the JAX package runs here: this is the port's replay, not the
adapter replay of tests/test_torch_sim.py.

`diurnal-small` and `diurnal-consolidation` run in tier-1 on `host` and
`wire`; everything else is marked `slow`.
"""
import json
import os

import pytest
import torch

from karpenter_tpu_torch import metrics
from karpenter_tpu_torch.sim.replay import differential as port_differential
from karpenter_tpu_torch.sim.replay import replay as port_replay
from karpenter_tpu_torch.sim.trace import read_trace

# small tensors: one intra-op thread per test worker (several workers share the cores)
torch.set_num_threads(1)

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden", "scenarios")
with open(os.path.join(GOLDEN_DIR, "digests.json")) as _f:
    GOLDEN = json.load(_f)
TIER1 = ("diurnal-small", "diurnal-consolidation")


def load(name):
    events = read_trace(os.path.join(GOLDEN_DIR, f"{name}.jsonl"))
    seed = next((int(ev["seed"]) for ev in events if ev.get("ev") == "header" and "seed" in ev), 0)
    return events, seed


def dispatches(entry):
    return metrics.SOLVER_KERNEL_DISPATCHES.value(entry=entry, impl="plain")


def engine_repacks():
    # the consolidation engine's kernel B runs: one per local evaluate
    return metrics.DISRUPTION_DEVICE_DISPATCHES.value(path="local")


def replay(name, backend):
    events, seed = load(name)
    return port_replay(events, backend=backend, seed=seed, device="cpu")


HOST = [pytest.param(k, marks=() if k in TIER1 else pytest.mark.slow) for k in sorted(GOLDEN)]


@pytest.mark.parametrize("key", HOST)
def test_golden_digest(key):
    backend, _, name = key.rpartition(":")
    scans, repacks = dispatches("ffd_solve_fused"), engine_repacks()
    res = replay(name, backend or "host")
    assert res.digest == GOLDEN[key], f"{key}: the port's replay drifted from the golden digest"
    # the port's device path ran: kernel A's plain version on every such tick
    assert dispatches("ffd_solve_fused") > scans
    if name == "diurnal-consolidation":
        # the disruption sweep judged candidate sets with kernel B's plain version
        assert engine_repacks() > repacks


WIRE = [pytest.param(b, n, marks=() if (b == "wire" and n in TIER1) else pytest.mark.slow)
        for b in ("wire", "delta", "tcp", "packed") for n in TIER1]


@pytest.mark.parametrize("backend,name", WIRE)
def test_backend_digest_equals_host_golden(backend, name):
    served = sum(metrics.WIRE_BYTES.value(direction="received", transport=t) for t in ("shm", "tcp"))
    fallbacks = metrics.SOLVER_PIPELINE_FALLBACKS.value(reason="rpc-down")
    res = replay(name, backend)
    assert res.digest == GOLDEN[name], f"{backend}:{name} drifted from the host golden digest"
    if backend != "packed":
        # every tick went over the port's own sidecar
        assert sum(metrics.WIRE_BYTES.value(direction="received", transport=t)
                   for t in ("shm", "tcp")) > served
        assert metrics.SOLVER_PIPELINE_FALLBACKS.value(reason="rpc-down") == fallbacks


@pytest.mark.slow
def test_pipelined_placements_equal_host():
    """The pipelined tick may decide a tick later; its placements at
    convergence equal the host backend's (the JAX differential)."""
    events, seed = load("diurnal-small")
    res = port_differential(events, seed=seed, backends=("host", "pipelined"), device="cpu")
    assert res.ok, res.divergences


def test_mesh_backend_waits():
    with pytest.raises(NotImplementedError, match="A11"):
        replay("diurnal-small", "mesh")


def test_replay_without_a_card_raises(monkeypatch):
    """The default device is the card: no fallback to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    events, seed = load("diurnal-small")
    with pytest.raises(RuntimeError, match="CUDA"):
        port_replay(events, backend="host", seed=seed)
