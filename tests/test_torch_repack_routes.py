"""Which kernel B entry each route calls, counted on the CPU.

The consolidation sweep reads only the repack's [S, C] leftovers, so every
sweep route -- the engine's local route, its mesh route, the sidecar's
`solve_disrupt` op and the mesh sidecar's `MeshSolveEngine.repack_leftover`
-- calls `disrupt_repack_leftover` and never the full entry, whose plain
version stacks the [S, C, N] takes (and whose kernel writes them). The
provisioning pre-pass keeps the full entry: it reads the takes. Each
entry and each plain version is wrapped in a counter, as `chip_smoke.py`
counts the wrappers' launches on the card.
"""
import os
import shutil
import tempfile

import numpy as np
import pytest
import torch

from karpenter_tpu_torch import workload
from karpenter_tpu_torch.apis import NodePool
from karpenter_tpu_torch.parallel import mesh as tmesh
from karpenter_tpu_torch.solver import rpc
from karpenter_tpu_torch.solver.disrupt import DisruptEngine
from karpenter_tpu_torch.solver.kernels import disrupt_repack as tk
from karpenter_tpu_torch.solver.service import TorchSolver

torch.set_num_threads(1)

G = 128
SHARDS = 4
COUNTED = ("disrupt_repack", "disrupt_repack_leftover", "repack_reference",
           "repack_leftover_reference")


@pytest.fixture(scope="module")
def items():
    return workload.build_catalog_items()


@pytest.fixture(scope="module")
def sweep(items):
    """A ramp-down sweep over a 1,500-pod tick: nodes, sets, pools."""
    pods = workload.synth_pods(np.random.default_rng(5), workload.ZONES, 1_500, 5, 40)
    tick = TorchSolver(device="cpu", g_max=G).solve(NodePool("default"), items, pods)
    spec = workload.rampdown_sweep_spec(tick, np.random.default_rng(11), n_cand=8)
    nodes, sets = workload.sweep_world(spec)
    pools, ovh = workload.sweep_pools("spot-od")
    kw = dict(pools=pools, catalogs={p.name: items for p in pools}, daemon_overhead=ovh)
    return tick, nodes, sets, kw


@pytest.fixture
def calls(monkeypatch):
    """name -> calls of kernel B's entries and plain versions in the test."""
    out = {name: 0 for name in COUNTED}
    for name in COUNTED:
        fn = getattr(tk, name)

        def counted(*a, _fn=fn, _name=name, **k):
            out[_name] += 1
            return _fn(*a, **k)

        monkeypatch.setattr(tk, name, counted)
    return out


@pytest.fixture
def sidecar():
    """start(**kw) -> a path to a SolverServer on the CPU, stopped at
    teardown."""
    d = tempfile.mkdtemp(prefix="kt-")
    started = []

    def start(**kw):
        path = os.path.join(d, f"s{len(started)}.sock")
        started.append(rpc.SolverServer(path=path, device="cpu", **kw).start())
        return path

    yield start
    for srv in started:
        srv.stop()
        srv._thread.join(timeout=30)
    shutil.rmtree(d, ignore_errors=True)


def evaluate(engine, sweep):
    _, nodes, sets, kw = sweep
    return [repr(v) for v in engine.evaluate(nodes, sets, **kw)]


def assert_leftover_only(calls, launches):
    assert calls["disrupt_repack_leftover"] == launches
    assert calls["repack_leftover_reference"] == launches
    assert calls["disrupt_repack"] == calls["repack_reference"] == 0


class TestSweepRoutes:
    def test_local_route(self, sweep, calls):
        engine = DisruptEngine(device="cpu")
        evaluate(engine, sweep)
        assert engine.last_dispatch["path"] == "local"
        assert_leftover_only(calls, 1)

    def test_mesh_route(self, sweep, calls):
        want = evaluate(DisruptEngine(device="cpu"), sweep)
        for k in calls:
            calls[k] = 0
        mesh = tmesh.make_mesh(SHARDS, devices=[torch.device("cpu")] * SHARDS)
        assert evaluate(DisruptEngine(device="cpu", mesh=mesh), sweep) == want
        assert_leftover_only(calls, SHARDS)

    @pytest.mark.parametrize("meshed", [False, True], ids=["sidecar", "mesh sidecar"])
    def test_wire_route(self, sweep, calls, sidecar, meshed):
        """The sidecar's `solve_disrupt` op; with a mesh it runs through
        `MeshSolveEngine.repack_leftover`, once a shard."""
        want = evaluate(DisruptEngine(device="cpu"), sweep)
        for k in calls:
            calls[k] = 0
        mesh = tmesh.make_mesh(SHARDS, devices=[torch.device("cpu")] * SHARDS) if meshed else None
        path = sidecar(mesh=mesh)
        client = rpc.SolverClient(path=path, timeout=60.0, connect_timeout=5.0)
        try:
            solver = TorchSolver(device="cpu", g_max=G, client=client, breaker=False)
            engine = DisruptEngine(solver=solver)
            assert evaluate(engine, sweep) == want
            assert engine.last_dispatch["path"] == "wire"
        finally:
            client.close()
        assert_leftover_only(calls, SHARDS if meshed else 1)


class TestPrePass:
    def test_pre_pass_keeps_the_full_entry(self, sweep, items, calls):
        """The provisioning solve's pack onto existing nodes reads the takes."""
        tick = sweep[0]
        pods = workload.synth_pods(np.random.default_rng(6), workload.ZONES, 300, 6, 40)
        TorchSolver(device="cpu", g_max=G).solve(
            NodePool("default"), items, pods, existing_nodes=workload.nodes_from_result(tick))
        assert calls["disrupt_repack"] == calls["repack_reference"] >= 1
        assert calls["disrupt_repack_leftover"] == calls["repack_leftover_reference"] == 0
