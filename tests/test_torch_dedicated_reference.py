"""The port's merged route of three weighted NodePools, the first of them
tainted, against the benchmark's plain reference
(benchmark/reference/ffd.py: NumPy, nothing of the program or of JAX), on
the CPU.

The deployment is `dedicated-spot-od-50k` cut to a test size
(benchmark/tests/data/dedicated-spot-od-small.json: a `dedicated` pool at
weight 100 with no capacity type, tainted dedicated=batch:NoSchedule,
over spot at 50 and on-demand at 10, each with its daemonset reserve),
under the burst mix (8 batches of 5,000 pods on an empty cluster). Every
call of a seed is decided by `TorchSolver(device="cpu").schedule()`
through the harness's own `Provision` class and compared with the
reference's decision: each new node's position, NodePool, types, pods,
zones and capacity types, pods placed once, and the fleet's price. Every
number must be 0, every call must take the merged route, and each of
the three pools must open nodes over a seed's calls. With the taint gate
(`multipool.join_allowed_mask`) replaced by one that gates nothing, the
check must see nodes differ.
"""
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

# the harness imports its modules by their short names, as benchmark/run.py
# does; appended, so that nothing earlier on the path is shadowed
BENCH = Path(__file__).resolve().parents[1] / "benchmark"
if str(BENCH) not in sys.path:
    sys.path.append(str(BENCH))

import harness  # noqa: E402
from gen import traffic  # noqa: E402

from karpenter_tpu_torch.solver import multipool  # noqa: E402

# small tensors: one intra-op thread per test worker (several workers share the cores)
torch.set_num_threads(1)

CONFIG = json.loads((BENCH / "tests" / "data" / "dedicated-spot-od-small.json").read_text())
BURST = traffic.load_mix(str(BENCH / "traffic" / "burst.json"))
ZERO = {"existing_differ": 0.0, "nodes_differ": 0.0, "pods_not_once": 0.0, "price_gap": 0.0}


def readings(seed):
    """Each call's check numbers and its new nodes' pools, and the routes taken."""
    cell = harness.Provision(traffic.build(BURST, CONFIG, seed), CONFIG, "cpu")
    out = []
    for i in range(cell.n_calls):
        got = cell.plain(cell.call(i)())
        out.append((cell.compare(got, cell.reference(i), i), got["pools"]))
    return out, cell.routes


@pytest.mark.parametrize("seed", [2**31 + 43, 3_700_000_019])
def test_tainted_merged_route_equals_the_plain_reference(seed):
    calls, routes = readings(seed)
    assert [numbers for numbers, _ in calls] == [ZERO] * len(calls)
    assert routes == {"merged": len(calls)}
    opened = {pool for _, pools in calls for pool in pools}
    assert opened == {"dedicated", "spot", "on-demand"}


def test_the_check_sees_the_taint_gate(monkeypatch):
    """A gate that lets every class use every column puts intolerant pods
    on dedicated nodes: the reference's nodes differ."""
    def ungated(classes, pools, col_pools, c_pad, k_pad):
        return np.ones((c_pad, k_pad), dtype=bool)

    monkeypatch.setattr(multipool, "join_allowed_mask", ungated)
    calls, routes = readings(2**31 + 43)
    assert routes == {"merged": len(calls)}
    assert max(numbers["nodes_differ"] for numbers, _ in calls) > 0
