"""The port's merged route of two weighted NodePools against the
benchmark's plain reference (benchmark/reference/ffd.py: NumPy, nothing of
the program or of JAX), on the CPU.

The deployment is `spot-od-50k` cut to a test size
(benchmark/tests/data/spot-od-small.json: spot at weight 100 over
on-demand at 10, each with its daemonset reserve), under the burst mix
(8 batches of 5,000 pods on an empty cluster) and the small wave
(benchmark/tests/data/wave-small.json: 600-pod waves against the nodes of
a 3,000-pod tick, in both pools). Every call of a seed is decided by
`TorchSolver(device="cpu").schedule()` through the harness's own `Provision` class
and compared with the reference's decision: pods on standing nodes, each
new node's position, NodePool, types, pods, zones and capacity types,
pods placed once, and the fleet's price. Every number must be 0, and
every call must take the merged route.
"""
import json
import sys
from pathlib import Path

import pytest
import torch

# the harness imports its modules by their short names, as benchmark/run.py
# does; appended, so that nothing earlier on the path is shadowed
BENCH = Path(__file__).resolve().parents[1] / "benchmark"
if str(BENCH) not in sys.path:
    sys.path.append(str(BENCH))

import harness  # noqa: E402
from gen import traffic  # noqa: E402

# small tensors: one intra-op thread per test worker (several workers share the cores)
torch.set_num_threads(1)

CONFIG = json.loads((BENCH / "tests" / "data" / "spot-od-small.json").read_text())
MIXES = {"burst": BENCH / "traffic" / "burst.json",
         "wave": BENCH / "tests" / "data" / "wave-small.json"}


@pytest.mark.parametrize("seed", [2**31 + 41, 3_700_000_013])
@pytest.mark.parametrize("mix", sorted(MIXES))
def test_merged_route_equals_the_plain_reference(mix, seed):
    inputs = traffic.build(traffic.load_mix(str(MIXES[mix])), CONFIG, seed)
    cell = harness.Provision(inputs, CONFIG, "cpu")
    existing = 0
    for i in range(cell.n_calls):
        got = cell.plain(cell.call(i)())
        want = cell.reference(i)
        assert cell.compare(got, want, i) == {
            "existing_differ": 0.0, "nodes_differ": 0.0, "pods_not_once": 0.0, "price_gap": 0.0}
        assert set(got["pools"]) == {"spot", "on-demand"}
        existing += len(got["existing"])
    assert cell.routes == {"merged": cell.n_calls}
    # the wave's pre-pass places pods on standing nodes; the burst has none
    assert (existing > 0) == (mix == "wave")
