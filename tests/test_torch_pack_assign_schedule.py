"""Kernel B's pre-pass inside whole `schedule()` calls: a small standing
cluster under one NodePool and under the weighted spot + on-demand pair,
built alike in both packages (tests/test_torch_oracle.py `fuzz_spec`).
The port's `existing_assignments`, in insertion order, equal the JAX
package's `TPUSolver`; the traced tick's `pack_assign` span says how many
(class, node) pairs its walk visited and how many pods it placed.
Tolerance: exact.
"""
import pytest

import jax  # noqa: F401  -- both frameworks in one process; data crosses as plain objects
import torch

from karpenter_tpu.solver.service import TPUSolver
from karpenter_tpu_torch import tracing as ttracing
from karpenter_tpu_torch.solver.service import TorchSolver
from tests.test_packing import catalog_items  # noqa: F401
from tests.test_torch_catalog import port_items  # noqa: F401
from tests.test_torch_oracle import SPOT_OD_POOLS, build, fuzz_spec, small_items  # noqa: F401

# small tensors: one intra-op thread per test worker (several workers share the cores)
torch.set_num_threads(1)

G = 64

# world -> (fuzz_spec arguments, the route schedule() takes)
WORLDS = {
    "one-pool": (dict(nodes=12, spread=0.0, n_templates=8), "device"),
    "spot-od": (dict(pools=SPOT_OD_POOLS, nodes=12, spread=0.0, n_templates=8, overhead=True),
                "merged"),
}


def spans_named(root, name):
    stack, found = [root], []
    while stack:
        sp = stack.pop()
        found += [sp] if sp.name == name else []
        stack.extend(sp.children)
    return found


@pytest.mark.parametrize("seed", [11, 12, 13])
@pytest.mark.parametrize("name", list(WORLDS))
def test_assignments_in_order_and_span(small_items, name, seed):
    kw, route = WORLDS[name]
    spec = fuzz_spec(seed, **kw)
    j, t = build("jax", spec, small_items), build("torch", spec, small_items)
    want = TPUSolver(g_max=G).schedule(j.scheduler(), list(j.pods))
    ts = TorchSolver(device="cpu", g_max=G)
    with ttracing.trace("tick", force=True) as root:
        got = ts.schedule(t.scheduler(), list(t.pods))
    assert ts.last_route["path"] == route
    assert list(got.existing_assignments.items()) == list(want.existing_assignments.items())
    assert len({n for n in got.existing_assignments.values()}) > 1   # several standing nodes take pods

    (span,) = spans_named(root, "pack_assign")
    assert span.attributes["placed"] == len(got.existing_assignments)
    (feas,) = spans_named(root, "pack_feasibility")
    assert 0 < span.attributes["pairs"] <= feas.attributes["classes"] * feas.attributes["nodes"]
