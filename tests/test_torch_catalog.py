"""The port's catalog (karpenter_tpu_torch.workload) against the JAX
package's FakeCloud -> InstanceTypeProvider chain.

Both sides are built here from their own code, with no shared state, and
the port's encoding of its catalog must be byte-equal in every
CatalogTensors field to the JAX package's encoding of the chain's items
(the tests/test_packing.py fixture). The helpers at the bottom are shared
by the other tests/test_torch_*.py files.
"""
import numpy as np
import pytest

import jax  # noqa: F401  -- both frameworks in one process; data crosses as numpy
import torch  # noqa: F401

from karpenter_tpu.scheduling import Resources as JResources
from karpenter_tpu.solver import encode as jencode
from karpenter_tpu.solver.oracle import ExistingNode as JExistingNode
from karpenter_tpu_torch import workload
from karpenter_tpu_torch.scheduling import Resources as TResources
from karpenter_tpu_torch.solver import encode as tencode
from karpenter_tpu_torch.solver.oracle import ExistingNode as TExistingNode
from tests.test_packing import catalog_items  # noqa: F401  -- the JAX chain fixture

CATALOG_FIELDS = (
    "names", "k_real", "k_pad", "cap", "tcode", "tnum", "tnum_present",
    "tzone", "tcap", "price", "zones", "words",
)

# small tensors: one intra-op thread per test worker (several workers share the cores)
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def port_items():
    return workload.build_catalog_items()


@pytest.fixture(scope="module")
def encoded_pair(catalog_items, port_items):  # noqa: F811
    return jencode.encode_catalog(catalog_items), tencode.encode_catalog(port_items)


def assert_same(a, b, what=""):
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype, (what, a.dtype, b.dtype)
        assert a.shape == b.shape, (what, a.shape, b.shape)
        assert a.tobytes() == b.tobytes(), what
    else:
        assert a == b, what


class TestCatalogTensors:
    @pytest.mark.parametrize("field", CATALOG_FIELDS)
    def test_field_byte_equal(self, encoded_pair, field):
        j, t = encoded_pair
        assert_same(getattr(j, field), getattr(t, field), field)

    def test_vocabularies_equal(self, encoded_pair):
        j, t = encoded_pair
        assert [v.values for v in j.vocabs] == [v.values for v in t.vocabs]

    def test_slice_geometry(self, encoded_pair):
        _, t = encoded_pair
        assert (t.k_real, t.k_pad, t.cap.shape[1], t.tzone.shape[1], t.tcap.shape[1]) == \
            (627, 640, 9, 8, 3)
        assert t.k_pad // 32 == 20


class TestInstanceTypes:
    def test_same_types_in_same_order(self, catalog_items, port_items):  # noqa: F811
        assert [it.name for it in catalog_items] == [it.name for it in port_items]

    def test_capacity_overhead_and_labels(self, catalog_items, port_items):  # noqa: F811
        for j, t in zip(catalog_items, port_items):
            assert j.capacity.to_vector() == t.capacity.to_vector(), j.name
            assert j.overhead.to_vector() == t.overhead.to_vector(), j.name
            assert j.requirements.labels() == t.requirements.labels(), j.name
            assert j.requirements.stable_hash() == t.requirements.stable_hash(), j.name

    def test_offerings_and_prices(self, catalog_items, port_items):  # noqa: F811
        for j, t in zip(catalog_items, port_items):
            assert [(o.capacity_type, o.zone, o.zone_id, o.price, o.available)
                    for o in j.offerings] == \
                [(o.capacity_type, o.zone, o.zone_id, o.price, o.available)
                 for o in t.offerings], j.name
            assert j.cheapest_price() == t.cheapest_price()


# -- helpers shared by the tests/test_torch_*.py files -------------------------


def decision_sig(res):
    """tests/test_packing.py decision_sig: groups by (pod names, cheapest
    type), existing assignments, unschedulable reasons."""
    return (
        sorted(
            (tuple(sorted(p.metadata.name for p in g.pods)), g.instance_types[0].name)
            for g in res.new_groups
        ),
        sorted(res.existing_assignments.items()),
        sorted(res.unschedulable.items()),
    )


def node_specs(nodes):
    """Plain specs of ExistingNodes: (name, labels, allocatable base units,
    used base units, taints), so both packages build the same nodes."""
    return [
        (n.name, dict(n.labels), dict(n.allocatable.items()), dict(n.used.items()),
         [(t.key, t.effect, t.value) for t in n.taints])
        for n in nodes
    ]


def jax_nodes(specs):
    from karpenter_tpu.scheduling import Taint

    return [JExistingNode(name, labels, JResources.from_base_units(alloc),
                          [Taint(k, e, v) for k, e, v in taints],
                          JResources.from_base_units(used))
            for name, labels, alloc, used, taints in specs]


def port_nodes(specs):
    from karpenter_tpu_torch.scheduling import Taint

    return [TExistingNode(name, labels, TResources.from_base_units(alloc),
                          [Taint(k, e, v) for k, e, v in taints],
                          TResources.from_base_units(used))
            for name, labels, alloc, used, taints in specs]


def port_churn_pods(rng: np.random.Generator, tick: int, n: int = 60):
    """tests/test_packing.py churn_pods with the port's types: the same
    draws give the same pods."""
    from karpenter_tpu_torch.apis import Pod, labels as wk
    from karpenter_tpu_torch.scheduling import Toleration

    shapes = [
        ("250m", "512Mi", None, ()),
        ("500m", "1Gi", None, ()),
        ("1", "2Gi", {wk.CAPACITY_TYPE_LABEL: wk.CAPACITY_TYPE_ON_DEMAND}, ()),
        ("2", "4Gi", {wk.ARCH_LABEL: "arm64"}, ()),
        ("500m", "2Gi", None, (Toleration(key="dedicated", operator="Exists"),)),
    ]
    pods = []
    for i in range(n):
        t = int(rng.integers(0, len(shapes)))
        cpu, mem, sel, tol = shapes[t]
        pods.append(Pod(
            f"pk-{tick}-{i}",
            requests=TResources({"cpu": cpu, "memory": mem}),
            node_selector=dict(sel) if sel else {},
            tolerations=list(tol),
        ))
    return pods
