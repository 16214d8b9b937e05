"""The port's grouping and class encoding against the JAX package's.

About 2,000 bench-style pods from one numpy seed are built on each side by
its own generator (bench.py `synth_pods` and workload.synth_pods make the
same draws), grouped with `group_pods` under the default pool's
requirements, and encoded against each side's own catalog. Every
PodClassSet field must be equal, byte for byte, and so must the host
compat matrix and the packed mask primitives.
"""
import numpy as np
import pytest

import jax  # noqa: F401  -- both frameworks in one process; data crosses as numpy
import torch

import bench
from karpenter_tpu.apis import NodePool as JNodePool
from karpenter_tpu.solver import encode as jencode
from karpenter_tpu.solver import packing as jpacking
from karpenter_tpu_torch import workload
from karpenter_tpu_torch.apis import NodePool as TNodePool
from karpenter_tpu_torch.solver import encode as tencode
from karpenter_tpu_torch.solver import packing as tpacking
from tests.test_torch_catalog import assert_same, encoded_pair, port_items  # noqa: F401
from tests.test_packing import catalog_items  # noqa: F401

SEED = 1234
N_PODS = 2_000

CLASS_FIELDS = (
    "c_real", "c_pad", "req", "count", "env_count", "num_lo", "num_hi",
    "azone", "acap", "schedulable", "node_overhead", "base_req",
)

# small tensors: one intra-op thread per test worker (several workers share the cores)
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def class_pair(encoded_pair):  # noqa: F811
    jcat, tcat = encoded_pair
    jpods = bench.synth_pods(np.random.default_rng(SEED), list(workload.ZONES), N_PODS, salt=7)
    tpods = workload.synth_pods(np.random.default_rng(SEED), workload.ZONES, N_PODS, salt=7)
    jclasses = jencode.group_pods(jpods, extra_requirements=JNodePool("default").requirements())
    tclasses = tencode.group_pods(tpods, extra_requirements=TNodePool("default").requirements())
    c_pad = jencode.bucket(len(jclasses), 16)
    jset = jencode.encode_classes(jclasses, jcat, c_pad=c_pad)
    tset = tencode.encode_classes(tclasses, tcat, c_pad=c_pad)
    return jclasses, tclasses, jset, tset


class TestGrouping:
    def test_same_classes_in_same_order(self, class_pair):
        jclasses, tclasses, _, _ = class_pair
        assert len(jclasses) == len(tclasses) > 50
        for j, t in zip(jclasses, tclasses):
            assert [p.metadata.name for p in j.pods] == [p.metadata.name for p in t.pods]
            assert j.key == t.key
            assert j.requirements.stable_hash() == t.requirements.stable_hash()
            assert np.array_equal(j.requests, t.requests)

    def test_sort_keys_agree(self, class_pair):
        jclasses, tclasses, _, _ = class_pair
        assert [jencode.pod_sort_key(pc.pods[0]) for pc in jclasses] == \
            [tencode.pod_sort_key(pc.pods[0]) for pc in tclasses]


class TestPodClassSet:
    @pytest.mark.parametrize("field", CLASS_FIELDS)
    def test_field_byte_equal(self, class_pair, field):
        _, _, jset, tset = class_pair
        assert_same(getattr(jset, field), getattr(tset, field), field)

    def test_allowed_bitsets_byte_equal(self, class_pair):
        _, _, jset, tset = class_pair
        assert len(jset.allowed) == len(tset.allowed) == len(tencode.LABEL_DIMS)
        for d, (a, b) in enumerate(zip(jset.allowed, tset.allowed)):
            assert_same(a, b, tencode.LABEL_DIMS[d])

    def test_compat_matrix_equal(self, class_pair, encoded_pair):  # noqa: F811
        _, _, jset, tset = class_pair
        jcat, tcat = encoded_pair
        assert_same(jencode.compat_matrix(jcat, jset), tencode.compat_matrix(tcat, tset))

    def test_pack_class_masks_equal(self, class_pair, encoded_pair):  # noqa: F811
        _, _, jset, tset = class_pair
        rng = np.random.default_rng(3)
        mask = rng.random((jset.c_pad, encoded_pair[0].k_pad)) < 0.5
        jset.open_allowed, tset.open_allowed = mask.copy(), mask.copy()
        jencode.pack_class_masks(jset)
        tencode.pack_class_masks(tset)
        assert_same(jset.open_allowed, tset.open_allowed)
        jset.open_allowed = tset.open_allowed = None


class TestPackedMasks:
    @pytest.mark.parametrize("shape", [(1, 32), (7, 128), (33, 640), (5, 40)])
    def test_host_pack_equal(self, shape):
        m = np.random.default_rng(shape[0]).random(shape) < 0.5
        assert_same(jpacking.pack_mask(m), tpacking.pack_mask(m))
        assert np.array_equal(tpacking.unpack_mask(tpacking.pack_mask(m), shape[1]), m)

    @pytest.mark.parametrize("k", [32, 640])
    def test_device_rows_round_trip_every_bit(self, k):
        """The int32-lane pack/unpack against the host uint32 words,
        including bit 31 (the sign bit of the lane)."""
        m = np.random.default_rng(k).random((9, k)) < 0.5
        m[:, 31] = True
        lanes = tpacking.pack_rows(torch.from_numpy(m))
        assert lanes.dtype == torch.int32
        assert np.array_equal(lanes.numpy().view(np.uint32), jpacking.pack_mask(m))
        assert np.array_equal(tpacking.unpack_rows(lanes, k).numpy(), m)
        got = np.asarray(jpacking.unpack_mask_jnp(jax.numpy.asarray(jpacking.pack_mask(m)), k))
        assert np.array_equal(got, m)
