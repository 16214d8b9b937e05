"""The port's fused FFD solve against the JAX package's, byte for byte.

Both solves run on byte-identical encoded inputs: the JAX package encodes
a world, and `karpenter_tpu_torch.solver.ffd.inputs_from_numpy` carries
its CatalogTensors/PodClassSet arrays over to the port. The port's fused
buffer (its plain scan on the CPU) must equal `ffd.ffd_solve_fused`
exactly -- all operands are small exact integers in float32 and the op
order is the same, which is why the JAX package asserts bit-identity
across its own rungs. The worlds are those of tests/test_packing.py:409,
plus pinned edge cases: tied prices, exact quotients, slot exhaustion
and a sparse overflow that takes the dense path.
"""
import dataclasses

import numpy as np
import pytest

import jax  # noqa: F401  -- both frameworks in one process; data crosses as numpy
import torch

from karpenter_tpu.solver import encode as jencode
from karpenter_tpu.solver import ffd as jffd
from karpenter_tpu.solver.service import TPUSolver
from karpenter_tpu_torch.solver import ffd as tffd
from tests.test_packing import _masked_inputs, catalog_items, churn_pods  # noqa: F401

G = 64
C_PAD = 32
CATALOG_FIELDS = ("cap", "tcode", "tnum", "tnum_present", "tzone", "tcap", "price", "words")
CLASS_FIELDS = (
    "req", "count", "env_count", "allowed", "num_lo", "num_hi", "azone", "acap",
    "schedulable", "node_overhead", "open_allowed", "join_allowed",
)

# small tensors: one intra-op thread per test worker (several workers share the cores)
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def entry(catalog_items):  # noqa: F811
    return TPUSolver(g_max=G)._catalog(list(catalog_items))


def port_inputs(catalog, class_set, packed):
    """The JAX package's encoded arrays, carried over to the port."""
    cat = {f: np.asarray(getattr(catalog, f)) for f in CATALOG_FIELDS}
    cls = {f: getattr(class_set, f, None) for f in CLASS_FIELDS}
    return tffd.inputs_from_numpy(cat, cls, "cpu", packed_masks=packed)


def both_buffers(catalog, class_set, *, packed, objective, g_max=G, nnz_max=None):
    jinp, offsets, words = jffd.make_inputs(catalog, class_set, packed_masks=packed)
    tinp, toffsets, twords = port_inputs(catalog, class_set, packed)
    assert (toffsets, twords) == (offsets, words)
    nnz_max = nnz_max if nnz_max is not None else jffd.nnz_budget(class_set.c_pad, g_max)
    kw = dict(g_max=g_max, nnz_max=nnz_max, word_offsets=offsets, words=words, objective=objective)
    want = np.asarray(jffd.ffd_solve_fused(jinp, **kw))
    got = tffd.fetch_fused(tffd.ffd_solve_fused(tinp, **kw))
    return want, got, (jinp, tinp, kw)


def assert_bytes_equal(want, got):
    assert want.dtype == got.dtype == np.uint32
    assert want.shape == got.shape
    diff = np.nonzero(want != got)[0]
    assert diff.size == 0, f"lanes {diff[:8]}: want {want[diff[:8]]} got {got[diff[:8]]}"


class TestFusedBufferIdentity:
    @pytest.mark.parametrize("objective", ["price", "fit"])
    @pytest.mark.parametrize("packed", [False, True])
    def test_masked_worlds(self, entry, packed, objective):
        pods = churn_pods(np.random.default_rng(21), 0, 52)
        cs, _ = _masked_inputs(entry, pods, c_pad=C_PAD, seed=22, packed=packed)
        want, got, _ = both_buffers(entry.tensors, cs, packed=packed, objective=objective)
        assert_bytes_equal(want, got)
        assert int(got[1]) > 0  # groups opened: the scan did real work

    @pytest.mark.parametrize("objective", ["price", "fit"])
    def test_unmasked_world(self, entry, objective):
        pods = churn_pods(np.random.default_rng(3), 0, 48)
        cs = jencode.encode_classes(jencode.group_pods(pods), entry.tensors, c_pad=C_PAD)
        want, got, _ = both_buffers(entry.tensors, cs, packed=False, objective=objective)
        assert_bytes_equal(want, got)

    def test_matches_pallas_kernel_interpreted(self, entry):
        from karpenter_tpu.solver.kernels import ffd_pallas

        pods = churn_pods(np.random.default_rng(21), 0, 52)
        cs, jinp = _masked_inputs(entry, pods, c_pad=C_PAD, seed=22, packed=True)
        tinp, offsets, words = port_inputs(entry.tensors, cs, True)
        kw = dict(g_max=G, nnz_max=jffd.nnz_budget(C_PAD, G), word_offsets=offsets,
                  words=words, objective="price")
        want = np.asarray(ffd_pallas.ffd_solve_fused_pallas(jinp, **kw))
        assert_bytes_equal(want, tffd.fetch_fused(tffd.ffd_solve_fused(tinp, **kw)))


class TestEdgeCases:
    def test_tied_prices_take_the_first_index(self, entry):
        """Every offering at one price: the envelope's argmin ties across
        many types and both sides must open on the lowest index."""
        pods = churn_pods(np.random.default_rng(5), 0, 60)
        cs = jencode.encode_classes(jencode.group_pods(pods), entry.tensors, c_pad=C_PAD)
        price = np.where(np.isfinite(entry.tensors.price), np.float32(1.0), np.float32(np.inf))
        cat = dataclasses.replace(entry.tensors, price=price.astype(np.float32))
        for objective in ("price", "fit"):
            want, got, _ = both_buffers(cat, cs, packed=True, objective=objective)
            assert_bytes_equal(want, got)

    def test_exact_quotients(self, entry):
        """Capacities that are exact multiples of the requests (6/3 = 2 and
        the like): a floor of an inexact divide would lose a pod."""
        pods = churn_pods(np.random.default_rng(6), 0, 60)
        cs = jencode.encode_classes(jencode.group_pods(pods), entry.tensors, c_pad=C_PAD)
        cap = entry.tensors.cap.copy()
        real = cap[:, 0] > 0
        cap[real, 0] = 6000.0           # millicores: 6000/250, 6000/500, 6000/2000 exact
        cap[real, 1] = 8192.0           # MiB: 8192/512 ... 8192/4096 exact
        cat = dataclasses.replace(entry.tensors, cap=cap)
        assert np.all(6000.0 / cs.req[: cs.c_real, 0] == np.floor(6000.0 / cs.req[: cs.c_real, 0]))
        for objective in ("price", "fit"):
            want, got, _ = both_buffers(cat, cs, packed=False, objective=objective)
            assert_bytes_equal(want, got)

    def test_slot_exhaustion(self, entry):
        """g_max far below the groups the pods need: opening clips to the
        free slots and the rest is reported unplaced."""
        pods = churn_pods(np.random.default_rng(7), 0, 400)
        cs = jencode.encode_classes(jencode.group_pods(pods), entry.tensors, c_pad=C_PAD)
        cat = dataclasses.replace(entry.tensors, cap=np.minimum(entry.tensors.cap, 4000.0))
        want, got, _ = both_buffers(cat, cs, packed=True, objective="price", g_max=4)
        assert_bytes_equal(want, got)
        assert int(got[1]) == 4
        unplaced = got[2: 2 + C_PAD].view(np.int32)
        assert unplaced.sum() > 0

    def test_sparse_overflow_takes_the_dense_path(self, entry):
        """A budget below the true nonzero count: the buffers still agree
        (first nnz_max entries, true nnz), expand_fused reports the
        overflow, and the dense refetch agrees with the JAX package's."""
        pods = churn_pods(np.random.default_rng(8), 0, 60)
        cs = jencode.encode_classes(jencode.group_pods(pods), entry.tensors, c_pad=C_PAD)
        want, got, (jinp, tinp, kw) = both_buffers(
            entry.tensors, cs, packed=False, objective="price", nnz_max=2)
        assert_bytes_equal(want, got)
        assert int(got[0]) > 2
        geometry = (C_PAD, G, entry.tensors.k_pad, jencode.Z_PAD, jencode.CT, 2)
        assert tffd.expand_fused(got, *geometry) is None
        dense_kw = {k: v for k, v in kw.items() if k != "nnz_max"}
        jd = jffd.solve_dense_tuple(jinp, **dense_kw)
        td = tffd.solve_dense_tuple(tinp, **dense_kw)
        for a, b in zip(jd, td):
            assert np.array_equal(np.asarray(a), np.asarray(b))
        # and the in-budget buffer expands to the same dense decision
        full = tffd.fetch_fused(tffd.ffd_solve_fused(
            tinp, **{**kw, "nnz_max": jffd.nnz_budget(C_PAD, G)}))
        expanded = tffd.expand_fused(full, *geometry[:-1], jffd.nnz_budget(C_PAD, G))
        for a, b in zip(jd, expanded):
            assert np.array_equal(np.asarray(a), np.asarray(b))


class TestSparseTake:
    @pytest.mark.parametrize("nnz_max", [1, 5, 40, 200])
    def test_matches_nonzero_with_padding(self, nnz_max):
        rng = np.random.default_rng(nnz_max)
        take = np.where(rng.random((12, 16)) < 0.15, rng.integers(1, 9, (12, 16)), 0).astype(np.int32)
        idx, val, nnz = tffd._sparse_take(torch.from_numpy(take), nnz_max)
        flat = take.ravel()
        nz = np.nonzero(flat)[0]
        assert int(nnz) == nz.size
        n = min(nz.size, nnz_max)
        assert np.array_equal(idx.numpy()[:n], nz[:n])
        assert np.array_equal(val.numpy()[:n], flat[nz[:n]])
        assert np.all(idx.numpy()[n:] == -1) and np.all(val.numpy()[n:] == 0)
