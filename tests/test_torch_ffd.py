"""The port's fused FFD solve against the JAX package's, byte for byte.

Both solves run on byte-identical encoded inputs: the JAX package encodes
a world, and `karpenter_tpu_torch.solver.ffd.inputs_from_numpy` carries
its CatalogTensors/PodClassSet arrays over to the port. The port's fused
buffer (its plain scan on the CPU) must equal `ffd.ffd_solve_fused`
exactly -- all operands are small exact integers in float32 and the op
order is the same, which is why the JAX package asserts bit-identity
across its own rungs. The worlds are those of tests/test_packing.py:409,
plus pinned edge cases: tied prices, exact quotients, slot exhaustion,
a sparse overflow that takes the dense path, and the rows kernel A skips
or must not skip: padded (compat-empty) rows between real classes, a
count-0 class that open groups could join, and an all-zero-request class
whose int32 prefix sum over the groups wraps.
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
from karpenter_tpu_torch.solver.kernels import cases
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


class TestSkippedAndWrappingRows:
    """What kernel A's no-op skip and its placed-count shortcut must
    reproduce, pinned on the plain version against the JAX package. The
    worlds come from karpenter_tpu_torch.solver.kernels.cases, which the
    card-only tests and chip_smoke.py use too."""

    @pytest.fixture(scope="class")
    def world(self, entry):
        # many small groups: cap clipped so 400 pods open every slot
        pods = churn_pods(np.random.default_rng(7), 0, 400)
        cs = jencode.encode_classes(jencode.group_pods(pods), entry.tensors, c_pad=C_PAD)
        cat = dataclasses.replace(entry.tensors, cap=np.minimum(entry.tensors.cap, 4000.0))
        return cat, cs

    @pytest.mark.parametrize("objective", ["price", "fit"])
    def test_padded_rows_between_real_classes(self, world, objective):
        cat, cs = world
        padded = cases.padded_between(cs)
        want, got, _ = both_buffers(cat, padded, packed=True, objective=objective)
        assert_bytes_equal(want, got)
        unplaced = got[2: 2 + padded.c_pad].view(np.int32)
        assert np.all(unplaced[2::6] == 3) and int(got[1]) > 0

    @pytest.mark.parametrize("objective", ["price", "fit"])
    def test_count_zero_class_with_joinable_groups(self, world, objective):
        cat, cs = world
        zeroed = cases.take_rows(cs, np.arange(cs.c_pad))
        zeroed.count[cs.c_real - 1] = 0
        want, got, _ = both_buffers(cat, zeroed, packed=True, objective=objective)
        assert_bytes_equal(want, got)
        assert got[2 + cs.c_real - 1].view(np.int32) == 0

    @pytest.mark.parametrize("count", [None, 0])
    @pytest.mark.parametrize("objective", ["price", "fit"])
    def test_zero_request_class_wraps_the_prefix_sum(self, world, objective, count):
        """Every open group fits INT32_MAX pods of a class that requests
        nothing, so the int32 prefix sum wraps: the takes and the negative
        unplaced count are the wrap's, on both sides."""
        cat, cs = world
        c = cs.c_real - 1
        z = cases.zero_request(cs, c, count)
        want, got, _ = both_buffers(cat, z, packed=True, objective=objective)
        assert_bytes_equal(want, got)
        assert got[2 + c].view(np.int32) < 0

    def test_builders_place_the_no_op_rows(self, world):
        """padded_between puts two no-op rows (no compat or fresh word)
        after every class, so the real rows of kernel A's operands are
        those of the original world, three apart; a class set without a
        padding row is refused."""
        cat, cs = world
        words = port_inputs(cat, cs, True)[1:]

        def real(class_set):
            inp = port_inputs(cat, class_set, True)[0]
            return cases.real_classes(tffd.scan_operands(inp, *words, "price"))

        assert real(cases.padded_between(cs)) == [3 * c for c in real(cs)]
        assert real(cs) and max(real(cs)) < cs.c_real
        with pytest.raises(ValueError, match="padding row"):
            cases.padded_between(cases.take_rows(cs, np.arange(cs.c_real)))

    def test_matches_pallas_kernel_interpreted(self, world):
        """Padded rows between real classes and a wrapping zero-request
        class in one scan, against the Pallas kernel run interpreted."""
        from karpenter_tpu.solver.kernels import ffd_pallas

        cat, cs = world
        w = cases.padded_between(cs)
        last = 3 * (cs.c_real - 1)
        w.req[last] = 0.0
        jinp, offsets, words = jffd.make_inputs(cat, w, packed_masks=True)
        tinp, _, _ = port_inputs(cat, w, True)
        kw = dict(g_max=G, nnz_max=jffd.nnz_budget(w.c_pad, G), word_offsets=offsets,
                  words=words, objective="price")
        want = np.asarray(ffd_pallas.ffd_solve_fused_pallas(jinp, **kw))
        got = tffd.fetch_fused(tffd.ffd_solve_fused(tinp, **kw))
        assert_bytes_equal(want, got)
        assert got[2 + last].view(np.int32) < 0


def pr1_smem_bytes(g, k, r):
    """Shared memory of the first CUDA version of kernel A: the shapes it
    took are those where this is within one block's limit."""
    kw = k // 32
    return 4 * (g * r + g * kw + 3 * g + k * r + 3 * k + 4 * kw + r + 3 * 32)


class TestScanLayout:
    def test_main_path_shape_is_resident(self):
        from karpenter_tpu_torch.solver.kernels import ffd_scan

        assert ffd_scan.layout(1024, 640, 9) == "resident"
        assert ffd_scan.smem_bytes(1024, 640, 9) <= ffd_scan.SMEM_LIMIT

    @pytest.mark.parametrize("k", [32, 64, 640, 1024, 1056, 2048, 8192])
    @pytest.mark.parametrize("r", [1, 9, 32])
    def test_takes_every_shape_the_first_version_took(self, k, r):
        """The lean layout never needs more shared memory than the first
        version did, so no shape it took is refused now; the scratch layout
        takes more groups still, and past it the layout check raises."""
        from karpenter_tpu_torch.solver.kernels import ffd_scan

        limit = ffd_scan.SMEM_LIMIT
        g_top = next(g for g in range(1, 20_000) if pr1_smem_bytes(g + 1, k, r) > limit) \
            if pr1_smem_bytes(1, k, r) <= limit else 0
        for g in sorted({1, 64, 1024, g_top // 2, g_top} - {0}):
            if pr1_smem_bytes(g, k, r) > limit:
                continue
            assert ffd_scan.smem_bytes(g, k, r, "lean") <= pr1_smem_bytes(g, k, r)
            assert ffd_scan.layout(g, k, r) in ("resident", "lean")
        fits = [g for g in (1, 1024, 4096) if ffd_scan.smem_bytes(g, k, r, "scratch") <= limit]
        for g in fits:
            ffd_scan.layout(g, k, r)  # does not raise
        g_over = next(g for g in range(1, 60_000) if ffd_scan.smem_bytes(g, k, r, "scratch") > limit)
        assert g_over > g_top
        with pytest.raises(ValueError, match="shared memory"):
            ffd_scan.layout(g_over, k, r)


class TestWideGroups:
    """Kernel A's wide steps: groups of more than 16 surviving types, whose
    words the card deals over its warps. The world (cases.wide_groups, the
    builder chip_smoke.py and the card-only tests share) opens groups of
    hundreds of types; pinned on the plain version against the JAX package
    with narrow and wide groups in one step, a zero-request axis, tied fits
    and a class that requests nothing."""

    @pytest.fixture(scope="class")
    def cs(self, entry):
        import bench
        from karpenter_tpu_torch import workload

        pods = bench.synth_pods(np.random.default_rng(41), list(workload.ZONES), 400, 41, templates=24)
        cs = jencode.encode_classes(jencode.group_pods(pods), entry.tensors, c_pad=C_PAD)
        return cases.wide_groups(cs)

    @staticmethod
    def scan_ops(catalog, cs, objective):
        tinp, offsets, words = port_inputs(catalog, cs, True)
        return tffd.scan_operands(tinp, offsets, words, objective)

    @pytest.mark.parametrize("objective", ["price", "fit"])
    def test_opens_groups_of_hundreds_of_types(self, entry, cs, objective):
        """Groups keep 300 or more types; under the price objective some
        step meets wide and narrow groups at once (under fit every group
        opens wide)."""
        ops = self.scan_ops(entry.tensors, cs, objective)
        steps = cases.real_classes(ops)[1:] + [len(ops[0])]   # each real step, and the end
        widths = [cases.open_widths(ops, c, G, objective) for c in steps]
        assert max(int(w.max()) for w in widths if w.numel()) >= 300
        if objective == "price":
            assert cases.first_mixed_step(ops, G, objective) is not None

    @staticmethod
    def wrapping_class(catalog, cs, objective):
        """The last real class that, requesting nothing, wraps the prefix
        sum of the wide world (it joins two or more open groups)."""
        from karpenter_tpu_torch.solver.kernels import ffd_scan

        for c in range(cs.c_real - 1, 0, -1):
            z = cases.zero_request(cs, c)
            unplaced = ffd_scan.fused_scan_reference(
                *TestWideGroups.scan_ops(catalog, z, objective), g_max=G, objective=objective)[1]
            if int(unplaced[c]) < 0:
                return z, c
        raise AssertionError("no class of the wide world wraps when it requests nothing")

    @pytest.mark.parametrize("objective", ["price", "fit"])
    @pytest.mark.parametrize("variant", ["wide", "zero-request axis", "tied fits", "requests nothing"])
    def test_matches_jax(self, entry, cs, objective, variant):
        cat = entry.tensors
        if variant == "zero-request axis":
            cs = cases.take_rows(cs, np.arange(cs.c_pad))
            cs.req[: cs.c_real, 0] = 0.0
        elif variant == "tied fits":
            cap = entry.tensors.cap.copy()
            real = cap[:, 0] > 0
            cap[real] = cap[real][np.argmax(cap[real, 0])]
            cat = dataclasses.replace(entry.tensors, cap=cap)
        elif variant == "requests nothing":
            cs, c = self.wrapping_class(cat, cs, objective)
        want, got, _ = both_buffers(cat, cs, packed=True, objective=objective)
        assert_bytes_equal(want, got)
        if variant == "requests nothing":
            assert got[2 + c].view(np.int32) < 0

    @pytest.mark.parametrize("objective", ["price", "fit"])
    def test_matches_pallas_kernel_interpreted(self, entry, cs, objective):
        from karpenter_tpu.solver.kernels import ffd_pallas

        jinp, offsets, words = jffd.make_inputs(entry.tensors, cs, packed_masks=True)
        tinp, _, _ = port_inputs(entry.tensors, cs, True)
        kw = dict(g_max=G, nnz_max=jffd.nnz_budget(cs.c_pad, G), word_offsets=offsets,
                  words=words, objective=objective)
        want = np.asarray(ffd_pallas.ffd_solve_fused_pallas(jinp, **kw))
        assert_bytes_equal(want, tffd.fetch_fused(tffd.ffd_solve_fused(tinp, **kw)))
