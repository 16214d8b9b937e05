"""The port's repack (kernel B's plain version and its entry) against the
JAX package's `disrupt_repack` and the Pallas `disrupt_repack_pallas`
(interpreted), exactly, on the random worlds of tests/test_packing.py:427
on the one-set shape the provisioning solve's existing-node pre-pass
sends, and on the rows kernel B skips or must not skip: classes with an
empty feasibility row between real ones, and an all-zero-request class
whose int32 prefix sum over the nodes wraps.
"""
import numpy as np
import pytest

import jax  # noqa: F401  -- both frameworks in one process; data crosses as numpy
import torch

from karpenter_tpu.solver.disrupt import kernel as jkernel
from karpenter_tpu.solver.kernels import disrupt_pallas
from karpenter_tpu_torch.solver.disrupt import kernel as tkernel
from karpenter_tpu_torch.solver.kernels import cases
from karpenter_tpu_torch.solver.kernels import disrupt_repack as tk

# small tensors: one intra-op thread per test worker (several workers share the cores)
torch.set_num_threads(1)


def random_world(seed, s_=4, c_=6, n_=8, r_=4):
    """tests/test_packing.py:427's world generator."""
    rng = np.random.default_rng(seed)
    headroom = rng.uniform(0.0, 8.0, (n_, r_)).astype(np.float32)
    feas = rng.random((c_, n_)) < 0.7
    req = rng.uniform(0.1, 2.0, (c_, r_)).astype(np.float32)
    member = rng.integers(0, 5, (s_, c_), dtype=np.int32)
    excl = rng.random((s_, n_)) < 0.25
    return headroom, feas, req, member, excl


def pack_existing_world(seed, c_=16, n_=16, r_=9):
    """The pre-pass's shape: one set, nothing excluded, small exact
    integers (encode scaling), some request axes zero, padding rows."""
    rng = np.random.default_rng(seed)
    headroom = rng.integers(0, 64, (n_, r_)).astype(np.float32)
    headroom[n_ - 3:] = 0.0
    req = rng.integers(0, 4, (c_, r_)).astype(np.float32)
    req[:, 3] = 1.0                        # the pods axis
    req[c_ - 2:] = 0.0                     # padding classes
    feas = rng.random((c_, n_)) < 0.8
    feas[c_ - 2:] = False
    member = rng.integers(0, 30, (1, c_), dtype=np.int32)
    member[0, c_ - 2:] = 0
    return headroom, feas, req, member, np.zeros((1, n_), dtype=bool)


def port_repack(world):
    return tk.repack_reference(*tkernel.repack_from_numpy(*world, "cpu"))


def assert_equal_to(world, left, takes):
    jl, jt = jkernel.disrupt_repack(*world)
    assert np.array_equal(left.numpy(), np.asarray(jl))
    assert np.array_equal(takes.numpy(), np.asarray(jt))
    assert left.dtype == takes.dtype == torch.int32


class TestRepackIdentity:
    @pytest.mark.parametrize("seed", [23, 24, 25, 26])
    def test_random_worlds(self, seed):
        world = random_world(seed)
        assert_equal_to(world, *port_repack(world))

    def test_random_world_matches_pallas_interpreted(self):
        world = random_world(23)
        left, takes = port_repack(world)
        pl, pt = disrupt_pallas.disrupt_repack_pallas(*world)
        assert np.array_equal(left.numpy(), np.asarray(pl))
        assert np.array_equal(takes.numpy(), np.asarray(pt))

    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_pack_existing_shape(self, seed):
        world = pack_existing_world(seed)
        assert_equal_to(world, *port_repack(world))

    def test_entry_on_cpu_runs_the_plain_version(self):
        world = pack_existing_world(3)
        before = tk.launches
        left, takes = tkernel.disrupt_repack(*tkernel.repack_from_numpy(*world, "cpu"))
        assert tk.launches == before  # no kernel launch on the CPU
        assert_equal_to(world, left, takes)

    def test_exact_quotient(self):
        """headroom 6, request 3: exactly two pods fit."""
        world = (
            np.full((2, 1), 6.0, np.float32), np.ones((1, 2), bool),
            np.full((1, 1), 3.0, np.float32), np.array([[5]], np.int32),
            np.zeros((1, 2), bool),
        )
        left, takes = port_repack(world)
        assert takes.numpy().tolist() == [[[2, 2]]] and left.numpy().tolist() == [[1]]
        assert_equal_to(world, left, takes)

    def test_masks_may_be_uint8(self):
        world = random_world(27)
        ops = list(tkernel.repack_from_numpy(*world, "cpu"))
        ops[1] = ops[1].to(torch.uint8)
        ops[4] = ops[4].to(torch.uint8)
        assert_equal_to(world, *tk.repack_reference(*ops))


def gapped_world(seed, s_=1):
    """The pre-pass world with s_ sets (random exclusions for s_ > 1)
    through `cases.gap_repack`: every third class infeasible everywhere
    (kernel B's no-op steps between real classes) but still carrying pods."""
    headroom, feas, req, _, _ = pack_existing_world(seed, c_=24)
    rng = np.random.default_rng(seed + 100)
    member = np.zeros((s_, feas.shape[0]), dtype=np.int32)
    excl = rng.random((s_, feas.shape[1])) < (0.2 if s_ > 1 else 0.0)
    ops = cases.gap_repack(tkernel.repack_from_numpy(headroom, feas, req, member, excl, "cpu"), seed)
    return tuple(t.numpy() for t in ops)


class TestSkippedAndWrappingRows:
    @pytest.mark.parametrize("s_", [1, 4])
    def test_infeasible_rows_between_real_classes(self, s_):
        world = gapped_world(5, s_)
        left, takes = port_repack(world)
        assert_equal_to(world, left, takes)
        assert np.array_equal(left.numpy()[:, 1::3], world[3][:, 1::3])
        assert not takes.numpy()[:, 1::3].any() and takes.numpy().any()
        assert not world[1][1::3].any() and world[3].min() >= 1

    def test_infeasible_rows_match_pallas_interpreted(self):
        world = gapped_world(6, 4)
        left, takes = port_repack(world)
        pl, pt = disrupt_pallas.disrupt_repack_pallas(*world)
        assert np.array_equal(left.numpy(), np.asarray(pl))
        assert np.array_equal(takes.numpy(), np.asarray(pt))

    @pytest.mark.parametrize("member", [0, 7])
    def test_zero_request_class_wraps_the_prefix_sum(self, member):
        """A class that requests nothing fits INT32_MAX pods on every
        feasible node: the prefix sum wraps and the leftover goes negative
        on both sides."""
        headroom, feas, req, members, excl = pack_existing_world(7)
        req[4] = 0.0
        feas[4] = True
        members[0, 4] = member
        world = (headroom, feas, req, members, excl)
        left, takes = port_repack(world)
        assert_equal_to(world, left, takes)
        assert int(left[0, 4]) < 0


class TestLayout:
    def test_pre_pass_shape_is_resident(self):
        resident, chunk = tk.layout(1024, 9, 128)
        assert resident and chunk == 128
        assert tk.smem_bytes(1024, 9, 128, True) <= tk.SMEM_LIMIT

    @pytest.mark.parametrize("c", [8, 64, 256])
    def test_sweep_shapes_are_resident(self, c):
        """The consolidation sweeps' shapes (N=1024 nodes, C from 8 to
        256): headroom in shared memory and the whole class axis staged as
        one chunk (N % 16 == 0 also takes the 16-byte feasibility loads)."""
        assert tk.layout(1024, 9, c) == (True, c)

    @pytest.mark.parametrize("n", [1, 17, 1024, 5000, 6000, 100_000, 3_000_000])
    def test_every_shape_has_a_layout(self, n):
        """No node count is refused: headroom moves to device memory when
        shared memory cannot hold it, and the staged chunk still fits."""
        for c in (1, 128, 4096):
            resident, chunk = tk.layout(n, 9, c)
            assert 1 <= chunk <= min(c, 256)
            assert tk.smem_bytes(n, 9, chunk, resident) <= tk.SMEM_LIMIT
            assert resident == (tk.smem_bytes(n, 9, 1, True) <= tk.SMEM_LIMIT)
