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


# -- the sweep's leftover-only entry ---------------------------------------------------

SWEEP_CASES = ("rampdown-like density", "padding sets only", "one class a set",
               "zero-request class, member 0", "negative request axes", "members below zero")


def sweep_worlds(seed, s_=24, c_=16, n_=24):
    """`cases.sweep_cases` on the pre-pass world grown to s_ sets (10 %
    of the nodes deleted by each), as numpy arrays."""
    headroom, feas, req, _, _ = pack_existing_world(seed, c_=c_, n_=n_)
    rng = np.random.default_rng(seed + 300)
    member = np.zeros((s_, c_), dtype=np.int32)
    excl = rng.random((s_, n_)) < 0.1
    ops = tkernel.repack_from_numpy(headroom, feas, req, member, excl, "cpu")
    return {name: tuple(t.numpy() for t in c) for name, c in cases.sweep_cases(ops, seed).items()}


def port_leftover(world):
    return tkernel.disrupt_repack_leftover(*tkernel.repack_from_numpy(*world, "cpu"))


class TestLeftoverEntry:
    """`disrupt_repack_leftover`'s plain version (what the CPU runs for the
    sweep) against the JAX package's `disrupt_repack` and the Pallas kernel
    interpreted, on the member-sparse worlds and the span guard's edges."""

    @pytest.mark.parametrize("case", SWEEP_CASES)
    @pytest.mark.parametrize("seed", [0, 1])
    def test_equals_jax_leftover(self, case, seed):
        world = sweep_worlds(seed)[case]
        left = port_leftover(world)
        jl, _ = jkernel.disrupt_repack(*world)
        assert left.dtype == torch.int32
        assert np.array_equal(left.numpy(), np.asarray(jl))

    @pytest.mark.parametrize("case", SWEEP_CASES)
    def test_equals_pallas_interpreted(self, case):
        world = sweep_worlds(2, s_=8)[case]
        pl, _ = disrupt_pallas.disrupt_repack_pallas(*world)
        assert np.array_equal(port_leftover(world).numpy(), np.asarray(pl))

    @pytest.mark.parametrize("case", SWEEP_CASES)
    def test_pairs_inside_a_span_place_nothing(self, case):
        """The span kernel's plain version (`class_spans`) proves a (set,
        class) step a no-op only where the JAX package's repack places no
        pod of the class in the set and leaves its count over."""
        world = sweep_worlds(3)[case]
        ops = tkernel.repack_from_numpy(*world, "cpu")
        spans = tk.class_spans(ops[0], ops[1], ops[2]).numpy()
        member = world[3].astype(np.int64)
        skip = (member >= spans[:, 0]) & (member <= spans[:, 1])
        jl, jt = (np.asarray(a) for a in jkernel.disrupt_repack(*world))
        assert np.array_equal(jl[skip], world[3][skip])
        assert not jt[skip].any()
        if case == "rampdown-like density":
            assert skip.mean() > 0.9

    def test_zero_request_class_takes_its_step(self):
        """A class that requests nothing has no axis that bounds its fits:
        its span is empty (and its walk covers every node), and at member 0
        it still places pods (the prefix sum wraps), as the reference does."""
        world = sweep_worlds(4)["zero-request class, member 0"]
        c = int(np.flatnonzero((world[2] == 0).all(1) & world[1].all(1))[0])
        spans = tk.class_spans(*(torch.from_numpy(a) for a in world[:3])).numpy()
        assert tuple(spans[c]) == (1, -1)
        assert not world[3][:, c].any()
        left = port_leftover(world).numpy()
        assert (left[:, c] < 0).any()
        assert np.array_equal(left, np.asarray(jkernel.disrupt_repack(*world)[0]))

    def test_negative_request_leaves_no_usable_axis(self):
        world = sweep_worlds(5)["negative request axes"]
        spans = tk.class_spans(*(torch.from_numpy(a) for a in world[:3])).numpy()
        nowhere = ~world[1].any(1)
        assert (spans[~nowhere] == (1, -1)).all()
        assert (spans[nowhere] == (-2**31, 2**31 - 1)).all()

    def test_members_below_zero_step_where_the_subtraction_wraps(self):
        """INT32_MIN - before wraps for before > 0: such a pair lies below
        every span that bounds its class, so it steps."""
        world = sweep_worlds(6)["members below zero"]
        spans = tk.class_spans(*(torch.from_numpy(a) for a in world[:3])).numpy()
        bounded = spans[:, 1] == 0
        assert (spans[bounded, 0] > -2**31).all()
        assert np.array_equal(port_leftover(world).numpy(),
                              np.asarray(jkernel.disrupt_repack(*world)[0]))

    def test_entry_on_cpu_runs_the_plain_version(self):
        world = sweep_worlds(7)["rampdown-like density"]
        before = tk.launches
        left = port_leftover(world)
        assert tk.launches == before
        assert torch.equal(left, tk.repack_reference(*tkernel.repack_from_numpy(*world, "cpu"))[0])

    def test_inputs_on_several_devices_raise(self):
        ops = list(tkernel.repack_from_numpy(*sweep_worlds(8)["padding sets only"], "cpu"))
        ops[0] = ops[0].to("meta")
        with pytest.raises(ValueError, match="several devices"):
            tk.disrupt_repack_leftover(*ops)


class TestSweepLayout:
    def test_sweep_shapes_hold_several_sets_a_block(self):
        """N=1024, R=9: a set's headroom is 36 KiB, six sets a block."""
        assert tk.sweep_set_bytes(1024, 9) == 4 * (1024 * 9 + 1)
        assert tk.sweep_sets_per_block(1024, 9) == 6
        assert tk.sweep_sets_per_block(64, 9) == tk.MAX_SETS_PER_BLOCK

    @pytest.mark.parametrize("n", [1, 17, 1024, 5000, 6000, 100_000])
    def test_a_set_fits_or_the_block_kernel_takes_it(self, n):
        k = tk.sweep_sets_per_block(n, 9)
        assert 0 <= k <= tk.MAX_SETS_PER_BLOCK
        assert (k >= 1) == (tk.sweep_set_bytes(n, 9) <= tk.SMEM_LIMIT)
        assert k * tk.sweep_set_bytes(n, 9) <= tk.SMEM_LIMIT


class TestRoom:
    @pytest.mark.parametrize("case", SWEEP_CASES)
    def test_no_pod_lands_outside_a_class_room(self, case):
        """The span kernel's room bits (`class_room`): the JAX package's
        repack places no pod of a class on a node outside them."""
        world = sweep_worlds(9)[case]
        room = tk.class_room(*(torch.from_numpy(a) for a in world[:3])).numpy()
        _, jt = jkernel.disrupt_repack(*world)
        assert not np.asarray(jt)[:, ~room].any()

    def test_full_nodes_leave_no_room(self):
        """A node whose pods axis is full has no room for any class, and a
        class that fits on no node takes no step at any count."""
        headroom, feas, req, member, excl = sweep_worlds(10)["rampdown-like density"]
        headroom = headroom.copy()
        headroom[:, 3] = 0.0
        room = tk.class_room(*(torch.from_numpy(a) for a in (headroom, feas, req))).numpy()
        spans = tk.class_spans(*(torch.from_numpy(a) for a in (headroom, feas, req))).numpy()
        pods = req[:, 3] > 0
        assert not room[pods].any()
        assert (spans[pods] == (-2**31, 2**31 - 1)).all()

    @pytest.mark.parametrize("case", SWEEP_CASES)
    def test_walked_nodes_hold_every_take(self, case):
        """`walked_nodes` (the nodes chip_smoke.py's bound counts): none for
        a pair its span proves a no-op, at most the class's room, and at
        least the nodes where the JAX package's repack places a pod."""
        world = sweep_worlds(11)[case]
        ops = tkernel.repack_from_numpy(*world, "cpu")
        walked = tk.walked_nodes(*ops).numpy()
        spans = tk.class_spans(*ops[:3]).numpy()
        room = tk.class_room(*ops[:3]).numpy().sum(1)
        m = world[3].astype(np.int64)
        no_op = (m >= spans[None, :, 0]) & (m <= spans[None, :, 1])
        _, jt = jkernel.disrupt_repack(*world)
        assert (walked[no_op] == 0).all()
        assert (walked <= room[None, :]).all()
        assert ((np.asarray(jt) != 0).sum(-1) <= walked).all()

    def test_a_walk_stops_where_the_prefix_reaches_the_count(self):
        """With room on every node and a count of one pod, a bounded class
        needs the nodes up to its first fit only."""
        headroom, feas, req, member, excl = (a.copy() for a in sweep_worlds(12)["one class a set"])
        headroom[:] = 64.0
        feas[:] = True
        req[:] = 1.0
        excl[:] = False
        member[:] = np.where(member > 0, 1, 0)
        walked = tk.walked_nodes(*tkernel.repack_from_numpy(headroom, feas, req, member, excl, "cpu"))
        assert torch.equal(walked, torch.from_numpy((member > 0).astype(np.int64)))
