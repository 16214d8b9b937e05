"""The CUDA kernels against their plain versions, on the card.

Marked `cuda`: every test takes the `cuda` fixture, which skips when no
CUDA device is present (the decision is made in the fixture, never at
import, so every worker collects the same tests). The file imports
nothing of JAX, so it runs on a machine that has only the port:

    python -m pytest --noconftest -o markers=cuda -m cuda tests/test_torch_cuda.py -q

Tolerance: exact equality. Inputs are small exact integers in float32 and
both versions take the same float operations in the same order.
"""
import numpy as np
import pytest
import torch

from karpenter_tpu_torch import workload
from karpenter_tpu_torch.apis import NodePool
from karpenter_tpu_torch.solver import encode, ffd
from karpenter_tpu_torch.solver.disrupt import kernel as disrupt_kernel
from karpenter_tpu_torch.solver.kernels import cases
from karpenter_tpu_torch.solver.kernels import disrupt_repack as repack
from karpenter_tpu_torch.solver.kernels import ffd_scan
from karpenter_tpu_torch.scheduling import Requirement
from karpenter_tpu_torch.solver.oracle import Scheduler
from karpenter_tpu_torch.solver.service import TorchSolver, _MergedVirtualPool

# small tensors: one intra-op thread per test worker (several workers share the cores)
torch.set_num_threads(1)

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the port's kernels run only on the card)")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def items():
    return workload.build_catalog_items()


def class_world(items, device, n_pods, seed, price_scale=None, templates=0):
    """(class set, staged catalog, word offsets, words) of a synthetic world."""
    pods = workload.synth_pods(np.random.default_rng(seed), workload.ZONES, n_pods, salt=seed,
                               templates=templates)
    classes = encode.group_pods(pods, extra_requirements=NodePool("default").requirements())
    catalog = encode.encode_catalog(items)
    if price_scale is not None:
        catalog.price = np.where(np.isfinite(catalog.price), np.float32(price_scale), catalog.price)
    cs = encode.encode_classes(classes, catalog, c_pad=encode.bucket(len(classes), 16))
    return (cs, *ffd.stage_catalog(catalog, device))


def scan_inputs(items, device, n_pods, seed, packed=True, price_scale=None, templates=0):
    cs, staged, offsets, words = class_world(items, device, n_pods, seed, price_scale, templates)
    return ffd.make_inputs_staged(staged, cs, packed_masks=packed), offsets, words


def price_operands(world, cs):
    """Kernel A's operands of class set `cs` over the world's staged catalog."""
    _, staged, offsets, words = world
    return ffd.scan_operands(ffd.make_inputs_staged(staged, cs, packed_masks=True), offsets, words, "price")


def assert_scan_equal(ops, g_max, objective):
    before = ffd_scan.launches
    got = ffd_scan.fused_scan(*ops, g_max=g_max, objective=objective)
    torch.cuda.synchronize()
    assert ffd_scan.launches == before + 1
    want = ffd_scan.fused_scan_reference(*ops, g_max=g_max, objective=objective)
    for name, a, b in zip(("take", "unplaced", "n_open", "gmask_bits", "gzc"), got, want):
        assert torch.equal(a.cpu(), b.cpu()), name
    return got


class TestFusedScanKernel:
    @pytest.mark.parametrize("objective", ["price", "fit"])
    @pytest.mark.parametrize("packed", [True, False])
    def test_matches_plain_version(self, cuda, items, packed, objective):
        inp, offsets, words = scan_inputs(items, cuda, 8_000, seed=1, packed=packed)
        ops = ffd.scan_operands(inp, offsets, words, objective)
        got = assert_scan_equal(ops, 256, objective)
        assert int(got[2]) > 0

    def test_main_path_shape(self, cuda, items):
        inp, offsets, words = scan_inputs(items, cuda, 50_000, seed=2)
        ops = ffd.scan_operands(inp, offsets, words, "price")
        # 50k pods of 160 templates collapse to ~62 classes (c_pad 64)
        assert ops[0].shape[0] >= 64 and tuple(ops[4].shape[1:]) == (640,)
        assert_scan_equal(ops, 1024, "price")

    def test_tied_prices(self, cuda, items):
        inp, offsets, words = scan_inputs(items, cuda, 4_000, seed=3, price_scale=1.0)
        assert_scan_equal(ffd.scan_operands(inp, offsets, words, "price"), 128, "price")

    def test_slot_exhaustion(self, cuda, items):
        inp, offsets, words = scan_inputs(items, cuda, 4_000, seed=4)
        got = assert_scan_equal(ffd.scan_operands(inp, offsets, words, "price"), 8, "price")
        assert int(got[2]) == 8 and int(got[1].sum()) > 0


class TestSkippedAndWrappingRows:
    """The rows kernel A skips (no-op classes) and those it must not: the
    edge cases of chip_smoke.py (karpenter_tpu_torch.solver.kernels.cases),
    at a small size."""

    @pytest.fixture(scope="class")
    def world(self, cuda, items):
        return class_world(items, cuda, 8_000, seed=1)

    @pytest.fixture(scope="class")
    def ops(self, world):
        return price_operands(world, world[0])

    def test_padded_rows_between_real_classes(self, world):
        got = assert_scan_equal(price_operands(world, cases.padded_between(world[0])), 256, "price")
        assert torch.all(got[1][2::6].cpu() == 3)

    def test_count_zero_class_with_joinable_groups(self, world):
        cs = world[0]
        zeroed = cases.take_rows(cs, np.arange(cs.c_pad))
        zeroed.count[cs.c_real - 1] = 0
        ops = price_operands(world, zeroed)
        assert cs.c_real - 1 in cases.real_classes(ops)
        assert_scan_equal(ops, 256, "price")

    @pytest.mark.parametrize("count", [None, 0])
    def test_zero_request_class_wraps_the_prefix_sum(self, world, count):
        c = world[0].c_real - 1
        got = assert_scan_equal(price_operands(world, cases.zero_request(world[0], c, count)), 256, "price")
        assert int(got[1][c]) < 0

    @pytest.mark.parametrize("g_max", [256, 1500])
    def test_lean_layout(self, ops, g_max):
        got = ffd_scan._launch(*ops, g_max=g_max, objective="price", layout_name="lean")
        want = ffd_scan.fused_scan_reference(*ops, g_max=g_max, objective="price")
        for a, b in zip(got, want):
            assert torch.equal(a.cpu(), b.cpu())

    @pytest.mark.parametrize("r", [9, 8])
    @pytest.mark.parametrize("g_max", [256, 1500])
    def test_scratch_layout(self, ops, g_max, r):
        """The survivor words in device memory, at a shape where the
        shared-memory layouts fit too; R = 8 takes the run-time-R case."""
        ops = list(ops)
        ops[0] = ops[0][:, :r].contiguous()
        ops[9] = ops[9][:, :r].contiguous()
        got = ffd_scan._launch(*ops, g_max=g_max, objective="price", layout_name="scratch")
        want = ffd_scan.fused_scan_reference(*ops, g_max=g_max, objective="price")
        for a, b in zip(got, want):
            assert torch.equal(a.cpu(), b.cpu())

    def test_request_axes_other_than_nine(self, ops):
        """R = 9 is a template case of the kernel; any other R takes the
        run-time path."""
        r8 = list(ops)
        r8[0] = ops[0][:, :8].contiguous()
        r8[9] = ops[9][:, :8].contiguous()
        assert_scan_equal(tuple(r8), 256, "price")

    def test_c256_world(self, cuda, items):
        inp, offsets, words = scan_inputs(items, cuda, 50_000, seed=3, templates=4000)
        ops = ffd.scan_operands(inp, offsets, words, "price")
        assert ops[0].shape[0] == 256
        assert_scan_equal(ops, 1024, "price")


class TestRepackKernel:
    @pytest.mark.parametrize("seed", [0, 1])
    def test_many_sets_match_plain_version(self, cuda, seed):
        rng = np.random.default_rng(seed)
        s_, c_, n_, r_ = 64, 48, 200, 9
        world = (
            rng.integers(0, 64, (n_, r_)).astype(np.float32), rng.random((c_, n_)) < 0.7,
            rng.integers(0, 5, (c_, r_)).astype(np.float32), rng.integers(0, 40, (s_, c_)),
            rng.random((s_, n_)) < 0.2,
        )
        ops = disrupt_kernel.repack_from_numpy(*world, cuda)
        before = repack.launches
        got = repack.disrupt_repack(*ops)
        torch.cuda.synchronize()
        assert repack.launches == before + 1
        want = repack.repack_reference(*ops)
        for a, b in zip(got, want):
            assert torch.equal(a.cpu(), b.cpu())

    @pytest.mark.parametrize("s_", [1, 64])
    def test_infeasible_rows_between_real_classes(self, cuda, s_):
        rng = np.random.default_rng(s_)
        c_, n_ = 48, 200
        world = (
            rng.integers(0, 64, (n_, 9)).astype(np.float32), rng.random((c_, n_)) < 0.7,
            rng.integers(0, 5, (c_, 9)).astype(np.float32), rng.integers(0, 40, (s_, c_)),
            rng.random((s_, n_)) < 0.2,
        )
        ops = cases.gap_repack(disrupt_kernel.repack_from_numpy(*world, cuda))
        left, takes = repack.disrupt_repack(*ops)
        want_left, want_takes = repack.repack_reference(*ops)
        assert torch.equal(left.cpu(), want_left.cpu()) and torch.equal(takes.cpu(), want_takes.cpu())
        assert torch.equal(left[:, 1::3].cpu(), ops[3][:, 1::3].cpu())

    def test_zero_request_class_wraps_and_scratch_layout(self, cuda):
        rng = np.random.default_rng(9)
        world = (
            rng.integers(0, 64, (64, 9)).astype(np.float32), rng.random((16, 64)) < 0.7,
            rng.integers(0, 5, (16, 9)).astype(np.float32), rng.integers(0, 40, (1, 16)),
            np.zeros((1, 64), bool),
        )
        world[2][5] = 0.0
        world[1][5] = True
        ops = disrupt_kernel.repack_from_numpy(*world, cuda)
        want = repack.repack_reference(*ops)
        assert int(want[0][0, 5]) < 0
        for got in (repack.disrupt_repack(*ops), repack._launch(*ops, resident=False)):
            for a, b in zip(got, want):
                assert torch.equal(a.cpu(), b.cpu())

    def test_request_axes_other_than_nine(self, cuda):
        rng = np.random.default_rng(4)
        world = (
            rng.integers(0, 64, (96, 8)).astype(np.float32), rng.random((16, 96)) < 0.7,
            rng.integers(0, 5, (16, 8)).astype(np.float32), rng.integers(0, 40, (4, 16)),
            rng.random((4, 96)) < 0.2,
        )
        ops = disrupt_kernel.repack_from_numpy(*world, cuda)
        for a, b in zip(repack.disrupt_repack(*ops), repack.repack_reference(*ops)):
            assert torch.equal(a.cpu(), b.cpu())

    def test_exact_quotient(self, cuda):
        ops = disrupt_kernel.repack_from_numpy(
            np.full((2, 1), 6.0), np.ones((1, 2), bool), np.full((1, 1), 3.0),
            np.array([[5]]), np.zeros((1, 2), bool), cuda)
        left, takes = repack.disrupt_repack(*ops)
        assert takes.cpu().tolist() == [[[2, 2]]] and left.cpu().tolist() == [[1]]


class TestSolverOnTheCard:
    def test_two_ticks_match_the_cpu(self, cuda, items):
        pool = NodePool("default")
        gpu, cpu = TorchSolver(g_max=128), TorchSolver(device="cpu", g_max=128)
        assert gpu.device.type == "cuda"
        pods1 = workload.synth_pods(np.random.default_rng(5), workload.ZONES, 3_000, 5, 40)
        a1, b1 = gpu.solve(pool, items, pods1), cpu.solve(pool, items, pods1)
        nodes = workload.nodes_from_result(b1)
        for n in nodes[:20]:
            n.used = n.used * 0.5
        pods2 = workload.synth_pods(np.random.default_rng(6), workload.ZONES, 800, 6, 40)
        a2 = gpu.solve(pool, items, pods2, existing_nodes=nodes)
        b2 = cpu.solve(pool, items, pods2, existing_nodes=nodes)
        for a, b in ((a1, b1), (a2, b2)):
            assert sorted((tuple(p.metadata.name for p in g.pods), g.instance_types[0].name)
                          for g in a.new_groups) == \
                sorted((tuple(p.metadata.name for p in g.pods), g.instance_types[0].name)
                       for g in b.new_groups)
            assert a.existing_assignments == b.existing_assignments
            assert a.unschedulable == b.unschedulable
        assert a2.existing_assignments


def merged_operands(items, device, pools, n_pods=8_000, seed=7):
    """Kernel A's operands for a merged multi-pool catalog of `pools`."""
    solver = TorchSolver(g_max=1024, device=device)
    sched = Scheduler(nodepools=pools, instance_types={p.name: items for p in pools},
                      zones=set(workload.ZONES))
    _, entry = solver._merged_catalog(sched)
    pods = workload.synth_pods(np.random.default_rng(seed), workload.ZONES, n_pods, salt=seed)
    classes = encode.group_pods(pods)
    cs = solver._encode(_MergedVirtualPool("__merged__"), entry, classes,
                        np.zeros(len(classes), dtype=np.int64))
    inp = ffd.make_inputs_staged(entry.staged, cs, packed_masks=True)
    return ffd.scan_operands(inp, entry.offsets, entry.words, "price")


def spot_on_demand_pools():
    return [
        NodePool("spot", weight=100,
                 requirements=[Requirement("karpenter.sh/capacity-type", "In", ["spot"])]),
        NodePool("on-demand", weight=10,
                 requirements=[Requirement("karpenter.sh/capacity-type", "In", ["on-demand"])]),
    ]


class TestMergedCatalogWidths:
    """Two overlapping pools over the 627-type catalog give K=1280, where
    kernel A's resident layout no longer fits and the lean one does; three
    give K=1920, where neither fits and the scratch layout keeps the
    survivor words in device memory."""

    def test_k1280_lean_layout_matches_plain_version(self, cuda, items):
        ops = merged_operands(items, cuda, spot_on_demand_pools())
        assert ops[9].shape[0] == 1280
        assert ffd_scan.layout(1024, 1280, ops[0].shape[1]) == "lean"
        got = assert_scan_equal(ops, 1024, "price")
        assert int(got[2]) > 0

    def test_k1920_scratch_layout_matches_plain_version(self, cuda, items):
        ops = merged_operands(items, cuda, spot_on_demand_pools() + [NodePool("default")],
                              n_pods=2_000)
        assert ops[9].shape[0] == 1920
        assert ffd_scan.layout(1024, 1920, ops[0].shape[1]) == "scratch"
        got = assert_scan_equal(ops, 1024, "price")
        assert int(got[2]) > 0


class TestScheduleOnTheCard:
    def test_merged_and_spread_routes_match_the_cpu(self, cuda, items):
        """schedule() through both kernels decides as the plain versions
        do: a merged two-pool batch, and a zone-spread wave onto existing
        nodes (kernel B on zone-pinned rows)."""
        pods = workload.synth_pods(np.random.default_rng(8), workload.ZONES, 2_000, 8, 40,
                                   spread=8)
        wave = workload.synth_pods(np.random.default_rng(9), workload.ZONES, 600, 9, 40,
                                   spread=8)
        results = []
        for device in (cuda, "cpu"):
            solver = TorchSolver(g_max=256, device=device)
            pools = spot_on_demand_pools()
            merged = solver.schedule(Scheduler(
                nodepools=pools, instance_types={p.name: items for p in pools},
                zones=set(workload.ZONES)), pods)
            assert solver.last_route["path"] == "merged"
            pool = NodePool("default")
            tick1 = solver.schedule(Scheduler(
                nodepools=[pool], instance_types={pool.name: items},
                zones=set(workload.ZONES)), pods)
            nodes = workload.nodes_from_result(tick1)
            for n in nodes[:30]:
                n.used = n.used * 0.5
            before = repack.launches
            tick2 = solver.schedule(Scheduler(
                nodepools=[pool], instance_types={pool.name: items}, existing_nodes=nodes,
                pods_by_node=workload.pods_by_node(tick1), zones=set(workload.ZONES)), wave)
            assert solver.last_route["path"] == "device"
            if device is cuda:
                assert repack.launches == before + 1
            results.append([
                (sorted((tuple(p.metadata.name for p in g.pods), g.instance_types[0].name)
                        for g in r.new_groups), r.existing_assignments, r.unschedulable)
                for r in (merged, tick1, tick2)
            ])
        assert results[0] == results[1]
        assert results[0][2][1], "the wave packed nothing onto the existing nodes"


class TestConsolidationOnTheCard:
    @pytest.mark.parametrize("keep", [0.25, 1.0])
    def test_rampdown_sweep_matches_the_cpu(self, cuda, items, keep):
        """DisruptEngine on the card (kernel B, one block per set, and the
        replacement search in torch) decides as device="cpu" does, on a
        reduced ramp-down sweep (and on the cluster before the ramp-down)
        under the weighted spot / on-demand pools with daemonset overhead."""
        from karpenter_tpu_torch.solver.disrupt import DisruptEngine

        pods = workload.synth_pods(np.random.default_rng(5), workload.ZONES, 3_000, 5, 40)
        tick = TorchSolver(device="cpu", g_max=128).solve(NodePool("default"), items, pods)
        spec = workload.rampdown_sweep_spec(tick, np.random.default_rng(11), n_cand=32, keep=keep)
        nodes, sets = workload.sweep_world(spec)
        pools, ovh = workload.sweep_pools("spot-od")
        kw = dict(pools=pools, catalogs={p.name: items for p in pools}, daemon_overhead=ovh)
        before, calls = repack.launches, disrupt_kernel.replace_calls
        gpu = DisruptEngine(solver=TorchSolver(g_max=128)).evaluate(nodes, sets, **kw)
        assert repack.launches == before + 1
        cpu = DisruptEngine(device="cpu").evaluate(nodes, sets, **kw)
        assert [repr(v) for v in gpu] == [repr(v) for v in cpu]
        if keep == 1.0:
            assert disrupt_kernel.replace_calls > calls
            assert any(v.replace_type is not None for v in cpu)


class TestQualityAndConvexOnTheCard:
    """The quality bound and the convex tier's relaxation are torch code
    on the device (no kernel of their own): on the card they give what
    the CPU gives -- the bound at rel=1e-6, x and the lower bound within
    5e-5, the decisions exactly."""

    def test_bound_matches_the_cpu(self, cuda, items):
        from karpenter_tpu_torch.solver import bound

        got_in, offsets, words = scan_inputs(items, cuda, 8_000, seed=1)
        want_in, _, _ = scan_inputs(items, "cpu", 8_000, seed=1)
        placed = want_in.count.to(torch.float32)
        got = bound.fractional_price_bound(got_in, placed.to(cuda), word_offsets=offsets, words=words)
        want = bound.fractional_price_bound(want_in, placed, word_offsets=offsets, words=words)
        assert got.is_cuda
        torch.testing.assert_close(got.cpu(), want, rtol=1e-6, atol=0.0)
        assert bound.fetch_bound(got)[1] == bound.fetch_bound(want)[1]
        assert float(want.max()) > 0.0

    def test_convex_tier_matches_the_cpu(self, cuda, items):
        from karpenter_tpu_torch.apis import Pod
        from karpenter_tpu_torch.scheduling import Resources
        from karpenter_tpu_torch.solver.convex import relax

        shapes = (("1100m", "2200Mi"), ("700m", "1400Mi"), ("1700m", "3400Mi"))
        pods = [Pod(f"adv{i}", requests=Resources({"cpu": shapes[i % 3][0],
                                                   "memory": shapes[i % 3][1]}))
                for i in range(30)]
        pool = NodePool("default")
        gpu = TorchSolver(g_max=64, tier="convex")
        cpu = TorchSolver(device="cpu", g_max=64, tier="convex")
        a, b = gpu.solve(pool, items, pods), cpu.solve(pool, items, pods)
        assert sorted((tuple(p.metadata.name for p in g.pods), g.instance_types[0].name)
                      for g in a.new_groups) == \
            sorted((tuple(p.metadata.name for p in g.pods), g.instance_types[0].name)
                   for g in b.new_groups)
        assert gpu.last_convex["winner"] == cpu.last_convex["winner"] == "convex"
        for key in ("price_ffd", "price_convex", "iterations"):
            assert gpu.last_convex[key] == cpu.last_convex[key], key
        assert abs(gpu.last_convex["lower"] - cpu.last_convex["lower"]) <= 5e-5
        for key, value in cpu.last_quality.items():
            if key in ("bound_per_h", "optimality_gap"):
                assert gpu.last_quality[key] == pytest.approx(value, rel=1e-6, abs=1e-6)
            else:
                assert gpu.last_quality[key] == value, key
        # the relaxation itself on the same inputs
        got_in, offsets, words = scan_inputs(items, cuda, 8_000, seed=2)
        want_in, _, _ = scan_inputs(items, "cpu", 8_000, seed=2)
        kw = dict(iters=relax.DEFAULT_ITERS, word_offsets=offsets, words=words)
        gx, glower, gtrace = relax.fetch_relax(relax.convex_relax(got_in, **kw))
        wx, wlower, wtrace = relax.fetch_relax(relax.convex_relax(want_in, **kw))
        np.testing.assert_allclose(gx, wx, atol=5e-5, rtol=0)
        np.testing.assert_allclose(gtrace, wtrace, atol=5e-5 * max(abs(wtrace).max(), 1.0), rtol=0)
        assert abs(glower - wlower) <= 5e-5 * max(wlower, 1.0)


def adversarial(n=30):
    from karpenter_tpu_torch.apis import Pod
    from karpenter_tpu_torch.scheduling import Resources

    shapes = (("1100m", "2200Mi"), ("700m", "1400Mi"), ("1700m", "3400Mi"))
    return [Pod(f"adv{i}", requests=Resources({"cpu": shapes[i % 3][0], "memory": shapes[i % 3][1]}))
            for i in range(n)]


def decision(result):
    return (sorted((tuple(sorted(p.metadata.name for p in g.pods)), g.instance_types[0].name)
                   for g in result.new_groups),
            sorted(result.existing_assignments.items()), sorted(result.unschedulable.items()))


class TestObservabilityOnTheCard:
    """The degrade rungs, the device-memory ledger, the profiler and the
    dispatch counter with the kernels on the card."""

    @pytest.mark.parametrize("drill", ["convex.rounding", "rpc.convex.dispatch", "bound"])
    def test_drills_take_the_ffd_rung(self, cuda, items, drill, monkeypatch):
        from karpenter_tpu_torch import failpoints, metrics
        from karpenter_tpu_torch.solver import bound

        pool, pods = NodePool("default"), adversarial()
        ffd_tick = decision(TorchSolver(g_max=64).solve(pool, items, pods))
        solver = TorchSolver(g_max=64, tier="convex" if drill != "bound" else "ffd")
        if drill == "bound":
            read = lambda: metrics.HANDLED_ERRORS.value(site="solver.quality_dispatch")  # noqa: E731

            def broken(*a, **k):
                raise RuntimeError("drill: the quality bound raises")

            monkeypatch.setattr(bound, "fractional_price_bound", broken)
        else:
            reason = "rounding" if drill == "convex.rounding" else "dispatch"
            read = lambda: metrics.CONVEX_FALLBACKS.value(reason=reason)  # noqa: E731
            failpoints.FAILPOINTS.arm(drill, "error", "RuntimeError", times=1)
        before = read()
        try:
            got = decision(solver.solve(pool, items, pods))
        finally:
            failpoints.FAILPOINTS.reset()
            monkeypatch.undo()
        assert got == ffd_tick and read() == before + 1
        again = solver.solve(pool, items, pods)
        assert read() == before + 1
        if drill != "bound":
            assert solver.last_convex["winner"] == "convex" and decision(again) != ffd_tick
        else:
            assert "optimality_gap" in solver.last_quality

    def test_hbm_poll_is_torch_cuda(self, cuda, items):
        from karpenter_tpu_torch.obs import hbm

        solver = TorchSolver(g_max=64)
        solver.solve(NodePool("default"), items, adversarial())
        torch.cuda.synchronize()
        snap = hbm.poll(max_age_s=0)
        dev = snap["devices"]["cuda:0"]
        assert dev["bytes_in_use"] == torch.cuda.memory_allocated(0) > 0
        assert dev["peak_bytes"] >= torch.cuda.max_memory_allocated(0)
        assert dev["bytes_limit"] == torch.cuda.mem_get_info(0)[1]
        assert snap["headroom_fraction"] == pytest.approx(1 - dev["bytes_in_use"] / dev["bytes_limit"])
        assert solver.staged_bytes_by_kind()["catalog"] > 0

    def test_profiler_capture_names_kernel_a(self, cuda, items, tmp_path):
        import json

        from karpenter_tpu_torch.obs import profiler

        prof = profiler.ProfilerCapture()
        solver = TorchSolver(g_max=64)
        pods = workload.synth_pods(np.random.default_rng(2), workload.ZONES, 2_000, 2)
        solver.solve(NodePool("default"), items, pods)
        prof.request(2, out_dir=str(tmp_path))
        for _ in range(2):
            prof.on_tick_start()
            solver.solve(NodePool("default"), items, pods)
            prof.on_tick_end()
        assert prof.describe()["captures"] == 1
        with open(tmp_path / "capture-1" / profiler.TRACE_FILE) as f:
            events = json.load(f)["traceEvents"]
        kernels = [e.get("name", "") for e in events if e.get("cat") == "kernel"]
        assert sum("ffd_scan_kernel" in name for name in kernels) == 2

    def test_dispatch_counter_counts_the_card(self, cuda, items):
        from karpenter_tpu_torch import metrics
        from karpenter_tpu_torch.solver.disrupt import DisruptEngine

        def counts():
            return {(e, i): metrics.SOLVER_KERNEL_DISPATCHES.value(entry=e, impl=i)
                    for e in ("ffd_solve_fused", "disrupt_repack") for i in ("cuda", "plain")}

        solver = TorchSolver(g_max=128)
        pods = workload.synth_pods(np.random.default_rng(5), workload.ZONES, 3_000, 5, 40)
        before, a0, b0 = counts(), ffd_scan.launches, repack.launches
        local0 = metrics.DISRUPTION_DEVICE_DISPATCHES.value(path="local")
        tick = solver.solve(NodePool("default"), items, pods)
        spec = workload.rampdown_sweep_spec(tick, np.random.default_rng(11), n_cand=32)
        nodes, sets = workload.sweep_world(spec)
        DisruptEngine(solver=solver).evaluate(nodes, sets)
        torch.cuda.synchronize()
        moved = {k: v - before[k] for k, v in counts().items()}
        # the solver's family counts the solver's own launch; the engine's
        # kernel B run counts as its local dispatch, as in the JAX package
        assert moved == {("ffd_solve_fused", "cuda"): 1, ("ffd_solve_fused", "plain"): 0,
                         ("disrupt_repack", "cuda"): 0, ("disrupt_repack", "plain"): 0}
        assert metrics.DISRUPTION_DEVICE_DISPATCHES.value(path="local") - local0 == 1
        assert (ffd_scan.launches - a0, repack.launches - b0) == (1, 1)


class TestSidecarOnTheCard:
    """The port's sidecar serving from the card: its kernels launch behind
    the wire ops, and its decisions equal the in-process card solver's and
    a CPU sidecar's."""

    @pytest.fixture
    def sidecars(self, cuda, tmp_path_factory):
        import tempfile

        from karpenter_tpu_torch.solver import rpc

        d = tempfile.mkdtemp(prefix="kt-")
        out = {"cuda": rpc.SolverServer(path=f"{d}/g.sock").start(),
               "cpu": rpc.SolverServer(path=f"{d}/c.sock", device="cpu").start()}
        assert out["cuda"].device.type == "cuda"
        yield out
        for srv in out.values():
            srv.stop()
            srv._thread.join(timeout=10)

    def test_wire_ticks_equal_in_process(self, sidecars, items):
        from karpenter_tpu_torch.solver import rpc
        from karpenter_tpu_torch.solver.disrupt import DisruptEngine

        pool = NodePool("default")
        pods = workload.synth_pods(np.random.default_rng(5), workload.ZONES, 3_000, 5, 40)
        local = TorchSolver(g_max=128)
        want = decision(local.solve(pool, items, pods))
        out = {}
        for kind, srv in sidecars.items():
            client = rpc.SolverClient(path=srv.path, timeout=120.0)
            try:
                solver = TorchSolver(g_max=128, client=client, breaker=False)
                a0, b0 = ffd_scan.launches, repack.launches
                tick = solver.solve(pool, items, pods)
                spec = workload.rampdown_sweep_spec(tick, np.random.default_rng(11), n_cand=16)
                nodes, sets = workload.sweep_world(spec)
                engine = DisruptEngine(solver=solver)
                verdicts = [repr(v) for v in engine.evaluate(nodes, sets)]
                torch.cuda.synchronize()
                out[kind] = (decision(tick), verdicts, engine.last_dispatch["path"],
                             ffd_scan.launches - a0, repack.launches - b0)
            finally:
                client.close()
        assert out["cuda"][0] == want
        assert out["cuda"][:3] == out["cpu"][:3]
        assert out["cuda"][2] == "wire"
        # the card sidecar launched kernel A for the tick and kernel B for
        # the sweep; the CPU sidecar launched neither
        assert out["cuda"][3:] == (1, 1) and out["cpu"][3:] == (0, 0)

    def test_kernel_error_crosses_as_an_error_frame(self, sidecars, items, monkeypatch):
        from karpenter_tpu_torch.solver import rpc

        def boom(*a, **k):
            raise RuntimeError("launch failed")

        monkeypatch.setattr(ffd_scan, "_launch", boom)
        client = rpc.SolverClient(path=sidecars["cuda"].path, timeout=120.0)
        try:
            catalog = encode.encode_catalog(items)
            pods = workload.synth_pods(np.random.default_rng(5), workload.ZONES, 500, 5, 20)
            classes = encode.group_pods(pods, extra_requirements=NodePool("default").requirements())
            cs = encode.encode_classes(classes, catalog, c_pad=encode.bucket(len(classes), 16))
            with pytest.raises(RuntimeError, match="launch failed"):
                client.solve_classes_compact("boom", catalog, cs, g_max=128)
        finally:
            client.close()


class TestOperatorOnTheCard:
    """The port's Operator and replay with the engines on the card: tick by
    tick equal to the same world with device="cpu"; a corpus digest equal
    to the golden one. Exact."""

    @staticmethod
    def world(device):
        from karpenter_tpu_torch import seeding
        from karpenter_tpu_torch.apis import NodeClaim, Pod, TPUNodeClass
        from karpenter_tpu_torch.cache.ttl import FakeClock
        from karpenter_tpu_torch.controllers.disruption import MIN_NODE_LIFETIME
        from karpenter_tpu_torch.operator import Operator, Options
        from karpenter_tpu_torch.solver.consolidate import ConsolidationEvaluator

        saved = seeding.snapshot()
        solver = TorchSolver(g_max=256, device=device)
        op = Operator(clock=FakeClock(100_000.0), solver=solver,
                      consolidation_evaluator=ConsolidationEvaluator(solver=solver),
                      options=Options(seed=5, tracing=False))
        op.cluster.create(TPUNodeClass("default"))
        op.cluster.create(NodePool("default"))
        ticks = []

        def tick():
            op.tick()
            op.clock.step(3.0)
            ticks.append((
                sorted((c.metadata.name, c.instance_type, c.deleting)
                       for c in op.cluster.list(NodeClaim)),
                sorted((p.metadata.name, p.node_name) for p in op.cluster.list(Pod))))

        try:
            for p in workload.synth_pods(np.random.default_rng(3), workload.ZONES, 2000, salt=3):
                op.cluster.create(p)
            for _ in range(4):
                tick()
            for i, name in enumerate(sorted(p.metadata.name for p in op.cluster.list(Pod))):
                if i % 4:
                    op.cluster.delete(Pod, name)
            op.clock.step(MIN_NODE_LIFETIME + 60)
            for _ in range(3):
                tick()
        finally:
            seeding.restore(saved)
        return ticks

    def test_operator_ticks_match_the_cpu(self, cuda, items):
        a0, b0 = ffd_scan.launches, repack.launches
        got = self.world(cuda)
        assert ffd_scan.launches > a0 and repack.launches > b0
        assert got == self.world("cpu")

    def test_corpus_digest_on_the_card(self, cuda):
        import json
        import os

        from karpenter_tpu_torch.sim.replay import replay
        from karpenter_tpu_torch.sim.trace import read_trace

        golden_dir = os.path.join(os.path.dirname(__file__), "golden", "scenarios")
        with open(os.path.join(golden_dir, "digests.json")) as f:
            golden = json.load(f)
        events = read_trace(os.path.join(golden_dir, "diurnal-consolidation.jsonl"))
        seed = next(int(e["seed"]) for e in events if e.get("ev") == "header")
        b0 = repack.launches
        res = replay(events, backend="host", seed=seed)
        assert res.digest == golden["diurnal-consolidation"]
        assert repack.launches > b0
