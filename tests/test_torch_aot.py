"""The cold-start layer of the port (solver/aot.py, solver/kernels/build.py)
against the JAX package's (karpenter_tpu/solver/aot.py), on the CPU.

Modelled on tests/test_aot.py:

- keys and layout: `exec_key` stability, the fingerprint pinning the
  runtime, `sweep_stale` keeping the current version, `resolve_root`
  precedence, the duty clamp;
- with `device="cpu"` and AOT enabled and drained (the armed entries are
  the plain functions bound to their statics), `TorchSolver.solve` on
  tick 1 and on tick 2 over existing nodes, and `.schedule` on the device
  route, synchronous and pipelined: `decision_sig`, `last_route` and
  `last_quality` equal to `TPUSolver` with `enable_aot()` drained, and to
  the port without AOT; every tick served by armed dispatches;
- the coverage gauge reads 1.0 per planned entry and `describe_aot()` has
  the JAX document's keys;
- the store: a corrupt library is counted and unlinked, a wrong
  fingerprint rejected;
- the rungs: a failpoint-forced replay rejection is disarmed and counted
  once, a failed capture is skipped and counted, decisions identical;
- the sync witness's `aot_phase()` exemption, `/debug/aot` in the port's
  health server;
- the pinned staging of a tick's uploads (the sync-free repair): the
  staged bytes equal the pageable path's, and each pinned buffer stays
  held until the tick's fetch has returned.

Tolerance: exact, except the bound and the gap in `last_quality`
against the JAX package (rel=1e-6 plus one unit of the 6th decimal, as
tests/test_torch_quality.py).
"""
import json
import os
import urllib.request

import numpy as np
import pytest

import jax  # noqa: F401  -- both frameworks in one process; data crosses as plain objects
import torch

from karpenter_tpu.apis import NodePool as JNodePool
from karpenter_tpu.apis import Pod as JPod
from karpenter_tpu.solver import aot as jaot
from karpenter_tpu.solver.service import TPUSolver
from karpenter_tpu_torch import failpoints, metrics, workload
from karpenter_tpu_torch import tracing as ttracing
from karpenter_tpu_torch.analysis import sync_witness
from karpenter_tpu_torch.apis import NodePool as TNodePool
from karpenter_tpu_torch.apis import Pod as TPod
from karpenter_tpu_torch.operator import health as thealth
from karpenter_tpu_torch.solver import aot, encode, ffd
from karpenter_tpu_torch.solver.kernels import build
from karpenter_tpu_torch.solver.service import TorchSolver
from karpenter_tpu_torch.utils import enable_compilation_cache
from tests.test_packing import catalog_items  # noqa: F401
from tests.test_torch_catalog import (  # noqa: F401
    decision_sig, jax_nodes, node_specs, port_items, port_nodes,
)
from tests.test_torch_oracle import build as build_world, fuzz_spec, small_items  # noqa: F401
from tests.test_torch_quality import assert_quality_equal, both_pods
from tests.test_torch_schedule import ROUTE_WORLDS

# small tensors: one intra-op thread per test worker (several workers share the cores)
torch.set_num_threads(1)

G = 64
PADS = (16, 32)


@pytest.fixture(autouse=True)
def _own_store(monkeypatch):
    """The store's root is process state: every test leaves it as found."""
    monkeypatch.setattr(build, "_store_dir", build._store_dir)


# -- keys and layout -----------------------------------------------------------------


class TestKeysAndLayout:
    def test_exec_key_stability(self):
        args = (np.zeros((4, 8), np.float32), np.zeros((4,), np.int32))
        statics = {"g_max": 64, "objective": "price"}
        k1 = aot.exec_key("ffd_solve_fused", statics, args, "fp")
        assert k1 == aot.exec_key("ffd_solve_fused", dict(statics), tuple(args), "fp")
        # every key component moves the key
        assert k1 != aot.exec_key("other_entry", statics, args, "fp")
        assert k1 != aot.exec_key("ffd_solve_fused", {**statics, "g_max": 128}, args, "fp")
        assert k1 != aot.exec_key(
            "ffd_solve_fused", statics, (np.zeros((8, 8), np.float32), args[1]), "fp")
        assert k1 != aot.exec_key("ffd_solve_fused", statics, args, "fp2")
        # the same formula over numpy and over the NamedTuples of tensors
        assert len(k1) == 32 and k1 == jaot.exec_key("ffd_solve_fused", statics, args, "fp")

    def test_exec_key_reads_through_named_tuples(self, port_items):  # noqa: F811
        solver = TorchSolver(device="cpu", g_max=G)
        entry = solver._catalog(port_items)
        inp = ffd.make_inputs_staged(entry.staged, encode.encode_classes(
            [], entry.tensors, c_pad=16), packed_masks=True)
        inp2 = ffd.make_inputs_staged(entry.staged, encode.encode_classes(
            [], entry.tensors, c_pad=32), packed_masks=True)
        key = aot.exec_key("ffd_solve_fused", {}, (inp,), "fp")
        assert key == aot.exec_key("ffd_solve_fused", {}, (inp._replace(req=inp.req + 1),), "fp")
        assert key != aot.exec_key("ffd_solve_fused", {}, (inp2,), "fp")
        leaves, spec = aot._flatten((inp, (inp.req, [inp.count])))
        assert len(leaves) == len(inp) + 2
        back = aot._unflatten(spec, leaves)
        assert type(back[0]) is ffd.SolveInputs and back[1][1][0] is inp.count

    def test_fingerprint_pins_runtime(self, monkeypatch):
        fp = build.fingerprint()
        assert fp.startswith("torch") and "-cuda" in fp and "-nvcc" in fp and "-flags" in fp
        assert torch.__version__.replace("+", "_") in fp
        # this host has no card and no nvcc
        assert "nocuda" in fp and "nvccnone" in fp
        # filesystem-safe: used verbatim as a directory name
        assert "/" not in fp and " " not in fp
        # the flags are part of it
        monkeypatch.setattr(build, "_fingerprint", None)
        monkeypatch.setattr(build, "NVCC_FLAGS", build.NVCC_FLAGS + ("-lineinfo",))
        assert build.fingerprint() != fp

    def test_sweep_stale_keeps_current(self, tmp_path):
        root = str(tmp_path / "cache")
        fp = build.fingerprint()
        for name in (fp, "torch0.0.0-stale-a", "torch0.0.0-stale-b"):
            os.makedirs(os.path.join(root, name))
        # loose files at the root are inert, never swept
        open(os.path.join(root, "legacy.so"), "wb").close()
        before = metrics.AOT_SWEPT_DIRS.value()
        home = aot.prepare_cache(root)
        assert home == os.path.join(root, fp)
        assert sorted(os.listdir(root)) == sorted([fp, "legacy.so"])
        assert metrics.AOT_SWEPT_DIRS.value() - before == 2
        assert build.store_dir() == build.Path(home)

    def test_resolve_root_precedence(self, monkeypatch):
        monkeypatch.setenv(aot.CACHE_ENV, "/env/cache")
        assert aot.resolve_root("/explicit") == "/explicit"
        assert aot.resolve_root() == "/env/cache"
        monkeypatch.delenv(aot.CACHE_ENV)
        assert aot.resolve_root() == str(build.BUILD_DIR)
        assert aot.CACHE_ENV == jaot.CACHE_ENV and aot.AOT_ENV == jaot.AOT_ENV
        assert aot.DUTY_ENV == jaot.DUTY_ENV

    def test_duty_clamped(self, monkeypatch):
        solver = TorchSolver(device="cpu", g_max=16)
        assert aot.AotManager(solver, duty=0.0).duty == 0.005
        assert aot.AotManager(solver, duty=7.0).duty == 1.0
        monkeypatch.setenv(aot.DUTY_ENV, "0.25")
        assert aot.AotManager(solver, duty=0.05).duty == 0.25

    def test_unwritable_root_never_aborts_startup(self, tmp_path):
        blocker = tmp_path / "file"
        blocker.write_text("x")
        assert enable_compilation_cache(str(blocker / "root")) is None
        home = enable_compilation_cache(str(tmp_path / "root"))
        assert home is not None and os.path.isdir(home)
        assert metrics.COMPILE_CACHE_BYTES.value() == 0.0


# -- armed decisions against the JAX package ---------------------------------------------


def armed_pair(items_jax, items_port, pads=PADS, tier="ffd"):
    """(TPUSolver, TorchSolver) with AOT enabled and their ladders drained
    over the given catalogs."""
    js, ts = TPUSolver(g_max=G, tier=tier), TorchSolver(device="cpu", g_max=G, tier=tier)
    jm = js.enable_aot(None, serialize=False, duty=1.0, pads=pads)
    tm = ts.enable_aot(None, duty=1.0, pads=pads)
    # staging a catalog starts each ladder in the background
    js._catalog(items_jax)
    ts._catalog(items_port)
    for mgr in (jm, tm):
        assert settled(mgr)
    return js, ts


def settled(mgr, timeout_s: float = 300.0) -> bool:
    """The ladder finished a whole pass and is idle (the JAX manager marks
    itself busy a moment after it takes the pending catalog, so drain()
    alone may return before its pass starts)."""
    import time

    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if mgr.describe()["ladder_runs"] >= 1 and mgr.drain(1.0):
            return True
        time.sleep(0.02)
    return False


def aot_counts():
    return {e: metrics.AOT_DISPATCHES.value(entry=e)
            for e in ("ffd_solve_fused", "fractional_price_bound", "disrupt_repack")}


@pytest.fixture(scope="module")
def pair(catalog_items, port_items):  # noqa: F811
    return armed_pair(catalog_items, port_items)


class TestArmedDecisions:
    def test_tick_1(self, pair, catalog_items, port_items):  # noqa: F811
        js, ts = pair
        jp, tp = both_pods(3)
        c0 = aot_counts()
        want = js.solve(JNodePool("default"), catalog_items, jp)
        got = ts.solve(TNodePool("default"), port_items, tp)
        moved = {e: aot_counts()[e] - c0[e] for e in c0}
        assert moved["ffd_solve_fused"] == 1 and moved["fractional_price_bound"] == 1
        plain = TorchSolver(device="cpu", g_max=G)
        base = plain.solve(TNodePool("default"), port_items, tp)
        assert decision_sig(got) == decision_sig(want) == decision_sig(base)
        assert_quality_equal(ts.last_quality, js.last_quality)
        assert ts.last_quality == plain.last_quality

    def test_tick_2_over_existing_nodes(self, pair, catalog_items, port_items):  # noqa: F811
        """The pre-pass at its floor shape (S=1, C=16, N=16) rides the
        armed repack, then the wave's remainder the armed fused solve."""
        js, ts = pair
        jp, tp = both_pods(7, n=12)
        tick1 = TorchSolver(device="cpu", g_max=G).solve(TNodePool("default"), port_items, tp)
        specs = node_specs(workload.nodes_from_result(tick1))[:16]
        for _name, _labels, _alloc, used, _taints in specs[:6]:
            for k in used:
                used[k] *= 0.5
        jp2 = [JPod(f"w{p.metadata.name}", requests=p.requests) for p in jp]
        tp2 = [TPod(f"w{p.metadata.name}", requests=p.requests) for p in tp]
        c0 = aot_counts()
        want = js.solve(JNodePool("default"), catalog_items, jp2, existing_nodes=jax_nodes(specs))
        got = ts.solve(TNodePool("default"), port_items, tp2, existing_nodes=port_nodes(specs))
        assert aot_counts()["disrupt_repack"] - c0["disrupt_repack"] == 1
        plain = TorchSolver(device="cpu", g_max=G)
        base = plain.solve(TNodePool("default"), port_items, tp2, existing_nodes=port_nodes(specs))
        assert decision_sig(got) == decision_sig(want) == decision_sig(base)
        assert got.existing_assignments
        assert ts.last_quality == plain.last_quality
        assert_quality_equal(ts.last_quality, js.last_quality)

    def test_seams_count_the_armed_rung(self, pair, port_items):  # noqa: F811
        """Through the device engine, an armed tick's fused solve and
        pre-pass repack count impl="aot", and the spans note all three
        seams' replays (the bound is noted only), as armed_miss reads."""
        _, ts = pair
        _, tp = both_pods(7, n=12)
        tick1 = TorchSolver(device="cpu", g_max=G).solve(TNodePool("default"), port_items, tp)
        specs = node_specs(workload.nodes_from_result(tick1))[:16]
        for _name, _labels, _alloc, used, _taints in specs[:6]:
            for k in used:
                used[k] *= 0.5
        tp2 = [TPod(f"a{p.metadata.name}", requests=p.requests) for p in tp]
        counted = ("ffd_solve_fused", "disrupt_repack")
        d0 = {e: metrics.SOLVER_KERNEL_DISPATCHES.value(entry=e, impl="aot") for e in counted}
        with ttracing.trace("tick", force=True) as root:
            ts.solve(TNodePool("default"), port_items, tp2, existing_nodes=port_nodes(specs))
        for e in counted:
            assert metrics.SOLVER_KERNEL_DISPATCHES.value(entry=e, impl="aot") - d0[e] == 1, e
        notes, stack = {}, [root]
        while stack:
            sp = stack.pop()
            notes.update(sp.attributes.get("dispatch", {}))
            stack.extend(sp.children)
        assert notes == {"disrupt_repack": "aot", "ffd_solve_fused": "aot",
                         "fractional_price_bound": "aot"}

    @pytest.mark.parametrize("pipelined", [False, True])
    def test_schedule_device_route(self, small_items, pipelined):  # noqa: F811
        kw = dict(ROUTE_WORLDS["device"])
        spec = fuzz_spec(kw.pop("seed"), **kw)
        j, t = build_world("jax", spec, small_items), build_world("torch", spec, small_items)
        js, ts = armed_pair(small_items["jax"], small_items["torch"])
        c0 = aot_counts()
        want = js.schedule(j.scheduler(), list(j.pods))
        if pipelined:
            got = ts.schedule_finish(ts.schedule_begin(t.scheduler(), list(t.pods)))
        else:
            got = ts.schedule(t.scheduler(), list(t.pods))
        assert aot_counts()["ffd_solve_fused"] - c0["ffd_solve_fused"] == 1
        t2 = build_world("torch", spec, small_items)
        plain = TorchSolver(device="cpu", g_max=G)
        base = plain.schedule(t2.scheduler(), list(t2.pods))
        assert decision_sig(got) == decision_sig(want) == decision_sig(base)
        assert ts.last_route == js.last_route == plain.last_route
        assert js.last_route["path"] == "device"
        assert_quality_equal(ts.last_quality, js.last_quality)
        assert ts.last_quality == plain.last_quality

    def test_coverage_gauge_full(self, pair):
        js, ts = pair
        for e in ts.describe_aot()["entries"]:
            assert metrics.AOT_PRECOMPILED_FRACTION.value(entry=e) == 1.0

    def test_describe_has_the_jax_keys(self, pair):
        js, ts = pair
        want, got = js.describe_aot(), ts.describe_aot()
        assert set(want) <= set(got)
        assert sorted(got["entries"]) == sorted(want["entries"])
        for e, row in want["entries"].items():
            assert sorted(got["entries"][e]) == sorted(row)
            assert got["entries"][e]["planned"] == row["planned"]
            assert got["entries"][e]["armed"] == row["armed"]
            assert got["entries"][e]["fraction"] == 1.0
        assert got["fingerprint"] == build.fingerprint() and got["compile_failures"] == 0
        # no mesh engine, no mesh tasks (the JAX manager's plan without one)
        assert got["armed_form"] == "plain closure" and got["mesh_tasks"] == []

    def test_convex_tier_plans_the_relaxation(self, port_items):  # noqa: F811
        ts = TorchSolver(device="cpu", g_max=G, tier="convex")
        mgr = ts.enable_aot(None, duty=1.0, pads=(16,))
        plan = mgr.build_plan(ts._catalog(port_items))
        assert mgr.drain(300)
        tiers = [(t.tier, t.entry) for t in plan]
        assert tiers == sorted(tiers, key=lambda x: x[0])
        assert (2, "convex_relax") in tiers and tiers[:2] == [
            (0, "ffd_solve_fused"), (0, "fractional_price_bound")]
        assert [e for tier, e in tiers if tier == 3] == [
            "disrupt_repack", "disrupt_repack", "disrupt_replace"]
        _, tp = both_pods(4, n=12)
        c0 = metrics.AOT_DISPATCHES.value(entry="convex_relax")
        got = ts.solve(TNodePool("default"), port_items, tp)
        assert metrics.AOT_DISPATCHES.value(entry="convex_relax") == c0 + 1
        plain = TorchSolver(device="cpu", g_max=G, tier="convex")
        assert decision_sig(got) == decision_sig(plain.solve(TNodePool("default"), port_items, tp))
        assert ts.last_convex == plain.last_convex


# -- the store --------------------------------------------------------------------------


class TestMeshTasks:
    def test_current_layout_warmed_shrunk_layouts_listed(self, port_items):  # noqa: F811
        """With a mesh engine the plan holds the current layout's sharded
        fused solve and bound (tier 0) and lists the ladder's shrunk
        layouts (tier 1) without calling them; a device loss re-plans
        nothing until the next catalog."""
        from karpenter_tpu_torch.fleet import MeshSolveEngine
        from karpenter_tpu_torch.parallel.mesh import make_mesh

        engine = MeshSolveEngine(make_mesh(8, devices=[torch.device("cpu")] * 8))
        ts = TorchSolver(g_max=G, mesh=engine)
        mgr = ts.enable_aot(None, duty=1.0, pads=(16,))
        plan = mgr.build_plan(ts._catalog(port_items))
        assert mgr.drain(300)
        assert [(t.tier, t.entry) for t in plan if t.entry.startswith("mesh_")] == [
            (0, "mesh_fused"), (0, "mesh_bound")]
        doc = ts.describe_aot()["mesh_tasks"]
        assert [(d["tier"], d["layout"], d["shards"]) for d in doc] == [
            (0, "full", 8), (1, "shrunk", 4), (1, "shrunk", 2)]
        assert doc[0]["tasks"] == ["mesh full 8 fused c16", "mesh full 8 bound c16"]
        assert doc[1]["tasks"] == doc[2]["tasks"] == []
        assert ts.describe_aot()["compile_failures"] == 0
        mgr.stop(timeout_s=60.0)


def _plant(store: str, name: str, fingerprint: str, body: bytes = b"\x7fELF garbage"):
    build.use_store(store)
    path = build._library_path(name)
    path.write_bytes(body)
    build._manifest(path).write_text(json.dumps(
        {"v": build._MANIFEST_VERSION, "fingerprint": fingerprint, "name": name}))
    return path


class TestStore:
    def test_corrupt_library_counted_and_unlinked(self, tmp_path, monkeypatch):
        monkeypatch.setattr(build, "_LIBS", {})
        path = _plant(str(tmp_path), "ffd_scan", build.fingerprint())
        before = metrics.AOT_FALLBACKS.value(reason="deserialize")
        assert build.load_store(("ffd_scan",)) == (0, 1)
        assert metrics.AOT_FALLBACKS.value(reason="deserialize") - before == 1
        assert not path.exists() and not build._manifest(path).exists()
        assert build._LIBS == {}

    def test_wrong_fingerprint_rejected(self, tmp_path, monkeypatch):
        monkeypatch.setattr(build, "_LIBS", {})
        path = _plant(str(tmp_path), "disrupt_repack", "other")
        with pytest.raises(build.LibraryRejected, match="fingerprint"):
            build.load_one("disrupt_repack", path)
        path.with_name(path.name + ".json").unlink()
        with pytest.raises(build.LibraryRejected, match="manifest"):
            build.load_one("disrupt_repack", path)

    def test_manager_loads_the_store_at_enable(self, tmp_path, monkeypatch):
        monkeypatch.setattr(build, "_LIBS", {})
        _plant(str(tmp_path), "ffd_scan", build.fingerprint())
        ts = TorchSolver(device="cpu", g_max=G)
        ts.enable_aot(str(tmp_path), duty=1.0)
        doc = ts.describe_aot()
        assert doc["exec_dir"] == str(tmp_path) and doc["load_failures"] == 1
        assert doc["loaded"] == 0 and doc["store"] == {"artifacts": 0, "bytes": 0}

    def test_store_stats_count_libraries(self, tmp_path):
        (tmp_path / "a-0.so").write_bytes(b"12345")
        (tmp_path / "a-0.so.json").write_text("{}")
        assert build.store_stats(tmp_path) == {"artifacts": 1, "bytes": 5}


# -- the rungs ------------------------------------------------------------------------


class TestRungs:
    def test_failpoint_rejection_is_disarmed_and_counted_once(self, catalog_items, port_items):  # noqa: F811
        js, ts = armed_pair(catalog_items, port_items, pads=(32,))
        jp, tp = both_pods(5)
        armed0 = ts.describe_aot()["armed"]
        f0 = metrics.AOT_FALLBACKS.value(reason="dispatch")
        d0 = metrics.SOLVER_KERNEL_DISPATCHES.value(entry="ffd_solve_fused", impl="plain")
        failpoints.FAILPOINTS.arm_spec("aot.dispatch=error(RuntimeError):times=1")
        try:
            got = ts.solve(TNodePool("default"), port_items, tp)
        finally:
            failpoints.FAILPOINTS.reset()
        assert metrics.AOT_FALLBACKS.value(reason="dispatch") - f0 == 1
        assert ts.describe_aot()["armed"] == armed0 - 1
        # the rejected fused solve ran the ordinary dispatch
        assert metrics.SOLVER_KERNEL_DISPATCHES.value(
            entry="ffd_solve_fused", impl="plain") - d0 == 1
        want = js.solve(JNodePool("default"), catalog_items, jp)
        assert decision_sig(got) == decision_sig(want)
        assert_quality_equal(ts.last_quality, js.last_quality)
        # disarmed, not retried: the next tick takes the ordinary dispatch
        again = ts.solve(TNodePool("default"), port_items, tp)
        assert metrics.AOT_FALLBACKS.value(reason="dispatch") - f0 == 1
        assert decision_sig(again) == decision_sig(got)

    def test_failed_capture_is_skipped_and_counted(self, port_items, monkeypatch):  # noqa: F811
        real = aot._entry_fn

        def entry_fn(modname, fn_name):
            if fn_name == "fractional_price_bound":
                raise RuntimeError("injected capture failure")
            return real(modname, fn_name)

        monkeypatch.setattr(aot, "_entry_fn", entry_fn)
        ts = TorchSolver(device="cpu", g_max=G)
        mgr = ts.enable_aot(None, duty=1.0, pads=(32,))
        f0 = metrics.AOT_FALLBACKS.value(reason="compile")
        mgr.run_plan(ts._catalog(port_items), throttle=False)
        assert mgr.drain(300)
        doc = ts.describe_aot()
        assert metrics.AOT_FALLBACKS.value(reason="compile") - f0 == doc["compile_failures"] >= 1
        assert doc["entries"]["ffd_solve_fused"]["armed"] == 1
        assert doc["entries"]["fractional_price_bound"]["armed"] == 0
        _, tp = both_pods(6)
        got = ts.solve(TNodePool("default"), port_items, tp)
        plain = TorchSolver(device="cpu", g_max=G)
        assert decision_sig(got) == decision_sig(plain.solve(TNodePool("default"), port_items, tp))
        assert ts.last_quality == plain.last_quality

    def test_wire_mode_has_no_ladder(self):
        ts = TorchSolver(device="cpu", g_max=G, client=object(), breaker=False)
        assert ts.enable_aot(None) is None and ts.describe_aot() == {}


# -- the witness and the endpoint --------------------------------------------------------


class TestWitnessAndEndpoint:
    def test_aot_phase_exemption(self):
        import warnings

        sync_witness.reset()
        with sync_witness.hot("tick"):
            with sync_witness.aot_phase():
                warnings.warn(f"{sync_witness.SYNC_MESSAGE} (ladder)", UserWarning)
            warnings.warn(f"{sync_witness.SYNC_MESSAGE} (tick)", UserWarning)
        st = sync_witness.stats()
        sync_witness.reset()
        assert st["aot_exempt"] == 1
        assert sum(st["unsanctioned"].values()) == 1

    def test_debug_endpoint_registered(self):
        from karpenter_tpu.operator import health as jhealth

        assert "/debug/aot" in thealth.DEBUG_ENDPOINTS
        assert sorted(thealth.DEBUG_ENDPOINTS) == sorted(jhealth.DEBUG_ENDPOINTS)

    def test_debug_aot_serves_the_document(self, port_items):  # noqa: F811
        ts = TorchSolver(device="cpu", g_max=G)
        ts.enable_aot(None, duty=1.0, pads=(16,))
        assert ts._aot.drain(300)
        srv = thealth.HealthServer(port=0).start()
        try:
            srv.aot_info = ts.describe_aot
            port = srv._server.server_address[1]
            with urllib.request.urlopen(f"http://127.0.0.1:{port}/debug/aot", timeout=10) as r:
                doc = json.loads(r.read())
        finally:
            srv.stop()
        assert set(doc) == set(ts.describe_aot())
        assert doc["device"] == "cpu"


# -- pinned staging (the sync-free uploads) --------------------------------------------------


class TestPinnedStaging:
    @pytest.fixture
    def pinned(self, monkeypatch):
        """The card's staging path on the CPU: every upload "pins" into a
        recorded copy (the CPU has no page-locked memory)."""
        pins = []

        def pin(t):
            out = t.clone()
            pins.append(out)
            return out

        monkeypatch.setattr(ffd, "_pinned_path", lambda device: True)
        monkeypatch.setattr(ffd, "_pin", pin)
        return pins

    def test_staged_bytes_equal_the_pageable_upload(self, port_items, pinned):  # noqa: F811
        entry = TorchSolver(device="cpu", g_max=G)._catalog(port_items)
        _, tp = both_pods(2)
        cs = encode.encode_classes(encode.group_pods(tp), entry.tensors, c_pad=32)
        hold = []
        got = ffd.make_inputs_staged(entry.staged, cs, packed_masks=True, hold=hold)
        fields = ffd._CLASS_FIELDS
        assert len(hold) == len(fields) and all(any(h is p for p in pinned) for h in hold)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(ffd, "_pinned_path", lambda device: False)
            want = ffd.make_inputs_staged(entry.staged, cs, packed_masks=True)
        for name in fields:
            a, b = getattr(got, name), getattr(want, name)
            assert a.dtype == b.dtype and torch.equal(a, b), name
        for h, name in zip(hold, fields):
            assert h.numpy().tobytes() == getattr(want, name).numpy().tobytes()

    def test_pinned_buffers_outlive_their_copies(self, port_items, pinned, monkeypatch):  # noqa: F811
        ts = TorchSolver(device="cpu", g_max=G)
        _, tp = both_pods(2)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(ffd, "_pinned_path", lambda device: False)
            want = TorchSolver(device="cpu", g_max=G).solve(TNodePool("default"), port_items, tp)
        pending = ts.solve_begin(TNodePool("default"), port_items, tp)
        # the class uploads are held while the solve is in flight
        assert len(pending.uploads) == len(ffd._CLASS_FIELDS)
        held_at_fetch = []
        fetch = ffd.fetch_fused

        def fetch_watch(buf):
            held_at_fetch.append(len(pending.uploads))
            return fetch(buf)

        fin = ts._finish_quality

        def finish_watch(*a, **k):
            held_at_fetch.append(len(pending.uploads))   # the bound's `placed` too
            return fin(*a, **k)

        monkeypatch.setattr(ffd, "fetch_fused", fetch_watch)
        monkeypatch.setattr(ts, "_finish_quality", finish_watch)
        got = ts.solve_finish(pending)
        assert held_at_fetch == [len(ffd._CLASS_FIELDS), len(ffd._CLASS_FIELDS) + 1]
        assert pending.uploads is None
        assert decision_sig(got) == decision_sig(want)


# -- concurrency ----------------------------------------------------------------------


class TestConcurrency:
    def test_dispatches_beside_a_replanning_ladder(self, port_items):  # noqa: F811
        """Eight threads dispatch the armed fused solve while the ladder
        re-plans over two catalogs in turn, under a short switch interval:
        every armed result equals the ordinary dispatch, every hit is
        counted once, coverage never passes 1, the ladder drains."""
        import sys
        import threading

        ts = TorchSolver(device="cpu", g_max=G)
        mgr = ts.enable_aot(None, duty=1.0, pads=(16,))
        entries = []
        for items in (port_items, port_items[::4]):
            # the latest catalog wins: drain each before staging the next
            entries.append(ts._catalog(items))
            assert mgr.drain(300)
        entry = entries[0]
        _, tp = both_pods(8, n=12)
        cs = encode.encode_classes(encode.group_pods(tp), entry.tensors, c_pad=16)
        inp = ffd.make_inputs_staged(entry.staged, cs, packed_masks=True)
        fstat = dict(g_max=G, nnz_max=ffd.nnz_budget(16, G), word_offsets=entry.offsets,
                     words=entry.words, objective="price")
        want = ffd.ffd_solve_fused(inp, **fstat)
        hits, bad, errors = [0], [0], []
        lock = threading.Lock()

        def worker():
            try:
                for _ in range(4):
                    hit, got = mgr.try_call("ffd_solve_fused", (inp,), fstat)
                    with lock:
                        hits[0] += hit
                        bad[0] += hit and not torch.equal(got, want)
            except Exception as e:  # noqa: BLE001 -- reported below
                errors.append(e)

        d0 = metrics.AOT_DISPATCHES.value(entry="ffd_solve_fused")
        old = sys.getswitchinterval()
        sys.setswitchinterval(1e-6)
        try:
            threads = [threading.Thread(target=worker) for _ in range(8)]
            for t in threads:
                t.start()
            for i in range(4):
                mgr.on_catalog(entries[i % 2])
                doc = mgr.describe()
                assert all(r["fraction"] is None or r["fraction"] <= 1.0
                           for r in doc["entries"].values())
            for t in threads:
                t.join(120)
                assert not t.is_alive()
        finally:
            sys.setswitchinterval(old)
        assert not errors and bad[0] == 0
        assert hits[0] == 32 and metrics.AOT_DISPATCHES.value(entry="ffd_solve_fused") - d0 == 32
        assert mgr.drain(300) and mgr.describe()["compile_failures"] == 0
