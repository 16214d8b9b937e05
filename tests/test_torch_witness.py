"""The port's runtime witnesses (karpenter_tpu_torch/analysis/) on the CPU.

- the lock-order witness finds an inversion between two port locks and
  raises under strict; it lives beside the JAX package's witness in one
  process, in either install order, each wrapping only its own package's
  locks (module-level ones included);
- the escape witness counts a ladder-class exception swallowed at an
  unsanctioned port site;
- the torch witness mirrors tests/test_jax_witness.py's lifecycle: a
  library build or load inside hot() is a violation, a graph capture
  inside aot_phase() is not, one outside it is; the sync half books an
  unsanctioned sync. Driven on the CPU through patched hooks (a fake
  ctypes load, a fake nvcc, a fake torch.cuda), the way the sync
  witness's tests patch Tensor.cpu.

Every test that injects a violation saves and restores the witness state,
so nothing it records reaches a session gate.
"""
import importlib.util
import os
import subprocess
import sys
import types
import warnings

import pytest
import torch

from karpenter_tpu_torch.analysis import errwitness, sync_witness, torch_witness, witness
from karpenter_tpu_torch.analysis.checkers import errflow

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_py(code: str, timeout: int = 240) -> subprocess.CompletedProcess:
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=timeout)


# -- the lock-order witness -------------------------------------------------------------


@pytest.fixture()
def lockw():
    st = witness._state
    with st.guard:
        saved = (dict(st.edges), list(st.inversions), set(st.seen_pairs), st.strict)
    witness.reset()
    yield witness
    with st.guard:
        st.edges.clear(); st.edges.update(saved[0])
        st.inversions[:] = saved[1]
        st.seen_pairs.clear(); st.seen_pairs.update(saved[2])
        st.strict = saved[3]


def mklock(site, kind="Lock"):
    real = witness._REAL_LOCK() if kind == "Lock" else witness._REAL_RLOCK()
    return witness._WitnessLock(real, site, kind)


class TestLockWitness:
    def test_inversion_between_two_port_locks_is_found(self, lockw):
        a = mklock("karpenter_tpu_torch/solver/aot.py:290")
        b = mklock("karpenter_tpu_torch/solver/service.py:282", kind="RLock")
        before = lockw._inversions_metric().value()
        with a, b:
            pass
        assert lockw.inversions() == []
        with b, a:
            pass
        invs = lockw.inversions()
        assert len(invs) == 1
        assert invs[0].second == "karpenter_tpu_torch/solver/aot.py:290"
        assert "opposite order was observed earlier" in invs[0].render()
        assert lockw._inversions_metric().value() == before + 1

    def test_strict_raises_at_the_inverted_acquire(self, lockw):
        a = mklock("karpenter_tpu_torch/a.py:1")
        b = mklock("karpenter_tpu_torch/b.py:2")
        with a, b:
            pass
        lockw._state.strict = True
        with pytest.raises(lockw.LockOrderInversion):
            with b, a:
                pass
        assert not b.locked()

    def test_real_locks_are_the_interpreters(self):
        import _thread

        assert witness._REAL_LOCK is _thread.allocate_lock
        assert witness._REAL_RLOCK is _thread.RLock

    def test_try_acquire_and_sibling_instances_are_quiet(self, lockw):
        a = mklock("karpenter_tpu_torch/a.py:1")
        b = mklock("karpenter_tpu_torch/b.py:2")
        with a, b:
            pass
        with b:
            assert a.acquire(blocking=False)
            a.release()
        c1, c2 = mklock("karpenter_tpu_torch/c.py:3"), mklock("karpenter_tpu_torch/c.py:3")
        with c1, c2:
            pass
        with c2, c1:
            pass
        assert lockw.inversions() == []


# each case: import and install the witnesses in one order (each one is
# imported right before its install, as a session does), then import
# modules that allocate locks at import time; every lock must be wrapped
# by its own package's witness, and each report must hold only its own
# sites
COEXIST = r'''
import importlib, sys, threading
order = sys.argv[1].split(",")
mods = {}
for name in order:
    mods[name] = importlib.import_module(
        "karpenter_tpu.analysis.witness" if name == "jax" else "karpenter_tpu_torch.analysis.witness")
    mods[name].install()
jw, tw = mods["jax"], mods["torch"]
from karpenter_tpu_torch.solver.kernels import build          # module-level RLock
from karpenter_tpu_torch import metrics as tm                  # Registry lock
from karpenter_tpu import metrics as jm
assert isinstance(build._lock, tw._WitnessLock), type(build._lock)
assert build._lock.site.startswith("karpenter_tpu_torch/solver/kernels/build.py:"), build._lock.site
assert build._lock.kind == "RLock"
assert isinstance(tm.REGISTRY._lock, tw._WitnessLock)
assert isinstance(jm.REGISTRY._lock, jw._WitnessLock), type(jm.REGISTRY._lock)
assert jm.REGISTRY._lock.site.startswith("karpenter_tpu/metrics.py:"), jm.REGISTRY._lock.site
plain = threading.Lock()                                       # this frame: neither package's
assert not isinstance(plain, (tw._WitnessLock, jw._WitnessLock))
cond = threading.Condition()                                   # stdlib: its RLock stays plain
assert not isinstance(cond._lock, (tw._WitnessLock, jw._WitnessLock))
# a port inversion reaches the port's report only
a, b = tm.Counter("x_a_total", "a")._lock, tm.Counter("x_b_total", "b")._lock
with a:
    with tm.REGISTRY._lock:
        pass
with tm.REGISTRY._lock:
    with a:
        pass
assert len(tw.inversions()) == 1 and jw.inversions() == []
assert "karpenter_tpu_torch/" in tw.report() and "karpenter_tpu/metrics" not in tw.report()
print("ok", tw.wrapped_count(), jw.wrapped_count())
'''


@pytest.mark.parametrize("order", ["jax,torch", "torch,jax"])
def test_port_and_jax_lock_witnesses_coexist(order):
    r = run_py(COEXIST.replace("sys.argv[1]", repr(order)))
    assert r.returncode == 0, r.stdout + r.stderr
    assert r.stdout.startswith("ok")


def test_module_level_lock_is_wrapped_and_uninstall_restores():
    code = ("import threading\n"
            "from karpenter_tpu_torch.analysis import witness as tw\n"
            "real = threading.Lock\n"
            "tw.install()\n"
            "from karpenter_tpu_torch.solver import aot\n"
            "from karpenter_tpu_torch.solver.kernels import build\n"
            "assert isinstance(build._lock, tw._WitnessLock)\n"
            "assert tw.wrapped_count() >= 1\n"
            "tw.uninstall()\n"
            "assert threading.Lock is real\n"
            "print('ok')\n")
    r = run_py(code)
    assert r.returncode == 0, r.stdout + r.stderr


# -- the escape witness ------------------------------------------------------------------


SCRATCH_SRC = '''
from karpenter_tpu_torch.solver.shm import ShmError
from karpenter_tpu_torch.failpoints import OperatorCrashed

def boom():
    raise ShmError("ring gone")

def ladder_swallower():
    try:
        boom()
    except ShmError:
        pass

def reraiser():
    try:
        boom()
    except ShmError:
        raise

def crash_swallower():
    try:
        raise OperatorCrashed("dead")
    except BaseException:
        pass
'''


@pytest.fixture()
def errw(monkeypatch, tmp_path):
    """The port's escape witness over a scratch package tree, its state
    saved and restored; a tracer already set on this thread (the JAX
    package's witness, armed by one of its ladder exceptions) is parked
    for the test so the port's witness can arm."""
    st = errwitness._state
    errwitness.flush()
    with st.guard:
        saved = (dict(st.records), list(st.swallows))
    errwitness.reset()
    was_installed = errwitness.installed()
    if not was_installed:
        errwitness.install()
    prior_trace = sys.gettrace()
    sys.settrace(None)
    pkg = tmp_path / "karpenter_tpu_torch"
    pkg.mkdir()
    (pkg / "scratch.py").write_text(SCRATCH_SRC)
    spec = importlib.util.spec_from_file_location("torch_errwitness_scratch", pkg / "scratch.py")
    scratch = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(scratch)
    monkeypatch.setattr(errwitness, "_REPO_PREFIX", str(tmp_path) + "/")
    monkeypatch.setattr(errwitness, "_SKIP_PREFIX", str(pkg / "analysis") + "/")
    yield errwitness, scratch
    errwitness.flush()
    sys.settrace(prior_trace)
    if not was_installed:
        errwitness.uninstall()
    errwitness.reset()
    with st.guard:
        st.records.update(saved[0])
        st.swallows[:] = saved[1]


class TestEscapeWitness:
    def test_unsanctioned_port_swallow_is_counted(self, errw):
        ew, scratch = errw
        site = "karpenter_tpu_torch/scratch.py:ladder_swallower"
        before = ew._swallowed_metric().value(site=site)
        scratch.ladder_swallower()
        ew.flush()
        bad = ew.swallows(unsanctioned_only=True)
        assert any(s.site == site and s.exc_type == "ShmError" for s in bad), ew.report()
        assert ew._swallowed_metric().value(site=site) == before + 1

    def test_crash_swallow_is_caught_and_reraise_is_quiet(self, errw):
        ew, scratch = errw
        with pytest.raises(Exception):
            scratch.reraiser()
        scratch.crash_swallower()
        ew.flush()
        sws = ew.swallows(unsanctioned_only=True)
        assert [s.exc_type for s in sws] == ["OperatorCrashed"], ew.report()

    def test_taps_the_ports_ladder_classes(self, errw):
        from karpenter_tpu_torch.errors.errors import CloudError
        from karpenter_tpu_torch.failpoints import OperatorCrashed
        from karpenter_tpu_torch.solver.rpc import StaleSeqnumError
        from karpenter_tpu_torch.solver.shm import ShmError

        for cls in (CloudError, OperatorCrashed, ShmError, StaleSeqnumError):
            assert getattr(cls.__init__, "_errwitness_tap", False), cls

    def test_sanctioned_sites_are_the_ports_manifests(self):
        errwitness._state.sanctioned = None
        sites = errwitness._sanctioned_sites()
        assert ("karpenter_tpu_torch/solver/service.py", "_finish_remote") in sites
        assert ("karpenter_tpu_torch/sim/replay.py", "do_tick") in sites
        assert ("karpenter_tpu_torch/solver/rpc.py", "handle") in sites
        assert all(rel.startswith("karpenter_tpu_torch/") for rel, _ in sites)
        assert len(sites) == len({(s.rel, s.func) for s in errflow.LADDER_SEAMS}
                                 | set(errflow.SANCTIONED_CRASH_SWALLOWS)
                                 | set(errflow.SANCTIONED_ESCAPE_SITES))


# -- the torch witness ---------------------------------------------------------------------


@pytest.fixture()
def tw():
    """The torch witness installed for one test, its events and the sync
    witness's saved and restored."""
    st = torch_witness._state
    with st.guard:
        saved = (list(st.rebuilds), st.builds_total, st.loads_total, st.captures_total,
                 st.aot_builds, st.aot_captures, st.installed, st.strict)
    sync_saved = sync_witness.stats()
    torch_witness.reset()
    torch_witness.install()
    yield torch_witness
    with st.guard:
        (rebuilds, st.builds_total, st.loads_total, st.captures_total, st.aot_builds,
         st.aot_captures, st.installed, st.strict) = saved
        st.rebuilds[:] = rebuilds
    sync_witness.reset()
    with sync_witness._state.guard:
        sync_witness._state.sanctioned = sync_saved["sanctioned_fetches"]
        sync_witness._state.aot_exempt = sync_saved["aot_exempt"]
        sync_witness._state.unsanctioned.update(sync_saved["unsanctioned"])


@pytest.fixture()
def fake_store(monkeypatch, tmp_path):
    """The library store in a temporary directory, nvcc a no-op and the
    ctypes load a fake: build.build and build.library run end to end."""
    from karpenter_tpu_torch.solver.kernels import build

    monkeypatch.setattr(build, "_store_dir", tmp_path)
    monkeypatch.setattr(build, "_LIBS", {})
    monkeypatch.setattr(build, "BUILD_LOG", {})
    monkeypatch.setattr(build, "nvcc_path", lambda: "true")
    # the fingerprint memoizes nvcc's version: computed under the fake it
    # must not outlive the test
    monkeypatch.setattr(build, "_fingerprint", None)
    monkeypatch.setattr(build, "load_one", lambda name, path: object())
    return build


def fake_cuda():
    """Just enough of torch.cuda for aot.capture on the CPU."""
    import contextlib

    class Stream:
        def __init__(self, *a, **k):
            pass

        def wait_stream(self, other):
            pass

    class Graph:
        def reset(self):
            pass

    return types.SimpleNamespace(
        current_stream=lambda device=None: Stream(), Stream=Stream,
        stream=lambda s: contextlib.nullcontext(), CUDAGraph=Graph,
        device=lambda d: contextlib.nullcontext(),
        graph=lambda g, pool=None, capture_error_mode=None: contextlib.nullcontext())


class TestTorchWitnessLifecycle:
    def test_library_build_in_hot_is_a_violation(self, tw, fake_store):
        metric0 = tw._rebuilds_metric().value()
        with tw.hot("inject"):
            fake_store.build(["ffd_scan"])
        rb = tw.hot_rebuilds()
        assert [(r.kind, r.what, r.label) for r in rb] == [("build", "ffd_scan", "inject")]
        assert "outside the warm-up ladder's aot phase" in rb[0].render()
        assert tw._rebuilds_metric().value() == metric0 + 1
        assert tw.stats()["builds_total"] == 1

    def test_library_load_in_hot_is_a_violation_and_cold_is_quiet(self, tw, fake_store):
        fake_store.library("disrupt_repack")            # warm-up: outside hot, builds + loads
        assert tw.hot_violations() == []
        st = tw.stats()
        assert (st["builds_total"], st["loads_total"]) == (1, 1)
        fake_store._LIBS.clear()
        with tw.hot("tick"):
            fake_store.library("disrupt_repack")        # in the store: a load
        assert [r.kind for r in tw.hot_rebuilds()] == ["load"]

    def test_ladder_work_inside_aot_phase_is_booked_apart(self, tw, fake_store):
        with tw.hot("tick"), tw.aot_phase():
            fake_store.library("ffd_scan")
        assert tw.hot_violations() == []
        assert tw.stats()["aot_builds"] == 2            # the build and the load

    def test_capture_in_aot_phase_is_not_a_violation_outside_it_is(self, tw, monkeypatch):
        from karpenter_tpu_torch.solver import aot

        monkeypatch.setattr(aot, "torch", types.SimpleNamespace(cuda=fake_cuda()))
        x = torch.arange(4, dtype=torch.float32)

        def entry(t):
            return t * 2

        with tw.hot("tick"):
            with tw.aot_phase():
                g = aot.capture(entry, (x,), {})
            assert tw.hot_violations() == []
            aot.capture(entry, (x,), {})
        rb = tw.hot_rebuilds()
        assert [(r.kind, r.what) for r in rb] == [("capture", "entry")]
        assert tw.stats()["captures_total"] == 2 and tw.stats()["aot_captures"] == 1
        assert isinstance(g, aot.GraphExec)

    def test_strict_raises_at_the_build(self, tw, fake_store):
        tw._state.strict = True
        with pytest.raises(tw.TorchWitnessViolation):
            with tw.hot("strict"):
                fake_store.build(["ffd_scan"])

    def test_unsanctioned_sync_in_hot_is_a_violation(self, tw):
        metric0 = tw._transfers_metric().value()
        with tw.hot("tick"):
            warnings.warn(f"{sync_witness.SYNC_MESSAGE} (injected)", UserWarning)
        tr = tw.hot_transfers()
        assert len(tr) == 1 and tr[0].count == 1
        assert tw._transfers_metric().value() == metric0 + 1
        assert "unsanctioned" in tw.report()

    def test_a_sync_under_the_sidecars_compact_op_is_sanctioned(self, tw):
        """Phase `witness`' first card run found one unsanctioned sync: the
        in-process sidecar's warm wire tick fetched its compact reply
        (ffd.fetch_compact under SolverServer._op_solve_compact), a seam
        the JAX manifest sanctions and the port's lacked."""
        rpc_path = os.path.join(REPO, "karpenter_tpu_torch", "solver", "rpc.py")
        ns = {"warn": warnings.warn, "msg": f"{sync_witness.SYNC_MESSAGE} (reply)"}
        exec(compile("def _op_solve_compact():\n    warn(msg, UserWarning)\n", rpc_path, "exec"), ns)
        with tw.hot("wire tick"):
            ns["_op_solve_compact"]()
        assert tw.hot_violations() == []
        assert tw.stats()["sanctioned_fetches"] == 1

    def test_the_ladders_planning_syncs_are_booked_apart(self, tw, monkeypatch):
        """A card run of phase `witness` found five unsanctioned syncs at
        solver/disrupt/kernel.py's operand staging: the ladder's thread
        built its plan (the pre-pass's armed repack operands, five blocking
        pageable copies) outside aot_phase() while a live tick was hot.
        Planning is ladder work: its syncs are booked as aot-exempt."""
        from karpenter_tpu_torch import workload
        from karpenter_tpu_torch.solver.disrupt import kernel as disrupt_kernel
        from karpenter_tpu_torch.solver.service import TorchSolver

        real = disrupt_kernel.repack_from_numpy
        staged = []

        def repack_from_numpy(*a, **k):
            staged.append(1)
            warnings.warn(f"{sync_witness.SYNC_MESSAGE} (pageable copy)", UserWarning)
            return real(*a, **k)

        monkeypatch.setattr(disrupt_kernel, "repack_from_numpy", repack_from_numpy)
        ts = TorchSolver(device="cpu", g_max=64)
        mgr = ts.enable_aot(None, duty=1.0, pads=(16,))
        try:
            with tw.hot("live tick"):
                ts._catalog(workload.build_catalog_items())
                assert mgr.drain(300)
        finally:
            ts.stop_warm_up(60.0)
        assert len(staged) >= 2                 # the plan's operands and the repack task's
        assert tw.hot_violations() == []
        assert tw.stats()["aot_exempt_syncs"] == len(staged)

    def test_cold_syncs_and_nothing_in_hot_are_quiet(self, tw):
        warnings.warn(f"{sync_witness.SYNC_MESSAGE} (cold)", UserWarning)
        with tw.hot("quiet"):
            pass
        assert tw.hot_violations() == []
        assert tw.report().startswith("torch witness: 0 hot-section")

    def test_aot_phase_is_the_sync_witness_marker(self, tw):
        with tw.aot_phase():
            assert getattr(sync_witness._tls, "aot_depth", 0) == 1
        assert sync_witness._tls.aot_depth == 0

    def test_uninstalled_witness_records_nothing(self, tw, fake_store):
        tw.uninstall()
        with tw.hot("off"):
            fake_store.build(["ffd_scan"])
        assert tw.hot_rebuilds() == []


def test_witnesses_import_nothing_heavy():
    code = ("import sys\n"
            "from karpenter_tpu_torch.analysis import witness, errwitness, torch_witness\n"
            "from karpenter_tpu_torch.analysis import pytest_plugin\n"
            "bad = [m for m in ('torch', 'numpy', 'jax', 'karpenter_tpu', "
            "'karpenter_tpu_torch.metrics') if m in sys.modules]\n"
            "sys.exit(1 if bad else 0)\n")
    r = run_py(code)
    assert r.returncode == 0, r.stdout + r.stderr
