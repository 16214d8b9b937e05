"""The port stands alone and never falls back.

- no module of karpenter_tpu_torch/, and not chip_smoke.py, imports jax or
  anything of karpenter_tpu (an AST scan);
- a solve in a fresh interpreter leaves both out of sys.modules;
- without CUDA, TorchSolver() raises instead of moving to the CPU, and
  chip_smoke.py exits non-zero without printing a result;
- a kernel wrapper given a tensor that is neither on the CPU nor on a
  CUDA device raises.
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

import jax  # noqa: F401  -- both frameworks in one process
import pytest
import torch

from karpenter_tpu_torch.solver import service
from karpenter_tpu_torch.solver.kernels import build, disrupt_repack, ffd_scan

# small tensors: one intra-op thread per test worker (several workers share the cores)
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((REPO / "karpenter_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]


def imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def forbidden(module: str) -> bool:
    root = module.split(".")[0]
    return root in ("jax", "jaxlib", "karpenter_tpu")


class TestNoJaxImports:
    def test_scan_covers_the_package(self):
        names = {p.name for p in PORT_FILES}
        assert {"ffd.py", "service.py", "ffd_scan.py", "disrupt_repack.py", "chip_smoke.py",
                "engine.py", "kernel.py", "consolidate.py"} <= names
        rel = {str(p.relative_to(REPO)) for p in PORT_FILES}
        assert {"karpenter_tpu_torch/solver/disrupt/engine.py",
                "karpenter_tpu_torch/solver/disrupt/kernel.py",
                "karpenter_tpu_torch/solver/disrupt/__init__.py",
                "karpenter_tpu_torch/solver/consolidate.py",
                "karpenter_tpu_torch/seeding.py",
                "karpenter_tpu_torch/obs/quality.py",
                "karpenter_tpu_torch/solver/bound.py",
                "karpenter_tpu_torch/solver/convex/__init__.py",
                "karpenter_tpu_torch/solver/convex/relax.py",
                "karpenter_tpu_torch/solver/convex/rounding.py",
                "karpenter_tpu_torch/solver/convex/tier.py",
                "karpenter_tpu_torch/metrics.py",
                "karpenter_tpu_torch/failpoints.py",
                "karpenter_tpu_torch/tracing.py",
                "karpenter_tpu_torch/logging.py",
                "karpenter_tpu_torch/obs/hbm.py",
                "karpenter_tpu_torch/obs/profiler.py",
                "karpenter_tpu_torch/obs/flight.py",
                "karpenter_tpu_torch/analysis/sync_witness.py",
                "karpenter_tpu_torch/overload.py",
                "karpenter_tpu_torch/solver/rpc.py",
                "karpenter_tpu_torch/solver/shm.py",
                "karpenter_tpu_torch/solver/breaker.py"} <= rel

    @pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
    def test_no_forbidden_import(self, path):
        bad = sorted(m for m in imported_modules(path) if forbidden(m))
        assert not bad, f"{path.relative_to(REPO)} imports {bad}"

    def test_solve_in_fresh_interpreter_loads_neither(self):
        """A solve on each tier (the quality bound behind both) and a
        consolidation sweep, on the CPU, in a fresh interpreter."""
        code = (
            "import sys\n"
            "import numpy as np\n"
            "from karpenter_tpu_torch import workload\n"
            "from karpenter_tpu_torch.apis import NodePool\n"
            "from karpenter_tpu_torch.solver.service import TorchSolver\n"
            "items = workload.build_catalog_items()\n"
            "pods = workload.synth_pods(np.random.default_rng(0), workload.ZONES, 200, 0, 8)\n"
            "r = TorchSolver(device='cpu', g_max=32).solve(NodePool('default'), items, pods)\n"
            "assert r.new_groups\n"
            "s = TorchSolver(device='cpu', g_max=32, tier='convex')\n"
            "assert s.solve(NodePool('default'), items, pods[:60]).new_groups\n"
            "assert s.last_convex and s.last_quality\n"
            "from karpenter_tpu_torch.solver.consolidate import ConsolidationEvaluator\n"
            "spec = workload.rampdown_sweep_spec(r, np.random.default_rng(1), n_cand=4)\n"
            "nodes, sets = workload.sweep_world(spec)\n"
            "pools, ovh = workload.sweep_pools('spot-od')\n"
            "v = ConsolidationEvaluator(device='cpu').evaluate(\n"
            "    nodes, sets, pools=pools, catalogs={p.name: items for p in pools}, daemon_overhead=ovh)\n"
            "assert len(v) == len(sets)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'karpenter_tpu'))\n"
            "print('LOADED', bad)\n"
            "sys.exit(1 if bad else 0)\n"
        )
        env = dict(os.environ, PYTHONPATH=str(REPO))
        r = subprocess.run([sys.executable, "-c", code], cwd=str(REPO), env=env,
                           capture_output=True, text=True, timeout=240)
        assert r.returncode == 0, r.stdout + r.stderr


    def test_observability_modules_load_neither(self):
        """metrics, failpoints (armed from the environment), tracing,
        logging, the observatory and the sync witness, imported and used in
        a fresh interpreter."""
        code = (
            "import sys\n"
            "import karpenter_tpu_torch.metrics, karpenter_tpu_torch.tracing\n"
            "import karpenter_tpu_torch.logging\n"
            "from karpenter_tpu_torch import failpoints\n"
            "from karpenter_tpu_torch.obs import flight, hbm, profiler, quality\n"
            "from karpenter_tpu_torch.analysis import sync_witness\n"
            "assert failpoints.FAILPOINTS.get('convex.rounding').times == 1\n"
            "assert hbm.poll(max_age_s=0)['devices'] == {}\n"
            "flight.record(flight.build_tick_record(None, 0.0))\n"
            "with sync_witness.hot('x'):\n"
            "    pass\n"
            "print(karpenter_tpu_torch.metrics.REGISTRY.expose()[:0])\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'karpenter_tpu'))\n"
            "print('LOADED', bad)\n"
            "sys.exit(1 if bad else 0)\n"
        )
        env = dict(os.environ, PYTHONPATH=str(REPO),
                   KARPENTER_TPU_FAILPOINTS="convex.rounding=error(RuntimeError):times=1")
        r = subprocess.run([sys.executable, "-c", code], cwd=str(REPO), env=env,
                           capture_output=True, text=True, timeout=240)
        assert r.returncode == 0, r.stdout + r.stderr


    def test_wire_modules_load_neither(self):
        """The sidecar, its client, the ring, the breaker and the overload
        budget, driven end to end on the CPU in a fresh interpreter."""
        code = (
            "import sys, tempfile\n"
            "import numpy as np\n"
            "from karpenter_tpu_torch import overload, workload\n"
            "from karpenter_tpu_torch.apis import NodePool\n"
            "from karpenter_tpu_torch.solver import breaker, rpc, shm\n"
            "from karpenter_tpu_torch.solver.service import TorchSolver\n"
            "d = tempfile.mkdtemp(prefix='kt-')\n"
            "srv = rpc.SolverServer(path=d + '/s.sock', device='cpu').start()\n"
            "c = rpc.SolverClient(path=d + '/s.sock', timeout=60.0)\n"
            "items = workload.build_catalog_items()\n"
            "pods = workload.synth_pods(np.random.default_rng(0), workload.ZONES, 200, 0, 8)\n"
            "s = TorchSolver(device='cpu', g_max=32, client=c, breaker=breaker.CircuitBreaker())\n"
            "with overload.active(overload.TickBudget(30.0)):\n"
            "    assert s.solve(NodePool('default'), items, pods).new_groups\n"
            "assert c._ring is not None and not overload.sheds_delta()\n"
            "c.close(); srv.stop()\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'karpenter_tpu'))\n"
            "print('LOADED', bad)\n"
            "sys.exit(1 if bad else 0)\n"
        )
        env = dict(os.environ, PYTHONPATH=str(REPO))
        r = subprocess.run([sys.executable, "-c", code], cwd=str(REPO), env=env,
                           capture_output=True, text=True, timeout=240)
        assert r.returncode == 0, r.stdout + r.stderr


class TestNoFallback:
    def test_solver_without_cuda_raises(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="CUDA"):
            service.TorchSolver()
        assert service.TorchSolver(device="cpu").device.type == "cpu"

    def test_chip_smoke_fails_without_a_card(self):
        r = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")], cwd=str(REPO),
                           capture_output=True, text=True, timeout=240,
                           env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
        assert r.returncode != 0
        assert '"ok"' not in r.stdout

    def test_sidecar_without_a_card_exits_nonzero(self, tmp_path):
        r = subprocess.run(
            [sys.executable, "-m", "karpenter_tpu_torch.solver.rpc", "--socket",
             str(tmp_path / "s.sock")],
            cwd=str(REPO), capture_output=True, text=True, timeout=240,
            env=dict(os.environ, PYTHONPATH=str(REPO), CUDA_VISIBLE_DEVICES=""))
        assert r.returncode != 0
        assert "no CUDA device" in r.stderr and "listening" not in r.stdout
        assert not (tmp_path / "s.sock").exists()

    def test_server_without_a_card_raises(self, monkeypatch, tmp_path):
        from karpenter_tpu_torch.solver import rpc

        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="CUDA"):
            rpc.SolverServer(path=str(tmp_path / "s.sock"))

    def test_wrappers_refuse_other_devices(self):
        meta = torch.empty((2, 9), device="meta")
        with pytest.raises(ValueError, match="no kernel"):
            disrupt_repack.disrupt_repack(
                torch.empty((4, 9), device="meta"), torch.empty((2, 4), dtype=torch.bool, device="meta"),
                meta, torch.empty((1, 2), dtype=torch.int32, device="meta"),
                torch.empty((1, 4), dtype=torch.bool, device="meta"))
        with pytest.raises(ValueError, match="several devices"):
            disrupt_repack.disrupt_repack(
                torch.zeros((4, 9)), torch.zeros((2, 4), dtype=torch.bool), meta,
                torch.zeros((1, 2), dtype=torch.int32), torch.zeros((1, 4), dtype=torch.bool))

    def test_scan_smem_guard(self):
        # G=1024, K=640, R=9 is the slice's shape and fits one block
        assert ffd_scan.smem_bytes(1024, 640, 9) <= ffd_scan.SMEM_LIMIT
        assert ffd_scan.smem_bytes(2048, 2048, 9) > ffd_scan.SMEM_LIMIT

    def test_scan_layout_at_merged_widths(self):
        """Two pools over the 627-type catalog (K=1280) fit only the lean
        layout; three (K=1920) fit neither and take the scratch layout,
        survivor words in device memory. Past what even scratch holds, the
        layout check raises naming the shape instead of choosing the plain
        version."""
        assert ffd_scan.layout(1024, 640, 9) == "resident"
        assert ffd_scan.layout(1024, 1280, 9) == "lean"
        assert ffd_scan.smem_bytes(1024, 1280, 9, "lean") <= ffd_scan.SMEM_LIMIT
        assert ffd_scan.smem_bytes(1024, 1920, 9, "lean") > ffd_scan.SMEM_LIMIT
        assert ffd_scan.layout(1024, 1920, 9) == "scratch"
        assert ffd_scan.smem_bytes(1024, 1920, 9, "scratch") < 64 * 1024
        with pytest.raises(ValueError, match="G=8192, K=32768, R=9"):
            ffd_scan.layout(8192, 32768, 9)

    def test_build_needs_nvcc(self, monkeypatch):
        monkeypatch.setattr(build.shutil, "which", lambda name: None)
        monkeypatch.setattr(build.os.path, "exists", lambda p: False)
        with pytest.raises(RuntimeError, match="nvcc"):
            build.nvcc_path()

    def test_library_names_follow_the_sources(self):
        a = build._library_path("ffd_scan")
        assert a == build._library_path("ffd_scan")
        assert a.parent == build.BUILD_DIR and a.name.startswith("ffd_scan-")
        assert a != build._library_path("disrupt_repack")
