"""The port stands alone and never falls back.

- no module of karpenter_tpu_torch/, and not chip_smoke.py, imports jax or
  anything of karpenter_tpu (an AST scan);
- a solve in a fresh interpreter leaves both out of sys.modules, and so do
  the apiserver bus, CEL admission, the scenario generators and the
  shrinker;
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

# the fleet slice's modules (single device)
FLEET_MODULES = (
    "karpenter_tpu_torch/fleet/__init__.py",
    "karpenter_tpu_torch/fleet/coalesce.py",
    "karpenter_tpu_torch/fleet/service.py",
    "karpenter_tpu_torch/sim/fleet.py",
)

# the mesh slice's modules (parallel/, the fleet's topology ladder)
MESH_MODULES = (
    "karpenter_tpu_torch/parallel/__init__.py",
    "karpenter_tpu_torch/parallel/mesh.py",
    "karpenter_tpu_torch/parallel/dryrun.py",
    "karpenter_tpu_torch/fleet/shard.py",
    "karpenter_tpu_torch/fleet/topology.py",
    "karpenter_tpu_torch/fleet/straggler.py",
)


# the operator slice's modules (copies of the JAX package's jax-free control
# plane under the same paths)
OPERATOR_MODULES = (
    "karpenter_tpu_torch/__main__.py",
    "karpenter_tpu_torch/apis/daemonset.py",
    "karpenter_tpu_torch/apis/nodeclaim.py",
    "karpenter_tpu_torch/apis/nodeclass.py",
    "karpenter_tpu_torch/apis/pdb.py",
    "karpenter_tpu_torch/apis/storage.py",
    "karpenter_tpu_torch/apis/validation.py",
    "karpenter_tpu_torch/batcher/__init__.py",
    "karpenter_tpu_torch/batcher/batcher.py",
    "karpenter_tpu_torch/batcher/cloud.py",
    "karpenter_tpu_torch/cache/__init__.py",
    "karpenter_tpu_torch/cache/ttl.py",
    "karpenter_tpu_torch/cache/unavailable_offerings.py",
    "karpenter_tpu_torch/cloud/api.py",
    "karpenter_tpu_torch/cloudprovider/__init__.py",
    "karpenter_tpu_torch/cloudprovider/cloudprovider.py",
    "karpenter_tpu_torch/controllers/__init__.py",
    "karpenter_tpu_torch/controllers/disruption.py",
    "karpenter_tpu_torch/controllers/garbagecollection.py",
    "karpenter_tpu_torch/controllers/interruption.py",
    "karpenter_tpu_torch/controllers/interruption_messages.py",
    "karpenter_tpu_torch/controllers/metrics_controller.py",
    "karpenter_tpu_torch/controllers/nodeclaim_lifecycle.py",
    "karpenter_tpu_torch/controllers/nodeclass.py",
    "karpenter_tpu_torch/controllers/pdb_guard.py",
    "karpenter_tpu_torch/controllers/providers.py",
    "karpenter_tpu_torch/controllers/provisioner.py",
    "karpenter_tpu_torch/controllers/recovery.py",
    "karpenter_tpu_torch/controllers/repair.py",
    "karpenter_tpu_torch/controllers/tagging.py",
    "karpenter_tpu_torch/controllers/termination.py",
    "karpenter_tpu_torch/errors/__init__.py",
    "karpenter_tpu_torch/errors/errors.py",
    "karpenter_tpu_torch/events.py",
    "karpenter_tpu_torch/fencing.py",
    "karpenter_tpu_torch/journal.py",
    "karpenter_tpu_torch/kwok/__init__.py",
    "karpenter_tpu_torch/kwok/cloud.py",
    "karpenter_tpu_torch/kwok/cluster.py",
    "karpenter_tpu_torch/kwok/lifecycle.py",
    "karpenter_tpu_torch/operator/__init__.py",
    "karpenter_tpu_torch/operator/election.py",
    "karpenter_tpu_torch/operator/health.py",
    "karpenter_tpu_torch/operator/operator.py",
    "karpenter_tpu_torch/providers/capacityreservation/__init__.py",
    "karpenter_tpu_torch/providers/capacityreservation/provider.py",
    "karpenter_tpu_torch/providers/image/__init__.py",
    "karpenter_tpu_torch/providers/image/provider.py",
    "karpenter_tpu_torch/providers/instance/__init__.py",
    "karpenter_tpu_torch/providers/instance/filters.py",
    "karpenter_tpu_torch/providers/instance/provider.py",
    "karpenter_tpu_torch/providers/instanceprofile/__init__.py",
    "karpenter_tpu_torch/providers/instanceprofile/provider.py",
    "karpenter_tpu_torch/providers/instancetype/offerings.py",
    "karpenter_tpu_torch/providers/instancetype/provider.py",
    "karpenter_tpu_torch/providers/launchtemplate/__init__.py",
    "karpenter_tpu_torch/providers/launchtemplate/bootstrap.py",
    "karpenter_tpu_torch/providers/launchtemplate/provider.py",
    "karpenter_tpu_torch/providers/params/__init__.py",
    "karpenter_tpu_torch/providers/params/provider.py",
    "karpenter_tpu_torch/providers/pricing/__init__.py",
    "karpenter_tpu_torch/providers/pricing/provider.py",
    "karpenter_tpu_torch/providers/queue/__init__.py",
    "karpenter_tpu_torch/providers/queue/provider.py",
    "karpenter_tpu_torch/providers/securitygroup/__init__.py",
    "karpenter_tpu_torch/providers/securitygroup/provider.py",
    "karpenter_tpu_torch/providers/subnet/__init__.py",
    "karpenter_tpu_torch/providers/subnet/provider.py",
    "karpenter_tpu_torch/providers/version/__init__.py",
    "karpenter_tpu_torch/providers/version/provider.py",
    "karpenter_tpu_torch/sim/__init__.py",
    "karpenter_tpu_torch/sim/cli.py",
    "karpenter_tpu_torch/sim/replay.py",
    "karpenter_tpu_torch/sim/trace.py",
    "karpenter_tpu_torch/solver/convex/repack.py",
)
# the bus slice's modules: the apiserver bus, CEL admission, the scenario
# generators and the shrinker
BUS_MODULES = (
    "karpenter_tpu_torch/kube/__init__.py",
    "karpenter_tpu_torch/kube/client.py",
    "karpenter_tpu_torch/kube/cluster.py",
    "karpenter_tpu_torch/kube/convert.py",
    "karpenter_tpu_torch/apis/celcheck.py",
    "karpenter_tpu_torch/apis/celmini.py",
    "karpenter_tpu_torch/sim/scenario.py",
    "karpenter_tpu_torch/sim/shrink.py",
)


# the native grouping loop and the analysis layer (checkers and witnesses)
NATIVE_ANALYSIS_MODULES = (
    "karpenter_tpu_torch/native/__init__.py",
    "karpenter_tpu_torch/analysis/__init__.py",
    "karpenter_tpu_torch/analysis/__main__.py",
    "karpenter_tpu_torch/analysis/base.py",
    "karpenter_tpu_torch/analysis/witness.py",
    "karpenter_tpu_torch/analysis/errwitness.py",
    "karpenter_tpu_torch/analysis/torch_witness.py",
    "karpenter_tpu_torch/analysis/pytest_plugin.py",
    "karpenter_tpu_torch/analysis/checkers/__init__.py",
    "karpenter_tpu_torch/analysis/checkers/determinism.py",
    "karpenter_tpu_torch/analysis/checkers/errflow.py",
    "karpenter_tpu_torch/analysis/checkers/locks.py",
    "karpenter_tpu_torch/analysis/checkers/registry_drift.py",
    "karpenter_tpu_torch/analysis/checkers/reslife.py",
    "karpenter_tpu_torch/analysis/checkers/torch_discipline.py",
    "karpenter_tpu_torch/analysis/checkers/zerocopy.py",
)


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
                "karpenter_tpu_torch/solver/breaker.py",
                # the cold-start slice
                "karpenter_tpu_torch/solver/aot.py",
                "karpenter_tpu_torch/obs/jitstats.py",
                "karpenter_tpu_torch/solver/kernels/build.py"} <= rel
        # the operator, its controllers, the kwok world, the providers, the
        # binary and the replay
        assert set(OPERATOR_MODULES) <= rel
        assert set(BUS_MODULES) <= rel

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


    def test_cold_start_modules_load_neither(self):
        """The library store, the warm-up ladder (armed, drained, serving
        a tick), warm(), the per-entry table and /debug/aot's document, on
        the CPU in a fresh interpreter."""
        code = (
            "import sys, tempfile\n"
            "import numpy as np\n"
            "from karpenter_tpu_torch import workload\n"
            "from karpenter_tpu_torch.apis import NodePool\n"
            "from karpenter_tpu_torch.analysis import sync_witness\n"
            "from karpenter_tpu_torch.obs import jitstats\n"
            "from karpenter_tpu_torch.solver import aot\n"
            "from karpenter_tpu_torch.solver.service import TorchSolver\n"
            "from karpenter_tpu_torch.utils import enable_compilation_cache\n"
            "home = enable_compilation_cache(tempfile.mkdtemp(prefix='kt-'))\n"
            "assert home is not None\n"
            "assert jitstats.install() > 0\n"
            "items = workload.build_catalog_items()[::4]\n"
            "pods = workload.synth_pods(np.random.default_rng(0), workload.ZONES, 200, 0, 8)\n"
            "s = TorchSolver(device='cpu', g_max=32)\n"
            "m = s.enable_aot(home, duty=1.0, pads=(16,))\n"
            "s.warm(items, c_pads=(16,))\n"
            "assert m.drain(120)\n"
            "n0 = aot.AOT_DISPATCHES.value(entry='ffd_solve_fused')\n"
            "with sync_witness.aot_phase():\n"
            "    assert s.solve(NodePool('default'), items, pods).new_groups\n"
            "assert aot.AOT_DISPATCHES.value(entry='ffd_solve_fused') == n0 + 1\n"
            "assert s.describe_aot()['entries']['ffd_solve_fused']['fraction'] == 1.0\n"
            "assert s.describe_wire()['jit_entries']\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'karpenter_tpu'))\n"
            "print('LOADED', bad)\n"
            "sys.exit(1 if bad else 0)\n"
        )
        env = dict(os.environ, PYTHONPATH=str(REPO))
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


    def test_operator_and_replay_load_neither(self):
        """Every module of the package imported, then the port's Operator
        ticked and a corpus trace replayed on the CPU, in a fresh
        interpreter."""
        code = (
            "import importlib, pkgutil, sys\n"
            "import torch\n"
            "torch.set_num_threads(1)\n"
            "import karpenter_tpu_torch\n"
            "names = [m.name for m in pkgutil.walk_packages(karpenter_tpu_torch.__path__, 'karpenter_tpu_torch.')\n"
            "         if not m.name.endswith('__main__')]\n"
            "for name in names:\n"
            "    importlib.import_module(name)\n"
            "import numpy as np\n"
            "from karpenter_tpu_torch import workload\n"
            "from karpenter_tpu_torch.apis import NodePool, TPUNodeClass\n"
            "from karpenter_tpu_torch.cache.ttl import FakeClock\n"
            "from karpenter_tpu_torch.operator import Operator, Options\n"
            "from karpenter_tpu_torch.solver.consolidate import ConsolidationEvaluator\n"
            "from karpenter_tpu_torch.solver.service import TorchSolver\n"
            "s = TorchSolver(device='cpu', g_max=32)\n"
            "op = Operator(clock=FakeClock(100000.0), solver=s, options=Options(seed=1, tracing=False),\n"
            "              consolidation_evaluator=ConsolidationEvaluator(solver=s))\n"
            "op.cluster.create(TPUNodeClass('default')); op.cluster.create(NodePool('default'))\n"
            "for p in workload.synth_pods(np.random.default_rng(0), workload.ZONES, 60, 0, 8):\n"
            "    op.cluster.create(p)\n"
            "op.settle()\n"
            "assert not op.cluster.pending_pods()\n"
            "from karpenter_tpu_torch.sim.replay import replay\n"
            "from karpenter_tpu_torch.sim.trace import read_trace\n"
            "r = replay(read_trace('tests/golden/scenarios/diurnal-small.jsonl'), seed=20260803, device='cpu')\n"
            "assert r.ticks > 0\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'karpenter_tpu'))\n"
            "print('LOADED', len(names), bad)\n"
            "sys.exit(1 if bad else 0)\n"
        )
        env = dict(os.environ, PYTHONPATH=str(REPO))
        r = subprocess.run([sys.executable, "-c", code], cwd=str(REPO), env=env,
                           capture_output=True, text=True, timeout=240)
        assert r.returncode == 0, r.stdout + r.stderr[-3000:]


    def test_bus_admission_and_scenarios_load_neither(self):
        """kube/ against a fake apiserver (loaded by file path: tests/ is
        no package the port may import), CEL admission on the port's CRD
        copy, a scenario built and a shrink over it, in a fresh
        interpreter."""
        code = (
            "import importlib.util, os, sys\n"
            "spec = importlib.util.spec_from_file_location('fake_apiserver', 'tests/fake_apiserver.py')\n"
            "fa = importlib.util.module_from_spec(spec); spec.loader.exec_module(fa)\n"
            "import yaml\n"
            "from karpenter_tpu_torch.apis import NodePool, Pod, celcheck, celmini\n"
            "from karpenter_tpu_torch.kube import KubeClient, KubeConfig, KubeCluster, convert\n"
            "from karpenter_tpu_torch.scheduling import Resources\n"
            "from karpenter_tpu_torch.sim import scenario, shrink\n"
            "srv = fa.FakeApiServer().start()\n"
            "cl = KubeCluster(KubeClient(KubeConfig(server=srv.url)))\n"
            "try:\n"
            "    cl.create(NodePool('default')); cl.create(Pod('w', requests=Resources({'cpu': '1'})))\n"
            "    assert [p.metadata.name for p in cl.pending_pods()] == ['w']\n"
            "finally:\n"
            "    cl.stop(); srv.stop()\n"
            "crd = yaml.safe_load(open('karpenter_tpu_torch/apis/crds/karpenter.sh_nodepools.yaml'))\n"
            "m = convert.nodepool_to_manifest(NodePool('p', weight=101))\n"
            "assert celcheck.validate_manifest(crd, m) and celmini.evaluate('self > 1', 2)\n"
            "events = scenario.build_scenario('diurnal-small', seed=scenario.DEFAULT_SEED)\n"
            "out = shrink.ddmin(events, lambda ev: any(e.get('ev') == 'advance' for e in ev))\n"
            "assert len(out) == 2\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'karpenter_tpu'))\n"
            "print('LOADED', bad)\n"
            "sys.exit(1 if bad else 0)\n"
        )
        env = dict(os.environ, PYTHONPATH=str(REPO))
        r = subprocess.run([sys.executable, "-c", code], cwd=str(REPO), env=env,
                           capture_output=True, text=True, timeout=240)
        assert r.returncode == 0, r.stdout + r.stderr[-3000:]


    def test_fleet_modules_are_scanned(self):
        rel = {str(p.relative_to(REPO)) for p in PORT_FILES}
        assert set(FLEET_MODULES) <= rel

    def test_fleet_replay_loads_neither(self):
        """Every module of the package imported, then the fleet replay --
        two tenants of the multi-cluster storm through one coalescing
        sidecar, each against its isolated replay and the pinned digests
        -- on the CPU, in a fresh interpreter."""
        code = (
            "import importlib, json, pkgutil, sys\n"
            "import torch\n"
            "torch.set_num_threads(1)\n"
            "import karpenter_tpu_torch\n"
            "names = [m.name for m in pkgutil.walk_packages(karpenter_tpu_torch.__path__, 'karpenter_tpu_torch.')\n"
            "         if not m.name.endswith('__main__')]\n"
            "for name in names:\n"
            "    importlib.import_module(name)\n"
            "from karpenter_tpu_torch.fleet import DispatchCoalescer, TenantRefusal\n"
            "from karpenter_tpu_torch.sim.fleet import replay_fleet\n"
            "res = replay_fleet(2, device='cpu')\n"
            "golden = json.load(open('tests/golden/scenarios/multi-cluster-storm.digests.json'))\n"
            "assert res.ok and res.digests == {t: golden[t] for t in res.digests}, res.digests\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'karpenter_tpu'))\n"
            "print('LOADED', len(names), bad)\n"
            "sys.exit(1 if bad else 0)\n"
        )
        env = dict(os.environ, PYTHONPATH=str(REPO))
        r = subprocess.run([sys.executable, "-c", code], cwd=str(REPO), env=env,
                           capture_output=True, text=True, timeout=240)
        assert r.returncode == 0, r.stdout + r.stderr[-3000:]


    def test_mesh_modules_are_scanned(self):
        rel = {str(p.relative_to(REPO)) for p in PORT_FILES}
        assert set(MESH_MODULES) <= rel

    def test_mesh_and_its_ladder_load_neither(self):
        """The mesh modules, an 8-shard CPU engine walked down its ladder,
        and the mesh-device-loss replay, in a fresh interpreter."""
        code = (
            "import json, sys\n"
            "import torch\n"
            "torch.set_num_threads(1)\n"
            "from karpenter_tpu_torch.fleet import MeshSolveEngine, ShardStragglerWatchdog\n"
            "from karpenter_tpu_torch.fleet import TopologyTracker, classify_device_error\n"
            "from karpenter_tpu_torch.parallel import make_mesh, make_mesh_2d, dryrun\n"
            "eng = MeshSolveEngine(make_mesh(8, devices=['cpu'] * 8))\n"
            "eng.mark_device_lost(7, 'test')\n"
            "from karpenter_tpu_torch.sim.replay import replay\n"
            "from karpenter_tpu_torch.sim.trace import read_trace\n"
            "d = 'tests/golden/scenarios/'\n"
            "res = replay(read_trace(d + 'mesh-device-loss.jsonl'), backend='mesh',\n"
            "             seed=20260803, device='cpu')\n"
            "assert res.digest == json.load(open(d + 'digests.json'))['mesh-device-loss']\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'karpenter_tpu'))\n"
            "print('LOADED', bad)\n"
            "sys.exit(1 if bad else 0)\n"
        )
        env = dict(os.environ, PYTHONPATH=str(REPO))
        r = subprocess.run([sys.executable, "-c", code], cwd=str(REPO), env=env,
                           capture_output=True, text=True, timeout=240)
        assert r.returncode == 0, r.stdout + r.stderr[-3000:]


class TestNoFallback:
    def test_native_and_analysis_are_scanned(self):
        rel = {str(p.relative_to(REPO)) for p in PORT_FILES}
        assert set(NATIVE_ANALYSIS_MODULES) <= rel

    def test_native_and_analysis_load_neither(self):
        """The native grouping loop, every checker family, the three
        witnesses and the pytest plugin, in a fresh interpreter."""
        code = (
            "import sys\n"
            "from karpenter_tpu_torch.analysis import witness, errwitness, torch_witness\n"
            "witness.install()\n"
            "torch_witness.install()\n"
            "errwitness.install()\n"
            "from karpenter_tpu_torch.analysis import pytest_plugin\n"
            "from karpenter_tpu_torch.analysis.__main__ import main\n"
            "assert main(['--rules', 'locks', '--rules', 'registry']) == 0\n"
            "import numpy as np\n"
            "from karpenter_tpu_torch import native, workload\n"
            "from karpenter_tpu_torch.solver import encode\n"
            "pods = workload.synth_pods(np.random.default_rng(0), workload.ZONES, 300, 0, 8)\n"
            "assert encode.group_pods(pods)\n"
            "print('NATIVE', native.grouping is not None)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'karpenter_tpu'))\n"
            "print('LOADED', bad)\n"
            "sys.exit(1 if bad else 0)\n"
        )
        env = dict(os.environ, PYTHONPATH=str(REPO))
        r = subprocess.run([sys.executable, "-c", code], cwd=str(REPO), env=env,
                           capture_output=True, text=True, timeout=240)
        assert r.returncode == 0, r.stdout + r.stderr

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

    def test_library_names_follow_the_sources(self, monkeypatch):
        # no prepared store and no $KARPENTER_TPU_COMPILE_CACHE: the
        # checkout's build directory, versioned by the runtime fingerprint
        monkeypatch.setattr(build, "_store_dir", None)
        monkeypatch.delenv(build.CACHE_ENV, raising=False)
        a = build._library_path("ffd_scan")
        assert a == build._library_path("ffd_scan")
        assert a.parent == build.BUILD_DIR / build.fingerprint() and a.name.startswith("ffd_scan-")
        assert a != build._library_path("disrupt_repack")
