"""`python -m karpenter_tpu_torch`, the port's binary, on the CPU.

- With `--device cpu` it builds the port's Operator (TorchSolver and the
  consolidation engine on the kernels' plain versions), serves its
  health endpoints, runs its ticks and exits 0; with `--metrics-dump` it
  prints the port's registry.
- Without `--device cpu`, on a machine without CUDA, it exits non-zero
  before building anything or running a tick, naming `--device cpu`: the
  port's binary has no fallback to the host (the JAX binary's has).
- `sim replay` runs the port's replay from the command line.
- The health server answers `/readyz` 200 only after a sweep; its threads
  stop with a bounded join.
- With `--kubeconfig` it runs over a (fake) apiserver, binds every pod and
  writes no default NodePool; `--in-cluster` off a cluster fails as the
  JAX binary does, before any tick; without a card it still exits 2.
"""
import json
import os
import subprocess
import sys
import threading
import urllib.request
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
GOLDEN = REPO / "tests" / "golden" / "scenarios"


def run_binary(*args, timeout=240, **env):
    return subprocess.run(
        [sys.executable, "-m", "karpenter_tpu_torch", *args], cwd=str(REPO),
        capture_output=True, text=True, timeout=timeout,
        # one intra-op thread: several test workers share the cores
        env=dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1", **env))


class TestBinary:
    def test_cpu_ticks_and_exits_zero(self):
        r = run_binary("--device", "cpu", "--max-ticks", "3", "--health-port", "0",
                       "--tick-interval", "0.05", "--seed", "1", "--metrics-dump")
        assert r.returncode == 0, r.stderr[-2000:]
        assert "karpenter_nodes_ready_count" in r.stdout
        # the nodeclass controller reconciled the default class: a sweep ran
        assert "nodeclass readiness" in r.stderr
        assert "CUDA probe" not in r.stderr

    def test_refuses_without_a_card(self):
        r = run_binary("--max-ticks", "3", "--health-port", "0", CUDA_VISIBLE_DEVICES="")
        assert r.returncode != 0
        assert "--device cpu" in r.stderr and "no usable CUDA device" in r.stderr
        # nothing was built and no tick ran
        assert "nodeclass readiness" not in r.stderr

    def test_sim_replay_verb(self):
        r = run_binary("sim", "replay", str(GOLDEN / "diurnal-small.jsonl"), "--device", "cpu")
        assert r.returncode == 0, r.stderr[-2000:]
        out = json.loads(r.stdout.strip().splitlines()[-1])
        golden = json.loads((GOLDEN / "digests.json").read_text())
        assert out["ok"] and out["digest"] == golden["diurnal-small"]
        assert out["backend"] == "host"

    def test_sim_replay_without_a_card_fails(self):
        r = run_binary("sim", "replay", str(GOLDEN / "diurnal-small.jsonl"),
                       CUDA_VISIBLE_DEVICES="")
        assert r.returncode != 0 and '"digest"' not in r.stdout


class TestHealth:
    def test_readyz_after_a_sweep(self):
        from karpenter_tpu_torch.operator.health import HealthServer

        srv = HealthServer(port=0).start()
        try:
            port = srv._server.server_address[1]

            def get(path):
                try:
                    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=10) as resp:
                        return resp.status
                except urllib.error.HTTPError as e:
                    return e.code

            assert get("/readyz") == 503
            srv.beat_loop()
            srv.beat_sweep()
            assert get("/readyz") == 200 and get("/healthz") == 200
            # the cold-start document is served (unconfigured until the
            # binary wires TorchSolver.describe_aot)
            assert get("/debug/aot") == 200
        finally:
            thread = srv._thread
            srv.stop()
            if isinstance(thread, threading.Thread):
                thread.join(timeout=10)
                assert not thread.is_alive()


class TestKubeMode:
    """`--kubeconfig` / `--in-cluster`: the port's Operator over its
    KubeCluster, against a fake apiserver (tests/fake_apiserver.py) that
    already holds a NodeClass, a NodePool and pods, as the JAX binary runs
    (karpenter_tpu/__main__.py): no default NodeClass or NodePool is
    written, pod arrivals are watched."""

    @staticmethod
    def kubeconfig(tmp_path, url):
        path = tmp_path / "kubeconfig"
        # JSON is YAML: the binary reads it with yaml.safe_load
        path.write_text(json.dumps({
            "apiVersion": "v1", "kind": "Config", "current-context": "fake",
            "contexts": [{"name": "fake", "context": {"cluster": "fake", "user": "fake"}}],
            "clusters": [{"name": "fake", "cluster": {"server": url}}],
            "users": [{"name": "fake", "user": {"token": "t"}}]}))
        return str(path)

    def test_kubeconfig_binds_every_pod(self, tmp_path):
        import signal
        import time

        from fake_apiserver import FakeApiServer

        from karpenter_tpu_torch.apis import NodePool, Pod, TPUNodeClass
        from karpenter_tpu_torch.kube import KubeClient, KubeConfig, KubeCluster
        from karpenter_tpu_torch.scheduling import Resources

        srv = FakeApiServer().start()
        cl = KubeCluster(KubeClient(KubeConfig(server=srv.url)))
        reader = KubeCluster(KubeClient(KubeConfig(server=srv.url)), list_cache_ttl=0.0)
        proc = None
        try:
            cl.create(TPUNodeClass("default"))
            cl.create(NodePool("team-a"))
            for i in range(12):
                cl.create(Pod(f"w-{i}", requests=Resources(
                    {"cpu": ("250m", "1", "2")[i % 3], "memory": "1Gi"})))
            # the kwok nodes register 3 s and initialize 2 s after launch on
            # the wall clock: the binary ticks until every pod is bound (read
            # back through a second client), then stops on SIGTERM as a
            # supervisor stops it
            proc = subprocess.Popen(
                [sys.executable, "-m", "karpenter_tpu_torch", "--device", "cpu",
                 "--kubeconfig", self.kubeconfig(tmp_path, srv.url), "--max-ticks", "240",
                 "--tick-interval", "0.25", "--health-port", "0", "--seed", "1"],
                cwd=str(REPO), stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                env=dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1"))
            deadline = time.monotonic() + 120
            pods = reader.list(Pod)
            while not all(p.node_name for p in pods) and proc.poll() is None \
                    and time.monotonic() < deadline:
                time.sleep(0.25)
                pods = reader.list(Pod)
            proc.send_signal(signal.SIGTERM)
            _, stderr = proc.communicate(timeout=60)
            assert proc.returncode == 0, stderr[-2000:]
            assert len(pods) == 12 and all(p.node_name for p in pods)
            # the binary wrote no default policy into the apiserver
            assert [p.metadata.name for p in reader.list(NodePool)] == ["team-a"]
            assert [c.metadata.name for c in reader.list(TPUNodeClass)] == ["default"]
        finally:
            if proc is not None and proc.poll() is None:
                proc.kill()
                proc.communicate(timeout=60)
            cl.stop()
            reader.stop()
            srv.stop()

    def test_in_cluster_off_cluster_fails_before_a_tick(self, monkeypatch):
        from karpenter_tpu.kube.client import KubeConfig as JaxKubeConfig

        monkeypatch.delenv("KUBERNETES_SERVICE_HOST", raising=False)
        with pytest.raises(RuntimeError) as jax_err:
            JaxKubeConfig.in_cluster()
        r = run_binary("--device", "cpu", "--in-cluster", "--max-ticks", "3",
                       "--health-port", "0")
        assert r.returncode != 0
        # the JAX binary's failure, raised before any tick
        assert str(jax_err.value) in r.stderr and "RuntimeError" in r.stderr
        assert "nodeclass readiness" not in r.stderr

    def test_kube_mode_without_a_card_exits_2(self, tmp_path):
        r = run_binary("--kubeconfig", self.kubeconfig(tmp_path, "http://127.0.0.1:9"),
                       "--max-ticks", "3", "--health-port", "0", CUDA_VISIBLE_DEVICES="")
        assert r.returncode == 2
        assert "--device cpu" in r.stderr and "no usable CUDA device" in r.stderr
