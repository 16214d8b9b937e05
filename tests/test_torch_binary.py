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
            assert get("/debug/aot") == 404
        finally:
            thread = srv._thread
            srv.stop()
            if isinstance(thread, threading.Thread):
                thread.join(timeout=10)
                assert not thread.is_alive()
