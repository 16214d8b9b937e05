"""The port's threaded tests under the port's three runtime witnesses.

Runs, in a subprocess, `python -m pytest -p
karpenter_tpu_torch.analysis.pytest_plugin` over the tests that drive the
port's threads: the warm-up ladder beside dispatching threads
(test_torch_aot.py::TestConcurrency), the sidecar and its client
(test_torch_wire.py), the breaker and its dead-sidecar drill
(test_torch_breaker.py) and one operator world
(test_torch_operator.py). The session must pass, and the plugin's
summary must show zero lock-order inversions, zero unsanctioned swallows
and zero hot-section violations over a non-empty set of witnessed locks.
tests/conftest.py installs the JAX package's witnesses in the same
process, so this is also the two packages' witnesses side by side.
"""
import os
import re
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

TARGETS = (
    "tests/test_torch_aot.py::TestConcurrency",
    "tests/test_torch_wire.py",
    "tests/test_torch_breaker.py",
    "tests/test_torch_operator.py::test_provisioning_world[binpack]",
)


def test_threaded_tests_run_clean_under_the_port_witnesses():
    # one intra-op thread: the session shares the host with the other test workers
    env = dict(os.environ, JAX_PLATFORMS="cpu", KARPENTER_TPU_LOCK_WITNESS="1",
               KARPENTER_TPU_ERRFLOW_WITNESS="1", KARPENTER_TPU_JAX_WITNESS="1",
               OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    cmd = [sys.executable, "-m", "pytest", "-p", "karpenter_tpu_torch.analysis.pytest_plugin",
           "-q", "-m", "not slow", "-p", "no:cacheprovider", *TARGETS]
    r = subprocess.run(cmd, cwd=str(REPO), env=env, capture_output=True, text=True, timeout=600)
    out = r.stdout + r.stderr
    assert r.returncode == 0, out[-6000:]
    m = re.search(r"port witnesses: inversions=(\d+) unsanctioned_swallows=(\d+) "
                  r"hot_violations=(\d+) witnessed_locks=(\d+)", out)
    assert m, out[-3000:]
    inversions, swallows, violations, locks = map(int, m.groups())
    assert (inversions, swallows, violations) == (0, 0, 0), out[-3000:]
    assert locks > 0, "the lock witness wrapped no port lock"
