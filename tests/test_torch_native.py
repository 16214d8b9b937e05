"""The port's native grouping loop (karpenter_tpu_torch/native/) against the JAX package.

Mirrors tests/test_solver.py::TestNativeGrouping as parametrised cases:
the port's `group_pods` and `IncrementalGrouper.group`, each with the C
loop and with the pure-Python loop, must equal the JAX package's
`group_pods` on the same seeded pods -- the same classes, in the same
order, with the same pod names per class and the same routing flags.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

from karpenter_tpu import native as jnative
from karpenter_tpu.apis import Pod as JPod
from karpenter_tpu.apis.pod import TopologySpreadConstraint as JTSC
from karpenter_tpu.scheduling import Resources as JResources, Toleration as JToleration
from karpenter_tpu.solver import encode as jencode
from karpenter_tpu_torch import native as tnative
from karpenter_tpu_torch.apis import Pod as TPod
from karpenter_tpu_torch.apis.pod import TopologySpreadConstraint as TTSC
from karpenter_tpu_torch.scheduling import Resources as TResources, Toleration as TToleration
from karpenter_tpu_torch.solver import encode as tencode

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture()
def needs_native():
    """Decided per test (never at import): the extension built on this host."""
    if tnative.grouping is None:
        pytest.skip("no C compiler on this host: the port's grouping is pure")


def mixed_pods(Pod, Resources, Toleration, TSC, seed=11):
    """TestNativeGrouping's world: shared-spec templates (the token fast
    path), per-pod specs of equal structure (must merge) and token-less
    spread pods (the classify path), shuffled."""
    rng = np.random.default_rng(seed)
    pods = []
    for t in range(6):
        req = Resources({"cpu": f"{100 * (t + 1)}m", "memory": "256Mi"})
        sel = {"topology.kubernetes.io/zone": f"us-central-1{'abc'[t % 3]}"} if t % 2 else None
        tol = [Toleration(key="dedicated", operator="Exists")] if t == 3 else ()
        for i in range(int(rng.integers(3, 30))):
            pods.append(Pod(f"tpl{t}-{i}", requests=req, node_selector=sel, tolerations=tol))
    for i in range(10):
        pods.append(Pod(f"solo-{i}", requests=Resources({"cpu": "250m", "memory": "512Mi"})))
    for i in range(8):
        pods.append(Pod(
            f"spread-{i}", requests=Resources({"cpu": "100m", "memory": "128Mi"}),
            labels={"app": "s"},
            topology_spread=[TSC(max_skew=1, topology_key="topology.kubernetes.io/zone",
                                 label_selector={"app": "s"})]))
    order = rng.permutation(len(pods))
    return [pods[i] for i in order]


def summary(classes):
    return [([p.metadata.name for p in c.pods], c.key, c.has_affinity, c.multi_node_affinity,
             c.has_preferences, c.requests.tolist()) for c in classes]


def port_group(entry, pods):
    if entry == "group_pods":
        return tencode.group_pods(pods)
    grouper = tencode.IncrementalGrouper()
    grouper.group(pods[: len(pods) // 2])       # a warm memo, as across ticks
    return grouper.group(pods)


@pytest.mark.parametrize("seed", [11, 12])
@pytest.mark.parametrize("loop", ["native", "pure"])
@pytest.mark.parametrize("entry", ["group_pods", "IncrementalGrouper.group"])
def test_port_grouping_equals_jax(entry, loop, seed, monkeypatch):
    if loop == "native" and tnative.grouping is None:
        pytest.skip("no C compiler on this host: the port's grouping is pure")
    if loop == "pure":
        monkeypatch.setattr(tencode, "_native_grouping", None)
    want = summary(jencode.group_pods(mixed_pods(JPod, JResources, JToleration, JTSC, seed)))
    got = summary(port_group(entry, mixed_pods(TPod, TResources, TToleration, TTSC, seed)))
    assert got == want


def test_native_equals_pure_on_the_same_pods(monkeypatch, needs_native):
    """The two loops on one pod list: the per-pod `_sig_id` memo the first
    call leaves behind must not change what the second call decides."""
    pods = mixed_pods(TPod, TResources, TToleration, TTSC)
    native = summary(tencode.group_pods(pods))
    monkeypatch.setattr(tencode, "_native_grouping", None)
    assert summary(tencode.group_pods(pods)) == native


def test_the_extension_lands_under_the_ports_build_dir(needs_native):
    path = os.path.realpath(tnative.grouping.__file__)
    build = os.path.realpath(os.path.join(REPO, "karpenter_tpu_torch", "build", "native"))
    assert os.path.dirname(path) == build
    name = os.path.basename(path)
    assert name.startswith(f"_grouping_cp{sys.version_info.major}{sys.version_info.minor}_")
    assert tnative.grouping.__name__ == "karpenter_tpu_torch.native._grouping"
    # nothing of the port's is built beside the JAX package's source
    jdir = os.path.join(REPO, "karpenter_tpu", "native")
    assert not any(n.startswith("_grouping") and n.endswith(".tmp") for n in os.listdir(jdir))


def test_both_extensions_live_in_one_process(needs_native):
    if jnative.grouping is None:
        pytest.skip("the JAX package's extension did not build")
    assert jnative.grouping is not tnative.grouping
    assert jnative.grouping.__name__ == "karpenter_tpu.native._grouping"
    assert os.path.dirname(os.path.realpath(jnative.grouping.__file__)) != \
        os.path.dirname(os.path.realpath(tnative.grouping.__file__))


def test_no_native_env_gives_none(monkeypatch):
    monkeypatch.setenv("KARPENTER_TPU_NO_NATIVE", "1")
    assert tnative._load() is None


def test_no_native_env_in_a_fresh_interpreter():
    code = ("import sys\n"
            "from karpenter_tpu_torch.native import grouping\n"
            "from karpenter_tpu_torch.solver import encode\n"
            "sys.exit(0 if grouping is None and encode._native_grouping is None else 1)\n")
    env = dict(os.environ, KARPENTER_TPU_NO_NATIVE="1")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                       timeout=120)
    assert r.returncode == 0, r.stderr.decode()


def test_missing_compiler_gives_none(monkeypatch, tmp_path):
    """No compiler: the build fails, `_load` returns None and nothing is
    left behind (the JAX package's host behaviour)."""
    monkeypatch.setenv("CC", str(tmp_path / "no-such-cc"))
    monkeypatch.setattr(tnative, "BUILD_DIR", str(tmp_path / "native"))
    assert tnative._load() is None
    assert not any(p.name.endswith(".so") for p in (tmp_path / "native").glob("*"))
