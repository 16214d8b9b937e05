"""The port's three runtime witnesses over a pytest session.

    python -m pytest -p karpenter_tpu_torch.analysis.pytest_plugin tests/test_torch_wire.py ...

Counterpart of the session fixtures `lock_order_witness`,
`errflow_escape_witness` and `jax_retrace_witness` that the JAX package's
tests/conftest.py installs over its own package. This plugin installs the
port's witnesses at `pytest_configure`, before any test module imports
karpenter_tpu_torch (so module-level locks are wrapped too), in the
JAX order: the lock-order witness (analysis/witness.py), the torch
witness (analysis/torch_witness.py), then the escape witness
(analysis/errwitness.py, which imports the ladder modules it taps). At
session end it asserts zero lock-order inversions, zero unsanctioned
swallows and zero hot-section violations, and prints one summary line:

    port witnesses: inversions=0 unsanctioned_swallows=0 hot_violations=0 ...

Environment, with the JAX package's meanings: KARPENTER_TPU_LOCK_WITNESS,
KARPENTER_TPU_ERRFLOW_WITNESS and KARPENTER_TPU_JAX_WITNESS -- `0`
disables that witness, `1` (the default) collects, `strict` raises at the
offending acquire, swallow or rebuild.
"""
from __future__ import annotations

import os

import pytest

_MODES = {
    "lock": os.environ.get("KARPENTER_TPU_LOCK_WITNESS", "1"),
    "torch": os.environ.get("KARPENTER_TPU_JAX_WITNESS", "1"),
    "errflow": os.environ.get("KARPENTER_TPU_ERRFLOW_WITNESS", "1"),
}


@pytest.hookimpl(tryfirst=True)
def pytest_configure(config):
    if _MODES["lock"] != "0":
        from karpenter_tpu_torch.analysis import witness

        witness.install(strict=_MODES["lock"] == "strict")
    if _MODES["torch"] != "0":
        from karpenter_tpu_torch.analysis import torch_witness

        torch_witness.install(strict=_MODES["torch"] == "strict")
    if _MODES["errflow"] != "0":
        from karpenter_tpu_torch.analysis import errwitness

        errwitness.install(strict=_MODES["errflow"] == "strict")


def counts() -> dict:
    """The session's witness counts (None for a disabled witness)."""
    out = {"inversions": None, "unsanctioned_swallows": None, "hot_violations": None,
           "witnessed_locks": None, "sanctioned_fetches": None}
    if _MODES["lock"] != "0":
        from karpenter_tpu_torch.analysis import witness

        out["inversions"] = len(witness.inversions())
        out["witnessed_locks"] = witness.wrapped_count()
    if _MODES["errflow"] != "0":
        from karpenter_tpu_torch.analysis import errwitness

        errwitness.flush()
        out["unsanctioned_swallows"] = len(errwitness.swallows(unsanctioned_only=True))
    if _MODES["torch"] != "0":
        from karpenter_tpu_torch.analysis import torch_witness

        out["hot_violations"] = len(torch_witness.hot_violations())
        out["sanctioned_fetches"] = torch_witness.stats()["sanctioned_fetches"]
    return out


@pytest.fixture(scope="session", autouse=True)
def port_lock_order_witness():
    """Zero-inversion gate over the port's lock sites."""
    yield
    if _MODES["lock"] != "0":
        from karpenter_tpu_torch.analysis import witness

        assert not witness.inversions(), witness.report()


@pytest.fixture(scope="session", autouse=True)
def port_errflow_escape_witness():
    """Zero-unsanctioned-swallow gate over the port's handler sites."""
    yield
    if _MODES["errflow"] != "0":
        from karpenter_tpu_torch.analysis import errwitness

        errwitness.flush()
        assert not errwitness.swallows(unsanctioned_only=True), errwitness.report()


@pytest.fixture(scope="session", autouse=True)
def port_torch_witness():
    """Zero-violation gate: no library build or load, no graph capture
    outside the ladder, and no unsanctioned sync inside a hot() section."""
    yield
    if _MODES["torch"] != "0":
        from karpenter_tpu_torch.analysis import torch_witness

        assert not torch_witness.hot_violations(), torch_witness.report()


def pytest_terminal_summary(terminalreporter):
    c = counts()
    terminalreporter.write_line(
        "port witnesses: " + " ".join(f"{k}={v}" for k, v in c.items()))
