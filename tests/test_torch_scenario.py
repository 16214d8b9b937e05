"""The port's scenario generators and shrinker against the JAX package's,
on the CPU.

- `build_scenario(name, seed)` gives the same event list as the JAX
  package's for every name in `STANDARD_SCENARIOS`, at `DEFAULT_SEED` and
  two other seeds;
- `python -m karpenter_tpu_torch sim generate --all --out DIR` writes
  files byte-equal to the committed tests/golden/scenarios/*.jsonl;
- `ddmin` and `shrink_to_repro` give the same minimal trace, the same
  files and the same probe count as the JAX functions for one synthetic
  failing predicate on diurnal-small;
- the `shrink` verb on a trace that does not fail prints the JAX
  "nothing to shrink" line and exits 1.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax  # noqa: F401  -- both frameworks in one process
import pytest

from karpenter_tpu.sim import cli as jcli
from karpenter_tpu.sim import scenario as jscenario
from karpenter_tpu.sim import shrink as jshrink
from karpenter_tpu_torch import metrics as tmetrics
from karpenter_tpu_torch.sim import scenario as tscenario
from karpenter_tpu_torch.sim import shrink as tshrink

REPO = Path(__file__).resolve().parent.parent
GOLDEN = REPO / "tests" / "golden" / "scenarios"
SEEDS = (jscenario.DEFAULT_SEED, 1, 7)


def test_scenario_tables_alike():
    assert sorted(tscenario.STANDARD_SCENARIOS) == sorted(jscenario.STANDARD_SCENARIOS)
    assert tscenario.CORPUS_SCENARIOS == jscenario.CORPUS_SCENARIOS
    assert tscenario.DEFAULT_SEED == jscenario.DEFAULT_SEED
    assert tscenario.SIZES == jscenario.SIZES
    assert tscenario._cheap_types() == jscenario._cheap_types()


@pytest.mark.parametrize("name", sorted(jscenario.STANDARD_SCENARIOS))
def test_build_scenario_equal(name):
    for seed in SEEDS:
        want = jscenario.build_scenario(name, seed=seed)
        got = tscenario.build_scenario(name, seed=seed)
        assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True), (name, seed)


def test_generate_all_rebuilds_the_corpus(tmp_path):
    r = subprocess.run(
        [sys.executable, "-m", "karpenter_tpu_torch", "sim", "generate", "--all",
         "--out", str(tmp_path)],
        cwd=str(REPO), capture_output=True, text=True, timeout=240,
        env=dict(os.environ, PYTHONPATH=str(REPO)))
    assert r.returncode == 0, r.stderr[-2000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert sorted(out["generated"]) == sorted(jscenario.CORPUS_SCENARIOS)
    for name in jscenario.CORPUS_SCENARIOS:
        assert (tmp_path / f"{name}.jsonl").read_bytes() == (GOLDEN / f"{name}.jsonl").read_bytes()


def test_generate_without_a_name():
    r = subprocess.run(
        [sys.executable, "-m", "karpenter_tpu_torch", "sim", "generate"],
        cwd=str(REPO), capture_output=True, text=True, timeout=240,
        env=dict(os.environ, PYTHONPATH=str(REPO)))
    assert r.returncode == 2
    assert json.loads(r.stdout) == {"error": "name a scenario or pass --all",
                                    "scenarios": sorted(jscenario.STANDARD_SCENARIOS)}


def failing_predicate(counter):
    """Fails while the trace still holds the arrival of a pod whose name
    ends in 3 or 7, an advance after it, and at least two pod events."""
    def failing(events):
        counter.append(len(events))
        arrivals = [i for i, e in enumerate(events) if e.get("ev") == "pod_add"
                    and e["pod"]["name"].endswith(("3", "7"))]
        if not arrivals:
            return False
        later = any(e.get("ev") == "advance" for e in events[arrivals[0]:])
        busy = sum(1 for e in events if e.get("ev", "").startswith("pod")) >= 2
        return later and busy
    return failing


def test_ddmin_equal():
    events = tscenario.build_scenario("diurnal-small", seed=tscenario.DEFAULT_SEED)
    jprobes, tprobes = [], []
    rounds0 = tmetrics.SIM_SHRINK_ROUNDS.value()
    want = jshrink.ddmin(events, failing_predicate(jprobes))
    got = tshrink.ddmin(events, failing_predicate(tprobes))
    assert got == want and tprobes == jprobes
    assert len(got) < len(events) and got[0]["ev"] == "header"
    # every probe counts one reduction attempt
    assert tmetrics.SIM_SHRINK_ROUNDS.value() - rounds0 == len(tprobes)


def test_shrink_to_repro_equal(tmp_path):
    events = tscenario.build_scenario("diurnal-small", seed=tscenario.DEFAULT_SEED)
    jprobes, tprobes = [], []
    jpath = jshrink.shrink_to_repro(events, failing_predicate(jprobes), str(tmp_path / "jax"),
                                    "diurnal-small", max_probes=40)
    tpath = tshrink.shrink_to_repro(events, failing_predicate(tprobes), str(tmp_path / "torch"),
                                    "diurnal-small", max_probes=40)
    assert tprobes == jprobes
    assert Path(tpath).read_bytes() == Path(jpath).read_bytes()
    meta = "diurnal-small-shrunk.meta.json"
    assert (tmp_path / "torch" / meta).read_bytes() == (tmp_path / "jax" / meta).read_bytes()
    # nothing to shrink: None, nothing written
    assert tshrink.shrink_to_repro(events, lambda ev: False, str(tmp_path / "none"),
                                   "x") is None
    assert not (tmp_path / "none").exists()


def test_shrink_verb_on_a_passing_trace(tmp_path, capsys):
    trace = str(GOLDEN / "binpack-adversarial-convex.jsonl")
    args = ["shrink", trace, "--mode", "invariant", "--backend", "host",
            "-o", str(tmp_path / "out")]
    assert jcli.main(args) == 1
    want = capsys.readouterr().out.strip().splitlines()[-1]
    r = subprocess.run(
        [sys.executable, "-m", "karpenter_tpu_torch", "sim", *args, "--device", "cpu"],
        cwd=str(REPO), capture_output=True, text=True, timeout=240,
        env=dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1"))
    assert r.returncode == 1, r.stderr[-2000:]
    got = r.stdout.strip().splitlines()[-1]
    assert got == want
    assert json.loads(got)["note"] == "trace does not fail; nothing to shrink"
