"""Nothing the harness or the reference loads is JAX or the JAX package
(top-level names compared whole, so karpenter_tpu_torch, the program,
passes), the reference and the generators load nothing of the program,
and the command refuses to run without a card."""
import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "karpenter_tpu"}


def top_level_after(code: str) -> set:
    prog = (f"import sys; sys.path[:0] = [{str(BENCH)!r}, {str(ROOT)!r}]\n{code}\n"
            "import json; print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", prog], capture_output=True, text=True,
                         timeout=300, check=True).stdout
    return set(json.loads(out.strip().splitlines()[-1]))


def test_harness_and_program_load_no_jax():
    mods = top_level_after(
        "import harness, control, faults, run\n"
        "harness.program.load(harness.cache_dirs())\n"
        "import karpenter_tpu_torch.solver.service, karpenter_tpu_torch.solver.disrupt.engine\n"
        "doc = harness.manifest()\n"
        "[harness.reader(m['name']) for m in doc['per_layer']]")
    assert "karpenter_tpu_torch" in mods
    assert not (mods & FORBIDDEN)


def test_reference_and_generators_load_nothing_of_the_program():
    mods = top_level_after(
        "import reference.common, reference.ffd, reference.sweep, roofline.counts\n"
        "import gen.catalog, gen.pods, gen.sweep, gen.traffic")
    assert "karpenter_tpu_torch" not in mods
    assert not (mods & FORBIDDEN)


def test_no_card_no_result(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the command would run")
    cmd = [sys.executable, "benchmark/run.py", "--workload", "np1-50k.wave", "--seed", "1",
           "--seconds", "1", "--trace", "0"]
    r = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0 and r.stdout.strip() == ""
    # a directory with only BENCHMARK.json and the benchmark's files fails too
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(BENCH, tmp_path / "benchmark", ignore=shutil.ignore_patterns(".cache"))
    r = subprocess.run(cmd, cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0 and r.stdout.strip() == ""
