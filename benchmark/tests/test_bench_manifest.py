"""BENCHMARK.json keeps to the contract's shape, and every cell's
configuration, traffic mix and per-layer reader resolves by name."""
import json
import re
from pathlib import Path

import pytest

import harness

ROOT = Path(__file__).resolve().parents[2]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")

DOC = json.loads((ROOT / "BENCHMARK.json").read_text())


def test_top_level_keys():
    assert set(DOC) == {"command", "paths", "run_seconds", "configs", "workloads",
                        "end_to_end", "per_layer"}
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= DOC["run_seconds"] <= 51 and isinstance(DOC["run_seconds"], int)
    assert 1 <= len(DOC["command"]) <= 32
    for p in DOC["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
        assert not p.endswith("_torch")
    for word in DOC["command"]:
        assert TEXT.match(word) and not word.startswith("/")


def test_names_units_and_text():
    names = []
    for c in DOC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and TEXT.match(c["source"]) and TEXT.match(c["why"])
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
        names.append(c["name"])
    for w in DOC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and TEXT.match(w["why"])
        names.append(w["name"])
    for m in DOC["end_to_end"] + DOC["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        names.append(m["name"])
    assert len(names) == len(set(names))


def test_metrics_shape():
    cells = {w["name"] for w in DOC["workloads"]}
    e2e = {m["name"]: m for m in DOC["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in DOC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
        assert set(m.get("workloads", cells)) <= cells
    for m in DOC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert TEXT.match(m["layer"]) and m["moves"] in e2e
        # listed only in cells that report the metric it moves
        assert set(m["workloads"]) <= set(e2e[m["moves"]].get("workloads", cells))
        if m["name"].endswith("_roofline") or "_roofline." in m["name"]:
            assert m["unit"] == "%"
    for w in cells:
        reported = [m for m in DOC["end_to_end"] if w in m.get("workloads", cells)]
        assert len(reported) >= 2
        assert any(w in m["workloads"] for m in DOC["per_layer"])


@pytest.mark.parametrize("cell", [w["name"] for w in DOC["workloads"]])
def test_cell_files_resolve(cell):
    c, config, mix = harness.cell_files(DOC, cell)
    assert config["name"] == c["config"]
    assert mix["kind"] in harness.DRIVERS
    for m in DOC["per_layer"]:
        if cell in m["workloads"]:
            assert callable(harness.reader(m["name"]))


def test_config_files_under_paths_and_distinct():
    files = [c["file"] for c in DOC["configs"]]
    assert len(files) == len(set(files))
    for f in files:
        assert any(f.startswith(p + "/") for p in DOC["paths"])
        assert (ROOT / f).is_file()
