"""A whole run on the CPU (the harness past its look for a card) comes
out correct, and comes out not correct with the timed path broken
underneath by each fault of benchmark/faults.py."""
import copy
import io
import json
from pathlib import Path

import pytest

import faults
import harness
from small import manifest

DOC = manifest()


def run(cell, seed=2**31 + 17):
    return harness.run(cell, seed, 1.0, False, device="cpu", doc=DOC, out=io.StringIO())


def test_sound_runs_are_correct():
    for cell in ("np1-small.burst", "np1-small.wave", "spot-od-small.steady"):
        doc = run(cell)
        assert doc["correct"], doc["checks"]
        assert doc["attempted"] >= 1 and doc["failed"] == 0
        assert list(doc)[-1] == "checks"


CELL_OF = {"scan_unchanged": "np1-small.burst", "scan_altered": "np1-small.burst",
           "batch_half": "np1-small.burst", "full_repack_unchanged": "np1-small.wave",
           "repack_unchanged": "spot-od-small.steady", "sets_half": "spot-od-small.steady",
           "replace_altered": "spot-od-small.steady"}


@pytest.mark.parametrize("fault", sorted(CELL_OF))
def test_a_broken_path_is_not_correct(fault):
    harness.program.load(harness.cache_dirs())
    with faults.planted(fault):
        doc = run(CELL_OF[fault])
    assert not doc["correct"], doc["checks"]


@pytest.mark.parametrize("cell", ["spot-od-small.burst", "spot-od-small.wave"])
def test_two_pool_runs_take_the_merged_route_and_are_correct(cell):
    log = io.StringIO()
    doc = harness.run(cell, 2**31 + 29, 1.0, False, device="cpu", doc=DOC, out=log)
    assert doc["correct"], doc["checks"]
    assert all(v["value"] == 0 for v in doc["checks"].values())
    routes = json.dumps({"merged": doc["attempted"]})
    assert f"routes: {routes}" in log.getvalue()


@pytest.mark.parametrize("fault", ["pools_reversed", "reserve_dropped"])
def test_a_broken_merged_route_moves_nodes(fault):
    harness.program.load(harness.cache_dirs())
    with faults.planted(fault):
        doc = run("spot-od-small.burst")
    assert doc["checks"]["nodes_differ"]["value"] > 0, doc["checks"]


def test_a_tainted_pool_run_is_correct(tmp_path):
    """The spot pool tainted: only classes that tolerate it open there, and
    the merged route gates joins by the taint as the reference does."""
    config = json.loads((Path(__file__).parent / "data" / "spot-od-small.json").read_text())
    config["pools"][0]["taints"] = [["dedicated", "", "NoSchedule"]]
    (tmp_path / "tainted.json").write_text(json.dumps(config))
    doc = copy.deepcopy(DOC)
    doc["configs"].append({"name": "tainted", "file": str(tmp_path / "tainted.json")})
    doc["workloads"].append({"name": "tainted.burst", "config": "tainted", "traffic": "burst",
                             "chips": 1})
    got = harness.run("tainted.burst", 2**31 + 3, 1.0, False, device="cpu", doc=doc,
                      out=io.StringIO())
    assert got["correct"], got["checks"]
