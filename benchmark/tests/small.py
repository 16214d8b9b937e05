"""A manifest with test-sized cells beside the real ones: the same mixes
over configurations cut to 3,000 and 5,000 pods (tests/data), the wave cut with them
(tests/data/wave-small.json: 600-pod waves against the nodes of a
3,000-pod tick). The spot-od-small provisioning cells take the merged
route of two weighted pools."""
import copy
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def manifest() -> dict:
    doc = copy.deepcopy(json.loads((ROOT / "BENCHMARK.json").read_text()))
    for name in ("np1-small", "spot-od-small"):
        doc["configs"].append({"name": name, "source": "test", "reduced": [], "why": "test",
                               "file": f"benchmark/tests/data/{name}.json"})
    for cell in CELLS:
        name, traffic = cell.split(".")
        traffic = MIXES.get(traffic, traffic)
        doc["workloads"].append({"name": cell, "config": name, "traffic": traffic, "chips": 1,
                                 "why": "test"})
    return doc


CELLS = ("np1-small.burst", "np1-small.wave", "spot-od-small.steady", "spot-od-small.burst",
         "spot-od-small.wave")
# mixes of the test-sized cells that are not the real cells' own
# (the harness reads benchmark/traffic/<mix>.json)
MIXES = {"wave": "../tests/data/wave-small"}
