"""A whole run on the CPU (the harness past its look for a card) comes
out correct, and comes out not correct with the timed path broken
underneath by each fault of benchmark/faults.py."""
import io

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
