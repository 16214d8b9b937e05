"""The check fails its control: the plain reference in bfloat16, the
precision next below the configurations' float32, put in the program's
place (benchmark/control.py; on the card at the cells' own size, here at
a test size)."""
import pytest

import control
import harness
from small import CELLS, manifest

DOC = manifest()


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_the_check(cell):
    numbers = control.readings(cell, 12345, doc=DOC)
    limits = harness.LIMITS[harness.cell_files(DOC, cell)[2]["kind"]]
    assert any(v > limits[k] for k, v in numbers.items()), numbers
