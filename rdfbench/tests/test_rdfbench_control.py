"""The control breaks completeness and the run's own comparison finds it
not correct; the reference in the program's place, uncut, is correct."""
import pytest

from rdfbench.control import control_reading
from rdfbench.tests.tiny import CELLS, tiny_cell


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_comes_out_not_correct(cell):
    for seed in (1, 2, 2**31 + 3):
        # at this size q4chain's answer has about 300 rows; 8 workers of 2
        # rows keep 16
        out = control_reading(tiny_cell(cell), seed, rounds=8, capacity=2)
        assert out["correct"] is False
        c = out["checks"]
        assert c["wrong_answers"]["value"] > c["wrong_answers"]["limit"]
        assert c["compared"]["value"] >= 6


def test_the_reference_uncut_is_correct():
    out = control_reading(tiny_cell("lubm100-w8-na.mix6-closed"), 5,
                          rounds=8, capacity=10**9)
    assert out["correct"] is True
    assert out["checks"]["missing_rows"]["value"] == 0
