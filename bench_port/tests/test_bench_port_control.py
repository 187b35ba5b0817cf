"""The control comes out not correct: the reference put in the program's
place and computed in TF32 (its convolutions' and dense layers' operands
rounded to TF32) fails at least one of its cell's numbers, on the card at
a size a test run holds.  ``bench_port/control.py`` takes the same
readings at the cells' own sizes.  Run on the card with

    python -m pytest bench_port/tests/test_bench_port_control.py -m cuda
"""
import pytest

from conftest import CELLS, ROOT, small_cell


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_a_number(card, name):
    from bench_port import control

    cell = small_cell(name)
    limits = cell.traffic["limits"]
    for found in control.control_readings(cell, [301, 302, 303], card, ROOT):
        for label, gaps in found.items():
            assert any(gaps[k] > limits[k] for k in limits), (label, gaps)
