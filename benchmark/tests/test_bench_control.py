"""On a card: the control (the plain reference one precision below the
configuration's, in the program's place) fails the comparison, and the
program passes it, at the cell's own size.  Marked `cuda`; skips without
a card.  `python -m pytest benchmark/tests -q -m cuda` (about two minutes
a cell)."""

import pytest
import torch

from benchmark import control as C
from benchmark import run as R
from benchmark.reference import judge as jd


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda:0")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["x2.encode.bf16", "x1_5.encode.bf16",
                                  "x2.decode.bf16"])
def test_control_fails_and_program_passes(cell, card):
    bench = R.load_benchmark()
    ctx = R.find_cell(bench, cell)
    limits = ctx["config"]["limits"]
    (row,) = C.readings(cell, [2 ** 32 + 977], 15.0, card)
    expected = R.ENTRIES[ctx["mix"]["entry"]].NUMBERS
    ok_program, rows = jd.verdict(row["program"], limits, expected)
    assert ok_program, rows
    ctl_expected = tuple(k for k in expected if k in row["control"])
    ok_control, rows = jd.verdict(row["control"], limits, ctl_expected)
    assert not ok_control, rows
