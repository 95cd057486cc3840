"""The control: the reference in TF32 put in the program's place comes out
not correct under each cell's limits, at a size a CPU test run holds (TF32
emulated by rounding the float products' operands to its 10-bit mantissa),
judged by the check's own ``judge``.  On the card the control runs at each
cell's own size: ``bench/control.py``."""

import pytest
import torch

from bench import control
from bench.tests import smoke_cells


@pytest.mark.parametrize("cell", ["phi3-mini-3.8b.docqa",
                                  "internlm2-1.8b.longdoc"])
def test_tf32_control_is_not_correct(cell):
    c = smoke_cells.cell(cell, configuration=dict(smoke_cells.WIDER, name=cell),
                         prompt=[40, 90])
    program, ctl = control.readings(c, 2**31 + 77, torch.device("cpu"),
                                    plan=smoke_cells.PLAN)
    assert (program["side"], ctl["side"]) == ("program", "control")
    assert program["correct"], program
    assert not ctl["correct"], ctl
    limits = c["check"]["limits"]
    assert set(ctl["check"]) == set(limits)
