"""A whole run on the CPU, past the harness's look for a card, with the timed
path broken underneath: ``correct`` comes out false for each fault a served
cell can have, and true for the sound program.  The cells' own limits, on a
two-layer model of width 256 (``smoke_cells.WIDER``)."""

import time

import pytest

from bench import faults, serve
from bench.tests import smoke_cells

CELLS = ["phi3-mini-3.8b.docqa", "internlm2-1.8b.longdoc"]


def _run(cell_name: str, seed: int = 2**31 + 101) -> dict:
    cell = smoke_cells.cell(cell_name, configuration=dict(
        smoke_cells.WIDER, name=cell_name))
    return serve.run_cell(cell, seed, 0.0, False, t_start=time.perf_counter(),
                          metrics=[], device="cpu", plan=smoke_cells.PLAN)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    out = _run(cell)
    assert out["correct"], out["check"]
    assert out["failed"] == 0 and out["attempted"] > 0
    assert list(out)[-1] == "check"


@pytest.mark.parametrize("fault", list(faults.FAULTS), ids=lambda f: "_" + f)
@pytest.mark.parametrize("cell", CELLS)
def test_faulty_run_is_not_correct(cell, fault):
    with faults.FAULTS[fault]():
        out = _run(cell)
    assert not out["correct"], out["check"]
