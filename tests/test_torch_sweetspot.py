"""Port vs reference: the sweet-spot report (``eval/sweetspot.py``) and its
serializer (``eval/report.py``).

The sweep is pure cost-model arithmetic, so the contract is EQUALITY: with
``crosscheck=False`` the port's ``to_json(build_report(...))`` is the
reference's string, character for character, and so is ``to_markdown``;
``winners``, ``crossovers`` and ``grid_fidelity`` are equal field for
field.  ``kernel_crosscheck`` on CPU tensors runs the ``*_cuda`` mirrors'
plain versions against the simulators: every row ``output_ok`` and
``cycles_ok``, and each row equals the reference's Pallas row but for the
kernel's name.  ``write`` writes both files into the directory it is
given (a ``tmp_path`` here).
"""

import dataclasses
import json

import pytest

from repro.eval import report as ref_report
from repro.eval import sweetspot as ref_sweetspot
from repro_torch import eval as port_eval
from repro_torch.eval import report as port_report
from repro_torch.eval import sweetspot as port_sweetspot

SWEEPS = {
    "default": {},
    "narrow": dict(bits_list=(4,), sizes=(32, 64)),
    "off-grid": dict(bits_list=(2, 8), sizes=(8, 48, 100, 512),
                     designs=("tubgemm", "bgemm")),
}


def test_exports_match_reference():
    assert set(port_sweetspot.__all__) == set(ref_sweetspot.__all__)
    assert port_report.__all__ == ref_report.__all__
    assert port_eval.__all__ == ["planner", "report", "sweetspot"]
    assert port_sweetspot.METRICS == ref_sweetspot.METRICS
    assert port_sweetspot.DEFAULT_BITS == ref_sweetspot.DEFAULT_BITS
    assert port_sweetspot.DEFAULT_SIZES == ref_sweetspot.DEFAULT_SIZES
    assert port_sweetspot.CALIBRATED_DESIGNS == ref_sweetspot.CALIBRATED_DESIGNS


@pytest.mark.parametrize("case", sorted(SWEEPS))
def test_report_json_equals_reference(case):
    kw = SWEEPS[case]
    port = port_sweetspot.build_report(crosscheck=False, **kw)
    ref = ref_sweetspot.build_report(crosscheck=False, **kw)
    assert port_report.to_json(port) == ref_report.to_json(ref)
    assert port_report.to_markdown(port) == ref_report.to_markdown(ref)
    assert json.loads(port_report.to_json(port))["schema"] == \
        "repro.eval.sweetspot/v1"


@pytest.mark.parametrize("case", sorted(SWEEPS))
def test_winners_crossovers_fidelity_equal_reference(case):
    kw = SWEEPS[case]
    pts = port_sweetspot.sweep(**kw)
    ref_pts = ref_sweetspot.sweep(**kw)
    assert [dataclasses.asdict(p) for p in pts] == \
        [dataclasses.asdict(p) for p in ref_pts]
    assert [dataclasses.asdict(w) for w in port_sweetspot.winners(pts)] == \
        [dataclasses.asdict(w) for w in ref_sweetspot.winners(ref_pts)]
    assert [dataclasses.asdict(c) for c in port_sweetspot.crossovers(pts)] == \
        [dataclasses.asdict(c) for c in ref_sweetspot.crossovers(ref_pts)]
    assert port_sweetspot.grid_fidelity(pts) == \
        ref_sweetspot.grid_fidelity(ref_pts)
    grid = port_sweetspot.winner_grid(pts)
    ref_grid = ref_sweetspot.winner_grid(ref_pts)
    assert grid.keys() == ref_grid.keys()
    for metric in grid:
        assert {k: w.design for k, w in grid[metric].items()} == \
            {k: w.design for k, w in ref_grid[metric].items()}


def test_paper_grid_is_reproduced_exactly():
    """Grid hits are the published tables: area and power exact, the derived
    energy and ADP under the repo-wide 1 % bar; the paper's 4-bit energy
    takeover of tubGEMM over bGEMM appears on the frontier."""
    fid = port_sweetspot.grid_fidelity(port_sweetspot.sweep())
    assert fid["area_um2"] == fid["power_mw"] == 0.0
    assert fid["energy_nj"] < 0.01 and fid["adp_mm2_ns"] < 0.01
    assert any(c.metric == "energy_nj" and c.bits == 4
               for c in port_sweetspot.crossovers(port_sweetspot.sweep()))


@pytest.mark.parametrize("seed", [0, 3])
def test_kernel_crosscheck_on_cpu(seed):
    rows = port_sweetspot.kernel_crosscheck(seed=seed, device="cpu")
    ref_rows = ref_sweetspot.kernel_crosscheck(seed=seed)
    assert len(rows) == len(ref_rows) == 6
    for row, ref_row in zip(rows, ref_rows):
        assert row["output_ok"] and row["cycles_ok"], row
        assert row["kernel"] == ref_row["kernel"].replace("_pallas", "_cuda")
        assert {k: v for k, v in row.items() if k != "kernel"} == \
            {k: v for k, v in ref_row.items() if k != "kernel"}
    # the reference's Pallas block keyword is accepted (and has no effect)
    assert port_sweetspot.kernel_crosscheck(
        bits_list=(4,), mkn=(3, 40, 5), block=(8, 8, 8), device="cpu") == \
        port_sweetspot.kernel_crosscheck(bits_list=(4,), mkn=(3, 40, 5),
                                         device="cpu")


def test_report_with_crosscheck_and_write(tmp_path):
    report = port_sweetspot.build_report(bits_list=(4,), sizes=(32, 64),
                                         device="cpu")
    ref = ref_sweetspot.build_report(bits_list=(4,), sizes=(32, 64))
    assert len(report.kernel_crosscheck) == 2
    md = port_report.to_markdown(report)
    # identical but for the kernels' names and the section title
    assert md.replace("_cuda", "_pallas").replace("CUDA kernel", "Pallas kernel") \
        == ref_report.to_markdown(ref)
    json_path, md_path = port_report.write(report, tmp_path / "out",
                                           stem="sweep")
    assert json_path == str(tmp_path / "out" / "sweep.json")
    assert json.loads(open(json_path).read()) == \
        json.loads(port_report.to_json(report))
    assert open(md_path).read() == md
