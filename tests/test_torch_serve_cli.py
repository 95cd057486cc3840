"""The port's serving CLI, in process, on ``--device cpu --smoke``: the
``plan`` mode writes a plan that loads and lints clean against the model's
sites; ``traffic`` and the one-shot ``serve`` mode replay it (also from
packed stores); ``serve --execute-backend`` reports bit-exact integer GEMMs;
what the port does not have yet (``--stream-lens``, ``--grid``, grid plan
files) exits 2 and names the slice that brings it."""

import pathlib

import pytest

from repro_torch import backends
from repro_torch.analysis import plan_lint
from repro_torch.launch import serve

ROOT = pathlib.Path(__file__).resolve().parents[1]
BASE = ["--smoke", "--device", "cpu"]


@pytest.fixture(scope="module")
def planned(tmp_path_factory):
    path = tmp_path_factory.mktemp("plan") / "plan.json"
    assert serve.main(["plan", *BASE, "--batch", "2", "--plan-out",
                       str(path)]) == 0
    return path


def test_plan_mode_writes_a_clean_plan(planned):
    plan = backends.load_plan(planned)
    sites = [e.pattern for e in plan.sites]
    assert len(sites) == 8 and sites[-1] == "lm_head"
    assert plan.metadata()["batch"] == 2
    assert plan_lint.lint_plan(plan, site_names=sites) == []


@pytest.mark.parametrize("mode,extra,expect", [
    ("traffic", ["--packed", "--act-scale", "per-row"], "identical: True"),
    ("serve", ["--packed", "--tokens", "4"], "bit-exact"),
    ("serve", ["--tokens", "4"], "per-decode-token cycle totals")])
def test_plan_replay(planned, capsys, mode, extra, expect):
    assert serve.main([mode, *BASE, "--backend-plan", str(planned),
                       *extra]) == 0
    out = capsys.readouterr().out
    assert expect in out
    assert "analysis: OK" in out or mode == "traffic"


def test_serve_execute_backend_packed_is_bit_exact(capsys):
    assert serve.main(["serve", *BASE, "--execute-backend", "tubgemm",
                       "--packed", "--tokens", "4"]) == 0
    out = capsys.readouterr().out
    assert "int GEMMs vs binary oracle: bit-exact" in out
    assert "sweet-spot (4-bit" in out and "weight sparsity (4-bit)" in out


@pytest.mark.parametrize("argv,names", [
    (["plan", "--stream-lens", "16"], "stochastic slice"),
    (["serve", "--grid", "2,2"], "grids slice"),
    (["traffic", "--backend-plan",
      str(ROOT / "examples" / "plans" / "llama3_8b_smoke.grid2x2.json")],
     "grids slice"),
    (["serve", "--packed"], "--packed needs"),
    (["serve", "--execute-backend", "tubgemm", "--backend-plan",
      str(ROOT / "examples" / "plans" / "llama3_8b_smoke.plan.json")],
     "not both")])
def test_unported_and_conflicting_options_exit_2(capsys, argv, names):
    assert serve.main([*argv, *BASE]) == 2
    assert names in capsys.readouterr().out
