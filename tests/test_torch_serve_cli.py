"""The port's serving CLI, in process, on ``--device cpu --smoke``: the
``plan`` mode writes a plan that loads and lints clean against the model's
sites; ``traffic`` and the one-shot ``serve`` mode replay it (also from
packed stores); ``serve --execute-backend`` reports bit-exact integer GEMMs;
``--execute-backend ugemm`` and ``ugemm_stochastic:16`` execute prefill and
decode and report against their oracles; ``plan --stream-lens`` admits
rate-coded candidates; ``plan --grid 2,2`` writes a grid plan that
``traffic`` and ``serve`` replay on the 2x2 grid (so does a flat plan or a
backend with ``--grid``); a ``--grid`` that conflicts with a grid plan's
own, or is malformed, exits 2."""

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
    (["serve", "--grid", "2,0"], "grid must be >= 1x1"),
    (["traffic", "--grid", "4,1", "--backend-plan",
      str(ROOT / "examples" / "plans" / "llama3_8b_smoke.grid2x2.json")],
     "conflicts with the grid plan's own grid"),
    (["serve", "--packed"], "--packed needs"),
    (["serve", "--execute-backend", "tubgemm", "--backend-plan",
      str(ROOT / "examples" / "plans" / "llama3_8b_smoke.plan.json")],
     "not both")])
def test_unported_and_conflicting_options_exit_2(capsys, argv, names):
    assert serve.main([*argv, *BASE]) == 2
    assert names in capsys.readouterr().out


@pytest.mark.parametrize("spec,oracle", [
    ("ugemm", "int GEMMs vs binary oracle: relRMSE"),
    ("ugemm_stochastic:16", "int GEMMs vs exact-uGEMM oracle: relRMSE")])
def test_serve_execute_backend_ugemm_family(capsys, spec, oracle):
    assert serve.main(["serve", *BASE, "--execute-backend", spec,
                       "--tokens", "4"]) == 0
    out = capsys.readouterr().out
    assert oracle in out and "(stochastic design)" in out
    assert ("L=16 bitstreams" in out) == (":" in spec)


@pytest.mark.parametrize("spec", ["ugemm", "ugemm_stochastic:16"])
def test_traffic_execute_backend_ugemm_family(capsys, spec):
    assert serve.main(["traffic", *BASE, "--execute-backend", spec,
                       "--act-scale", "per-row", "--requests", "6"]) == 0
    out = capsys.readouterr().out
    assert f"backend {spec}@4" in out
    assert "per-request token streams identical: True" in out


@pytest.mark.parametrize("lens", ["16", "16,32"])
def test_plan_stream_lens_runs(tmp_path, capsys, lens):
    # the rate-coded candidates join the plan (this case exited 2 while the
    # port had no stochastic uGEMM)
    path = tmp_path / "plan.json"
    assert serve.main(["plan", "--stream-lens", lens, *BASE, "--batch", "2",
                       "--plan-out", str(path)]) == 0
    out = capsys.readouterr().out
    assert "analysis: OK" in out
    plan = backends.load_plan(path)
    meta = plan.metadata()
    assert meta["stream_lens"] == [int(x) for x in lens.split(",")]
    assert meta["designs"][-1] == "ugemm_stochastic"
    sites = [e.pattern for e in plan.sites]
    assert plan_lint.lint_plan(plan, site_names=sites) == []
    assert serve.main(["serve", *BASE, "--backend-plan", str(path),
                       "--tokens", "2"]) == 0


def test_backend_plan_with_stream_entries_replays(tmp_path, capsys):
    plan = backends.BackendPlan(sites=(
        backends.SiteAssignment("layers/mlp/*", "ugemm_stochastic", 4,
                                stream_len=16),
        backends.SiteAssignment("layers/attn/*", "tubgemm", 4)))
    path = plan.save(str(tmp_path / "plan.json"))
    assert serve.main(["serve", *BASE, "--backend-plan", path,
                       "--tokens", "2"]) == 0
    out = capsys.readouterr().out
    assert "(tubgemm@4, ugemm_stochastic@4:16)" in out
    assert "int GEMMs vs exact-uGEMM oracle on ugemm_stochastic@4:16" in out
    assert "int GEMMs vs binary oracle on tubgemm@4: bit-exact" in out


@pytest.fixture(scope="module")
def grid_planned(tmp_path_factory):
    path = tmp_path_factory.mktemp("grid") / "grid_plan.json"
    assert serve.main(["plan", *BASE, "--batch", "2", "--grid", "2,2",
                       "--plan-out", str(path)]) == 0
    return path


def test_grid_plan_mode_writes_a_clean_grid_plan(grid_planned):
    gplan = backends.load_plan(grid_planned)
    assert isinstance(gplan, backends.GridPlan) and gplan.grid == (2, 2)
    sites = [e.pattern for e in gplan.aggregate.sites]
    assert len(sites) == 8 and [k for k, _ in gplan.shards] == \
        ["0,0", "0,1", "1,0", "1,1"]
    assert plan_lint.lint_plan(gplan, site_names=sites) == []


@pytest.mark.parametrize("mode,extra,expect", [
    ("traffic", ["--act-scale", "per-row"], "identical: True"),
    ("traffic", ["--packed", "--act-scale", "per-row"], "identical: True"),
    ("serve", ["--tokens", "4"], "per-decode-token per-shard cycle totals")])
def test_grid_plan_replay(grid_planned, capsys, mode, extra, expect):
    assert serve.main([mode, *BASE, "--backend-plan", str(grid_planned),
                       *extra]) == 0
    out = capsys.readouterr().out
    assert expect in out and "2x2 grid" in out
    if mode == "serve":
        assert "int GEMMs vs unsharded binary oracle" in out
        assert "bit-exact" in out


@pytest.mark.parametrize("argv,expect", [
    (["traffic", "--grid", "2,2", "--act-scale", "per-row"], "identical: True"),
    (["serve", "--execute-backend", "tubgemm", "--grid", "2x2", "--tokens",
      "4"], "int GEMMs vs binary oracle: bit-exact")])
def test_flat_plan_and_backend_on_a_grid(planned, capsys, argv, expect):
    extra = ["--backend-plan", str(planned)] if argv[0] == "traffic" else []
    assert serve.main([*argv, *BASE, *extra]) == 0
    out = capsys.readouterr().out
    assert expect in out and "2x2 grid" in out
