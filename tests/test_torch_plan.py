"""Port vs reference: the per-site ``BackendPlan`` and its scope.

Contracts: site-pattern precedence (exact beats glob, most literal glob
wins, ties go to the earliest entry, ``*`` crosses ``/``, no match means the
float path) picks the same entry in both packages; the example flat plan
loads and re-serialises byte-identically in both, and so does the example
grid plan (``load_plan`` sniffs either schema); ``use_plan`` runs each site
on its own entry's backend (grid-wrapped under ``grid=``) and leaves
unmatched sites on the plain float matmul, also under ``cfg.quant_kernel``.
"""

import pathlib

import numpy as np
import pytest
import torch

from repro.backends import plan as ref_plan
from repro_torch import backends as port_backends
from repro_torch import configs as port_configs
from repro_torch.backends import plan as port_plan
from repro_torch.models import model as port_model

ROOT = pathlib.Path(__file__).resolve().parents[1]
FLAT = ROOT / "examples" / "plans" / "llama3_8b_smoke.plan.json"
GRID = ROOT / "examples" / "plans" / "llama3_8b_smoke.grid2x2.json"

# (entries as (pattern, design, bits), site, index of the winning entry)
PRECEDENCE = {
    "exact-beats-glob": ([("layers/*", "tugemm", 4),
                          ("layers/attn/wq", "bgemm", 8),
                          ("layers/attn/w?", "tubgemm", 2)],
                         "layers/attn/wq", 1),
    "most-literal-glob-wins": ([("*", "bgemm", 8),
                                ("layers/*", "tugemm", 4),
                                ("layers/mlp/*", "tubgemm", 4)],
                               "layers/mlp/w_up", 2),
    "tie-goes-to-earliest": ([("layers/attn/w?", "tubgemm", 4),
                              ("layers/att?/wq", "bgemm", 4)],
                             "layers/attn/wq", 0),
    "star-crosses-slash": ([("*w_down", "bgemm", 8)],
                           "layers/mlp/w_down", 0),
    "no-match-means-float": ([("layers/attn/*", "tubgemm", 4)],
                             "lm_head", None),
}


@pytest.mark.parametrize("case", sorted(PRECEDENCE))
def test_pattern_precedence_equal(case):
    entries, site, want = PRECEDENCE[case]
    picked = []
    for mod in (ref_plan, port_plan):
        plan = mod.BackendPlan(sites=tuple(
            mod.SiteAssignment(pattern=p, design=d, bits=b)
            for p, d, b in entries))
        entry = plan.assignment_for(site)
        picked.append(None if entry is None else plan.sites.index(entry))
        backend = plan.backend_for(site)
        if want is None:
            assert backend is None
        else:
            assert (backend.name, backend.bits) == entries[want][1:]
    assert picked == [want, want]


def test_example_plan_json_byte_equal():
    ref = ref_plan.BackendPlan.load(FLAT)
    port = port_backends.load_plan(FLAT)
    assert port.to_json() == ref.to_json()
    assert port_plan.BackendPlan.from_json(port.to_json()) == port
    assert [(s.pattern, s.design, s.bits) for s in port.sites] == \
        [(s.pattern, s.design, s.bits) for s in ref.sites]
    assert port.metadata() == ref.metadata()


def test_save_load_and_validation(tmp_path):
    plan = port_backends.load_plan(FLAT)
    assert port_backends.load_plan(plan.save(tmp_path / "p.json")) == plan
    with pytest.raises(ValueError, match="schema"):
        port_plan.BackendPlan.from_json('{"schema": "nope", "sites": []}')
    with pytest.raises(ValueError, match="bits"):
        port_plan.BackendPlan.from_json(
            '{"schema": "%s", "sites": [{"pattern": "x", "design": "bgemm"}]}'
            % port_plan.SCHEMA)
    with pytest.raises(ValueError, match="unknown site fields"):
        port_plan.BackendPlan.from_json(
            '{"schema": "%s", "sites": [{"pattern": "x", "design": "bgemm",'
            ' "bits": 4, "shards": 2}]}' % port_plan.SCHEMA)


def test_grid_plan_and_stream_entries_raise():
    # the example grid plan loads as a GridPlan equal to the reference's
    from repro.backends import grid as ref_grid
    gplan = port_backends.load_plan(GRID)
    assert isinstance(gplan, port_backends.GridPlan) and gplan.grid == (2, 2)
    assert gplan.to_json() == ref_grid.load_plan(GRID).to_json()
    # a stream-coded entry resolves to its rate-coded backend
    entry = port_plan.SiteAssignment(pattern="x", design="ugemm_stochastic",
                                     bits=4, stream_len=32)
    be = entry.backend()
    assert (be.name, be.bits, be.stream_len, be.pricing_design) == \
        ("ugemm_stochastic", 4, 32, "ugemm")
    assert be.cycle_scale == 2.0 and be.cycles(4096) == 32
    # grid= wraps every entry of a flat plan in a 2x2 grid backend
    with port_backends.use_plan(FLAT, grid=(2, 2)) as ex:
        grid_be = ex.backend_for("layers/attn/wq")
    assert isinstance(grid_be, port_backends.GridBackend)
    assert grid_be.grid == (2, 2)
    # a grid plan brings its own grid; another one next to it is refused
    with pytest.raises(ValueError, match="conflicts"):
        with port_backends.use_plan(GRID, grid=(4, 1)):
            pass


@pytest.fixture(scope="module")
def smoke():
    cfg = port_configs.get_smoke_config("llama3-8b").replace(
        compute_dtype="float32")
    gen = torch.Generator().manual_seed(0)
    params = port_model.init_params(cfg, gen, device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 7)).astype(np.int32))
    return cfg, params, tokens


def test_use_plan_runs_each_site_on_its_entry(smoke):
    cfg, params, tokens = smoke
    plan = port_plan.BackendPlan(sites=(
        port_plan.SiteAssignment("layers/attn/*", "tubgemm_cuda", 4),
        port_plan.SiteAssignment("layers/mlp/w_down", "bgemm", 8),
        port_plan.SiteAssignment("lm_head", "tugemm", 2)))
    outs = []
    with port_backends.use_plan(plan, on_output=lambda s, o: outs.append(s)) as ex:
        assert port_backends.active_backend() is None
        port_model.forward(params, cfg, tokens)
    ran = {(c.site, c.backend, c.bits) for c in ex.calls}
    assert ran == {(f"layers/attn/{w}", "tubgemm_cuda", 4)
                   for w in ("wq", "wk", "wv", "wo")} | {
        ("layers/mlp/w_down", "bgemm", 8), ("lm_head", "tugemm", 2)}
    assert outs == [c.site for c in ex.calls]
    assert len(ex.calls) == 5 * cfg.num_layers + 1


@pytest.mark.parametrize("quant_kernel", [False, True])
def test_unmatched_sites_run_the_float_matmul(smoke, quant_kernel):
    cfg, params, tokens = smoke
    if quant_kernel:
        cfg = cfg.replace(quant_bits=4, quant_kernel=True)
    plan = port_plan.BackendPlan(sites=(
        port_plan.SiteAssignment("nothing/matches", "tubgemm", 4),))
    with port_backends.use_plan(plan) as ex:
        logits, _ = port_model.forward(params, cfg, tokens)
    assert ex.calls == []
    # a live scope owns execution: wo and lm_head go through dense as flat
    # GEMMs, all on the plain float matmul, never the quant_kernel path
    with port_backends.record_sites() as rec:
        float_logits, _ = port_model.forward(params, cfg.replace(
            quant_kernel=False), tokens)
    assert len(rec.calls) == 7 * cfg.num_layers + 1
    assert torch.equal(logits, float_logits)


def test_plan_envelope_is_checked_on_entry():
    plan = port_plan.BackendPlan(sites=(port_plan.SiteAssignment(
        "layers/mlp/w_down", "bgemm", 8, k=1 << 20),))
    with pytest.raises(ValueError, match="largest safe K"):
        with port_backends.use_plan(plan):
            pass
