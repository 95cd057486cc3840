"""Port vs reference: the planner, ``use_plan`` and ``pack_weights`` on the
llama3-8b smoke config (fp32).

Parameters come from the reference's ``init_params`` through the port's
``params_from_numpy``; tokens from a numpy seed.  Contracts:

* ``discover_sites`` — the same (name, m, k, n_out, count) in model order;
* ``build_plan`` — equal patterns, designs, bits, shapes, counts and
  sparsity fields, ``rel_mse`` within 1e-5 relative (the reference takes
  float32 means, the port float64 sums of the same float32 squares), the
  pricing fields within 1e-12 relative, equal ``range_pruned`` and meta;
* ``measure_site_cycles`` — equal;
* ``use_plan`` of the example plan — every site's int32 GEMM output equal
  to the reference's, logits within 1e-5;
* ``pack_weights`` — words and scales equal to the reference's, and a
  packed forward equal to the unpacked forward bit for bit.
"""

import dataclasses
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import backends as ref_backends
from repro import configs as ref_configs
from repro.backends import base as ref_base
from repro.core import packing as ref_packing
from repro.eval import planner as ref_planner
from repro.models import common as ref_common
from repro.models import model as ref_model
from repro_torch import backends as port_backends
from repro_torch import configs as port_configs
from repro_torch.core import packing as port_packing
from repro_torch.eval import planner as port_planner
from repro_torch.models import common as port_common
from repro_torch.models import model as port_model

ROOT = pathlib.Path(__file__).resolve().parents[1]
FLAT = ROOT / "examples" / "plans" / "llama3_8b_smoke.plan.json"
REL_MSE_TOL = 1e-5
PRICE_TOL = 1e-12
LOGIT_TOL = 1e-5
PRICED = ("dyn_energy_uj", "dyn_latency_us", "wc_energy_uj", "wc_latency_us")


@pytest.fixture(scope="module")
def setup():
    ref_cfg = ref_configs.get_smoke_config("llama3-8b").replace(
        compute_dtype="float32")
    port_cfg = port_configs.get_smoke_config("llama3-8b").replace(
        compute_dtype="float32")
    ref_params = ref_model.init_params(ref_cfg, jax.random.PRNGKey(0))
    port_params = port_model.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, ref_params), device="cpu")
    tokens = np.random.default_rng(0).integers(
        0, ref_cfg.vocab_size, (2, 9)).astype(np.int32)
    return ref_cfg, port_cfg, ref_params, port_params, tokens


def _site_keys(sites):
    return [(s.name, s.m, s.k, s.n_out, s.count) for s in sites]


@pytest.mark.parametrize("batch", [1, 8])
def test_discover_sites_equal(setup, batch):
    ref_cfg, port_cfg, ref_params, port_params, _ = setup
    ref = ref_planner.discover_sites(ref_cfg, ref_params, batch=batch)
    port = port_planner.discover_sites(port_cfg, port_params, batch=batch)
    assert _site_keys(port) == _site_keys(ref)
    # sites hold the leaves by reference; the weight matrix is a view
    for site in port:
        w = site.weight_matrix()
        assert w.data_ptr() == site.leaf.data_ptr()
        assert tuple(w.shape) == (site.count * site.k, site.n_out)


def _assert_entries_equal(ref_plan, port_plan):
    assert len(port_plan.sites) == len(ref_plan.sites)
    for r, p in zip(ref_plan.sites, port_plan.sites):
        for f in dataclasses.fields(r):
            want, got = getattr(r, f.name), getattr(p, f.name)
            if f.name == "rel_mse":
                assert got == pytest.approx(want, rel=REL_MSE_TOL), r.pattern
            elif f.name in PRICED:
                assert got == pytest.approx(want, rel=PRICE_TOL), r.pattern
            else:
                assert got == want, (r.pattern, f.name)


def _assert_meta_equal(ref_plan, port_plan):
    ref, port = ref_plan.metadata(), port_plan.metadata()
    assert port.keys() == ref.keys()
    for key in ref:
        if key != "totals":
            assert port[key] == ref[key], key
    rt, pt = ref["totals"], port["totals"]
    assert pt["uniform_best"] == rt["uniform_best"]
    assert list(pt["uniform"]) == list(rt["uniform"])
    for name, tot in [("planned", rt["planned"]),
                      *((f"uniform {k}", v) for k, v in rt["uniform"].items())]:
        got = (pt["planned"] if name == "planned"
               else pt["uniform"][name.split()[1]])
        assert got.keys() == tot.keys()
        for k in tot:
            assert got[k] == pytest.approx(tot[k], rel=PRICE_TOL), (name, k)


@pytest.mark.parametrize("kw", [
    dict(batch=1, unit_n=64),                   # the example plan's geometry
    dict(batch=8, unit_n=128),                  # the card's plan phase
    dict(batch=4, unit_n=64, max_rel_mse=1e-6),  # every width relaxed
    dict(batch=2, unit_n=32, objective="dyn_latency_us",
         bits_candidates=(4, 8), designs=("tubgemm", "bgemm"))])
def test_build_plan_equal(setup, kw):
    ref_cfg, port_cfg, ref_params, port_params, _ = setup
    ref = ref_planner.build_plan(ref_cfg, ref_params, **kw)
    port = port_planner.build_plan(port_cfg, port_params, **kw)
    _assert_entries_equal(ref, port)
    _assert_meta_equal(ref, port)
    if "max_rel_mse" in kw:
        assert all(e.guard_relaxed for e in port.sites)
    ref_rows = [ln for ln in ref_planner.to_markdown(ref).splitlines()
                if ln.startswith("| `")]
    assert [ln for ln in port_planner.to_markdown(port).splitlines()
            if ln.startswith("| `")] == ref_rows


def test_measure_site_cycles_equal(setup):
    ref_cfg, port_cfg, ref_params, port_params, _ = setup
    example = port_backends.load_plan(FLAT)
    ref_example = ref_backends.BackendPlan.load(FLAT)
    ref_sites = {s.name: s for s in ref_planner.discover_sites(
        ref_cfg, ref_params, batch=8)}
    for site in port_planner.discover_sites(port_cfg, port_params, batch=8):
        got = port_planner.measure_site_cycles(
            site, example.assignment_for(site.name), unit_n=128, num_units=64)
        want = ref_planner.measure_site_cycles(
            ref_sites[site.name], ref_example.assignment_for(site.name),
            unit_n=128, num_units=64)
        assert got == want, site.name
        assert got["dyn_floor"] - 0.5 <= got["measured"] <= got["wc"] + 0.5


@pytest.mark.parametrize("bits", [2, 4, 8])
def test_quantization_rel_mse(setup, monkeypatch, bits):
    _, _, ref_params, port_params, _ = setup
    w = port_params["layers"]["mlp"]["w_down"].reshape(-1, 64)
    want = ref_planner.quantization_rel_mse(
        np.asarray(ref_params["layers"]["mlp"]["w_down"]).reshape(-1, 64), bits)
    whole = port_planner.quantization_rel_mse(w, bits)
    assert whole == pytest.approx(want, rel=REL_MSE_TOL)
    # the two-pass chunked walk: 37 rows a chunk leaves a ragged last chunk
    monkeypatch.setattr(port_planner, "_REL_MSE_CHUNK_ELEMS", 37 * 64)
    assert port_planner.quantization_rel_mse(w, bits) == \
        pytest.approx(whole, rel=1e-12)


def _ref_site_outputs(monkeypatch, cfg, params, tokens, plan, act_scale):
    """Every site's int32 output of the reference's eager forward under
    ``use_plan`` (``lax.scan`` unrolls in Python under ``disable_jit``)."""
    outs = []
    execute = ref_base.GemmBackend.execute

    def recording(self, a, b):
        out = execute(self, a, b)
        outs.append(np.asarray(out))
        return out

    monkeypatch.setattr(ref_base.GemmBackend, "execute", recording)
    with jax.disable_jit(), ref_backends.use_plan(plan) as ex, \
            ref_common.activation_scaling(act_scale):
        logits, _ = ref_model.forward(params, cfg, jnp.asarray(tokens))
    monkeypatch.setattr(ref_base.GemmBackend, "execute", execute)
    return [c.site for c in ex.calls], outs, np.asarray(logits)


def _port_site_outputs(cfg, params, tokens, plan, act_scale):
    outs = []
    with port_backends.use_plan(
            plan, on_output=lambda s, o: outs.append((s, o.clone()))), \
            port_common.activation_scaling(act_scale):
        logits, _ = port_model.forward(params, cfg, torch.from_numpy(tokens))
    return outs, logits


@pytest.mark.parametrize("act_scale", ["per-row", "per-tensor"])
def test_use_plan_site_outputs_equal(setup, monkeypatch, act_scale):
    ref_cfg, port_cfg, ref_params, port_params, tokens = setup
    ref_sites, ref_outs, ref_logits = _ref_site_outputs(
        monkeypatch, ref_cfg, ref_params, tokens,
        ref_backends.BackendPlan.load(FLAT), act_scale)
    outs, logits = _port_site_outputs(port_cfg, port_params, tokens,
                                      port_backends.load_plan(FLAT), act_scale)
    assert [s for s, _ in outs] == ref_sites
    assert len(ref_sites) == 7 * ref_cfg.num_layers + 1
    for want, (site, got) in zip(ref_outs, outs):
        np.testing.assert_array_equal(want, got.numpy(), err_msg=site)
    assert float(np.abs(ref_logits - logits.numpy()).max()) <= LOGIT_TOL


def test_pack_weights_equal_reference(setup):
    ref_cfg, port_cfg, ref_params, port_params, _ = setup
    ref = ref_backends.pack_weights(ref_cfg, ref_params,
                                    ref_backends.BackendPlan.load(FLAT))
    port = port_backends.pack_weights(port_cfg, port_params, FLAT)
    ref_flat = dict(port_planner._walk(ref))
    port_flat = dict(port_planner._walk(port))
    assert ref_flat.keys() == port_flat.keys()
    packed = [n for n, leaf in port_flat.items() if port_packing.is_packed(leaf)]
    assert packed == [n for n, leaf in ref_flat.items()
                      if ref_packing.is_packed(leaf)]
    assert len(packed) == 8
    for name in port_flat:
        r, p = ref_flat[name], port_flat[name]
        if name in packed:
            assert (p.bits, p.k, p.tail, p.k_shape) == (r.bits, r.k, r.tail,
                                                        r.k_shape), name
            np.testing.assert_array_equal(np.asarray(r.packed), p.packed.numpy())
            np.testing.assert_array_equal(np.asarray(r.scale), p.scale.numpy())
        else:
            assert p is port_params_leaf(port_params, name)


def port_params_leaf(tree, name):
    for key in name.split("/"):
        tree = tree[key]
    return tree


@pytest.mark.parametrize("selector", ["plan", "bits"])
def test_packed_forward_bit_identical(setup, selector):
    _, port_cfg, _, port_params, tokens = setup
    plan = port_backends.load_plan(FLAT)
    if selector == "plan":
        packed = port_backends.pack_weights(port_cfg, port_params, plan)
    else:
        packed = port_backends.pack_weights(port_cfg, port_params, bits=4)
    float_outs, float_logits = _port_site_outputs(
        port_cfg, port_params, tokens, plan, "per-row")
    outs, logits = _port_site_outputs(port_cfg, packed, tokens, plan, "per-row")
    assert torch.equal(logits, float_logits)
    assert len(outs) == len(float_outs) == 7 * port_cfg.num_layers + 1
    for (s, a), (t, b) in zip(outs, float_outs):
        assert s == t and torch.equal(a, b), s


def test_pack_weights_and_planner_refusals(setup):
    ref_cfg, port_cfg, ref_params, port_params, _ = setup
    plan = port_backends.load_plan(FLAT)
    with pytest.raises(ValueError, match="exactly one"):
        port_backends.pack_weights(port_cfg, port_params, plan, bits=4)
    # grid= packs per K band: every store equals the reference's grid store
    ref_grid = ref_backends.pack_weights(ref_cfg, ref_params,
                                         ref_backends.load_plan(FLAT),
                                         grid=(2, 2))
    port_grid = port_backends.pack_weights(port_cfg, port_params, plan,
                                           grid=(2, 2))
    ref_leaves = ref_planner._leaf_index(ref_grid)
    for name, leaf in port_planner._walk(port_grid):
        if port_packing.is_packed(leaf):
            ref_leaf = ref_leaves[name]
            assert leaf.grid_x == ref_leaf.grid_x == 2, name
            np.testing.assert_array_equal(np.asarray(ref_leaf.packed),
                                          leaf.packed.numpy())
    packed8 = port_backends.pack_weights(port_cfg, port_params, bits=8)
    with pytest.raises(ValueError, match="packed-width-mismatch"):
        port_backends.pack_weights(port_cfg, packed8, plan)
    # already-packed leaves at the planned width pass through as they are
    packed4 = port_backends.pack_weights(port_cfg, port_params, plan)
    again = port_backends.pack_weights(port_cfg, packed4, plan)
    assert again["lm_head"] is packed4["lm_head"]
    site = port_planner.discover_sites(port_cfg, packed4)[0]
    with pytest.raises(TypeError, match="already-packed"):
        site.weight_matrix()
    with pytest.raises(TypeError, match="float weight"):
        port_backends.measure_matrix_cycles(
            port_backends.resolve("tubgemm", bits=4), packed4["lm_head"],
            rows=1, unit_n=64, num_units=64)
    # stochastic candidates need both the design and stream lengths, as in
    # the reference: either alone plans the exact designs only
    for kw in (dict(designs=("tubgemm", "ugemm_stochastic")),
               dict(stream_lens=(16,))):
        plan = port_planner.build_plan(port_cfg, port_params, **kw)
        assert all(e.stream_len == 0 and e.design != "ugemm_stochastic"
                   for e in plan.sites)


def test_recommend_backend_and_combine_stats_equal(setup):
    from repro.core import accounting as ref_accounting
    from repro.core import sparsity as ref_sparsity
    from repro.eval import sweetspot as ref_sweetspot
    from repro_torch.core import accounting as port_accounting
    from repro_torch.core import sparsity as port_sparsity
    from repro_torch.eval import sweetspot as port_sweetspot
    ref_cfg, port_cfg, ref_params, port_params, _ = setup
    calls, stats = {}, {}
    for name, accounting, sp, sites in (
            ("ref", ref_accounting, ref_sparsity,
             ref_planner.discover_sites(ref_cfg, ref_params)),
            ("port", port_accounting, port_sparsity,
             port_planner.discover_sites(port_cfg, port_params))):
        rec = accounting.GemmWorkloadRecorder()
        profiled = []
        for site in sites:
            st = sp.profile_tensor(site.weight_matrix(), bits=4)
            profiled.append(st)
            rec.record(site.name, m=8, k=site.k, n_out=site.n_out,
                       bit_sparsity=st.bit_blockmax, count=site.count)
        calls[name], stats[name] = rec.calls, sp.combine_stats(profiled)
    assert dataclasses.asdict(stats["port"]) == dataclasses.asdict(stats["ref"])
    assert port_sweetspot.CALIBRATED_DESIGNS == ref_sweetspot.CALIBRATED_DESIGNS
    for unit_n in (32, 128):
        ref = ref_sweetspot.recommend_backend(calls["ref"], bits=4,
                                              unit_n=unit_n, num_units=64)
        port = port_sweetspot.recommend_backend(calls["port"], bits=4,
                                                unit_n=unit_n, num_units=64)
        assert port.keys() == ref.keys()
        for objective in ref:
            assert port[objective]["best"] == ref[objective]["best"]
            assert [d for d, _ in port[objective]["ranking"]] == \
                [d for d, _ in ref[objective]["ranking"]]
            for (_, got), (_, want) in zip(port[objective]["ranking"],
                                           ref[objective]["ranking"]):
                assert got == pytest.approx(want, rel=PRICE_TOL)
