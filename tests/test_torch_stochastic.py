"""Port vs reference: the rate-coded stochastic uGEMM family.

The counterparts of ``tests/test_stochastic.py``, each holding the port to
the reference on the same numpy-seeded inputs rather than only to a
property.  Contracts (tolerances stated per test):

* RNG sequences (Sobol, LFSR; every ``LFSR_TAPS`` width; below, at and past
  one period), their per-cycle loop forms and ``bsgen`` streams: bit-exact;
* ``stochastic_gemm`` (Sobol and LFSR, L in {4, 16, 64, 100}): equal integer
  counts, hence bit-identical float32 outputs;
* ``rmse_curve`` / ``site_rmse_curve``: within 1e-12 relative at 4 bits
  and 1e-6 at 8 bits (``CURVE_RTOL``: equal estimates; the 8-bit oracle
  carries the reference's float32 summation order);
* ``UnaryLinearAcc`` / ``scaled_output_stream``: equal;
* ``resolve`` grammar and refusals, ``cycle_scale`` pricing (exactly equal
  ``ModelCost`` dataclasses), plan round trip, lint, and ``build_plan(
  stream_lens=...)`` choosing the reference's entries on the smoke config.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import backends as ref_backends
from repro import configs as ref_configs
from repro.analysis import plan_lint as ref_lint
from repro.core import accounting as ref_acct
from repro.eval import planner as ref_planner
from repro.models import common as ref_common
from repro.models import model as ref_model
from repro.stochastic import error as ref_error
from repro.stochastic import gen as ref_gen
from repro.stochastic import sgemm as ref_sgemm
from repro_torch import backends as port_backends
from repro_torch import configs as port_configs
from repro_torch.analysis import plan_lint as port_lint
from repro_torch.analysis import ranges as port_ranges
from repro_torch.core import accounting as port_acct
from repro_torch.core import gemm_sims as port_sims
from repro_torch.eval import planner as port_planner
from repro_torch.models import common as port_common
from repro_torch.models import model as port_model
from repro_torch.stochastic import error as port_error
from repro_torch.stochastic import gen as port_gen
from repro_torch.stochastic import sgemm as port_sgemm

BITS = 8
PERIOD = 2 ** BITS


def _codes(rows, cols, seed, bits=BITS):
    v = 2 ** (bits - 1) - 1
    return np.random.default_rng(seed).integers(
        -v, v + 1, (rows, cols)).astype(np.int8)


# ---------------------------------------------------------------------------
# RNG stage and the numpy tables copied from the reference
# ---------------------------------------------------------------------------

def test_copied_tables_equal_the_reference():
    assert port_gen.SOBOL_DIMS == ref_gen.SOBOL_DIMS
    assert port_gen.LFSR_TAPS == ref_gen.LFSR_TAPS
    for keys in ((0,), (1, 2, 3), (7, 1, 12345), (2 ** 63, 5)):
        assert port_gen._hash64(*keys) == ref_gen._hash64(*keys)
    for bits in range(2, 9):
        for dim in range(len(port_gen.SOBOL_DIMS)):
            assert port_gen.sobol_direction_numbers(bits, dim) == \
                ref_gen.sobol_direction_numbers(bits, dim)


def _lengths(kind, bits):
    period = (1 << bits) - (kind == "lfsr")
    return (1, period - 1, period, period + 1, 3 * period + 5)


@pytest.mark.parametrize("kind", ["sobol", "lfsr"])
@pytest.mark.parametrize("bits", sorted(ref_gen.LFSR_TAPS))
def test_rng_sequences_bit_exact_below_at_and_past_a_period(kind, bits):
    for length in _lengths(kind, bits):
        for dim, seed in ((0, 0), (1, 3)):
            want = np.asarray(ref_gen.rng_sequence(kind, bits, length,
                                                   dim=dim, seed=seed))
            got = port_gen.rng_sequence(kind, bits, length, dim=dim, seed=seed)
            assert got.dtype == torch.int32
            np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("kind", ["sobol", "lfsr"])
@pytest.mark.parametrize("bits", [2, 5, 8])
def test_rng_scan_forms_bit_exact(kind, bits):
    for length in _lengths(kind, bits):
        want = np.asarray(ref_gen.rng_sequence_scan(kind, bits, length,
                                                    dim=1, seed=5))
        got = port_gen.rng_sequence_scan(kind, bits, length, dim=1, seed=5)
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(
            got.numpy(), port_gen.rng_sequence(kind, bits, length, dim=1,
                                               seed=5).numpy())


@pytest.mark.parametrize("kind", ["sobol", "lfsr"])
def test_rng_seeded_determinism_and_unknown_kind(kind):
    a = port_gen.rng_sequence(kind, BITS, 48, dim=0, seed=3)
    c = port_gen.rng_sequence(kind, BITS, 48, dim=0, seed=4)
    assert (a != c).any()
    with pytest.raises(ValueError):
        port_gen.rng_sequence("xorshift", BITS, 4)
    with pytest.raises(ValueError):
        port_gen.rng_sequence_scan("xorshift", BITS, 4)


@pytest.mark.parametrize("kind", ["sobol", "lfsr"])
def test_bsgen_and_scan_bit_exact(kind):
    tau_np = np.asarray(ref_gen.source_gen(jnp.asarray([0.0, 0.25, 0.5, 1.0]),
                                           BITS))
    tau = port_gen.source_gen(torch.tensor([0.0, 0.25, 0.5, 1.0]), BITS)
    np.testing.assert_array_equal(tau.numpy(), tau_np)
    for length in (40, PERIOD + 9):
        seq = port_gen.rng_sequence(kind, BITS, length, dim=0, seed=2)
        want = np.asarray(ref_gen.bsgen(tau_np, np.asarray(seq)))
        fast = port_gen.bsgen(tau, seq)
        slow = port_gen.bsgen_scan(tau, kind=kind, bits=BITS, length=length,
                                   dim=0, seed=2)
        assert fast.dtype == slow.dtype == torch.int8
        np.testing.assert_array_equal(fast.numpy(), want)
        np.testing.assert_array_equal(slow.numpy(), want)
        np.testing.assert_array_equal(
            slow.numpy(), np.asarray(ref_gen.bsgen_scan(
                tau_np, kind=kind, bits=BITS, length=length, dim=0, seed=2)))


@pytest.mark.parametrize("mode", ["unipolar", "bipolar"])
def test_source_gen_and_decode_equal(mode):
    vals = np.linspace(-1.0 if mode == "bipolar" else 0.0, 1.0, 257,
                       dtype=np.float32)
    for bits in (2, 4, 8):
        np.testing.assert_array_equal(
            port_gen.source_gen(torch.from_numpy(vals), bits, mode).numpy(),
            np.asarray(ref_gen.source_gen(jnp.asarray(vals), bits, mode)))
        mags = np.arange(2 ** (bits - 1), dtype=np.int32)
        np.testing.assert_array_equal(
            port_gen.source_gen_codes(torch.from_numpy(mags), bits).numpy(),
            np.asarray(ref_gen.source_gen_codes(jnp.asarray(mags), bits)))
    counts = np.arange(0, 65, dtype=np.int32)
    np.testing.assert_array_equal(
        port_gen.decode_counts(torch.from_numpy(counts), 64, mode).numpy(),
        np.asarray(ref_gen.decode_counts(jnp.asarray(counts), 64, mode)))
    with pytest.raises(ValueError):
        port_gen.source_gen(torch.zeros(2), BITS, "ternary")


def test_unipolar_full_period_exact():
    probs = torch.arange(PERIOD + 1, dtype=torch.float32) / PERIOD
    tau = port_gen.source_gen(probs, BITS)
    seq = port_gen.rng_sequence("sobol", BITS, PERIOD, dim=0, seed=7)
    counts = port_gen.bsgen(tau, seq).to(torch.int32).sum(dim=0)
    assert torch.equal(counts, tau)
    torch.testing.assert_close(port_gen.decode_counts(counts, PERIOD), probs,
                               atol=1e-7, rtol=0)


def test_gates_equal():
    a = np.asarray([0, 0, 1, 1], np.int8)
    b = np.asarray([0, 1, 0, 1], np.int8)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    np.testing.assert_array_equal(port_gen.unipolar_and(ta, tb).numpy(),
                                  np.asarray(ref_gen.unipolar_and(a, b)))
    got = port_gen.bipolar_xnor(ta, tb)
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(ref_gen.bipolar_xnor(a, b)))


# ---------------------------------------------------------------------------
# The stochastic GEMM engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["sobol", "lfsr"])
@pytest.mark.parametrize("stream_len", [4, 16, 64, 100])
@pytest.mark.parametrize("bits", [2, 4, 8])
def test_stochastic_gemm_equals_reference(kind, stream_len, bits):
    a, b = _codes(5, 37, 0, bits), _codes(37, 9, 1, bits)
    want = np.asarray(ref_sgemm.stochastic_gemm(
        jnp.asarray(a), jnp.asarray(b), bits, stream_len=stream_len,
        rng_kind=kind, seed=2))
    got = port_sgemm.stochastic_gemm(torch.from_numpy(a), torch.from_numpy(b),
                                     bits, stream_len=stream_len,
                                     rng_kind=kind, seed=2)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    # the materialized streams' int32 contraction gives the same counts
    at = port_sgemm._bitstreams(torch.from_numpy(a), bits, stream_len, dim=0,
                                seed=2, rng_kind=kind)
    bt = port_sgemm._bitstreams(torch.from_numpy(b), bits, stream_len, dim=1,
                                seed=2, rng_kind=kind)
    np.testing.assert_array_equal(
        at.numpy(), np.asarray(ref_sgemm._bitstreams(
            jnp.asarray(a), bits, stream_len, dim=0, seed=2, rng_kind=kind)))
    counts = torch.einsum("tmk,tkn->mn", at.to(torch.int64), bt.to(torch.int64))
    v = 2 ** (bits - 1) - 1
    np.testing.assert_array_equal(
        port_sims._scaled(counts, v * v, stream_len).numpy(), want)


def test_stochastic_gemm_default_length_and_stream_form():
    a, b = _codes(2, 16, 4), _codes(16, 4, 5)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    assert port_sgemm.default_stream_len(BITS) == PERIOD
    est, cycles = port_sgemm.stochastic_gemm_stream(ta, tb, BITS, stream_len=48)
    r_est, r_cycles = ref_sgemm.stochastic_gemm_stream(
        jnp.asarray(a), jnp.asarray(b), BITS, stream_len=48)
    assert cycles == r_cycles == 48
    np.testing.assert_array_equal(est.numpy(), np.asarray(r_est))
    np.testing.assert_array_equal(
        port_sgemm.stochastic_gemm(ta, tb, BITS).numpy(),
        np.asarray(ref_sgemm.stochastic_gemm(jnp.asarray(a), jnp.asarray(b),
                                             BITS)))


def test_stochastic_gemm_seeded_and_under_tail_bound():
    a, b = _codes(4, 64, 2), _codes(64, 16, 3)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    x = port_sgemm.stochastic_gemm(ta, tb, BITS, stream_len=32, seed=0)
    z = port_sgemm.stochastic_gemm(ta, tb, BITS, stream_len=32, seed=1)
    assert (x != z).any()
    oracle = port_sims.ugemm_exact(ta, tb, bits=BITS)
    for L in (16, 64, 256):
        rel = port_sims.rel_rmse(
            port_sgemm.stochastic_gemm(ta, tb, BITS, stream_len=L), oracle)
        assert rel <= port_ranges.stochastic_error_bound(BITS, L).tail


#: relative tolerance of the error curves: the estimates are bit-identical;
#: at 8 bits the oracle ``ugemm_exact`` differs by the reference's float32
#: summation order over K (tests/test_torch_ugemm.py), at 4 bits not at all
CURVE_RTOL = {4: 1e-12, 8: 1e-6}


@pytest.mark.parametrize("bits", [4, 8])
def test_rmse_curve_equals_reference(bits):
    for kind in ("sobol", "lfsr"):
        want = ref_error.rmse_curve(bits, (16, 64, 256), m=4, k=64, n=16,
                                    seed=3, rng_kind=kind)
        got = port_error.rmse_curve(bits, (16, 64, 256), m=4, k=64, n=16,
                                    seed=3, rng_kind=kind)
        assert [L for L, _ in got] == [L for L, _ in want]
        for (_, g), (_, w) in zip(got, want):
            assert g == pytest.approx(w, rel=CURVE_RTOL[bits])
    np.testing.assert_array_equal(port_error.calibration_codes(3, 5, 4, seed=9),
                                  ref_error.calibration_codes(3, 5, 4, seed=9))


def test_site_rmse_curve_equals_reference():
    w = np.random.default_rng(0).normal(size=(64, 80)).astype(np.float32)
    for bits in (4, 8):
        want = dict(ref_error.site_rmse_curve(w, bits, (16, 128), rows=4))
        got = dict(port_error.site_rmse_curve(torch.from_numpy(w), bits,
                                              (16, 128), rows=4))
        assert set(got) == set(want) == {16, 128}
        for L in got:
            assert got[L] == pytest.approx(want[L], rel=CURVE_RTOL[bits])
    assert 0.0 < got[128] < got[16] < 1.0


# ---------------------------------------------------------------------------
# UnaryLinear scaled accumulation
# ---------------------------------------------------------------------------

def test_unary_linear_acc_bookkeeping():
    for kw in (dict(in_features=8), dict(in_features=8, bias=True),
               dict(in_features=7, bias=True, bipolar=True),
               dict(in_features=5, bipolar=True)):
        p, r = port_sgemm.UnaryLinearAcc(**kw), ref_sgemm.UnaryLinearAcc(**kw)
        assert (p.acc_bound, p.offset) == (r.acc_bound, r.offset)


def test_scaled_output_stream_equals_reference():
    probs = np.asarray([0.25, 0.5, 0.125, 0.75], np.float32)
    tau = ref_gen.source_gen(jnp.asarray(probs), BITS)
    bits_in = np.array(ref_gen.bsgen(
        tau, ref_gen.rng_sequence("sobol", BITS, PERIOD, dim=0)))
    for kw in (dict(in_features=4), dict(in_features=4, bias=True)):
        want = np.asarray(ref_sgemm.scaled_output_stream(
            bits_in, ref_sgemm.UnaryLinearAcc(**kw)))
        got = port_sgemm.scaled_output_stream(
            torch.from_numpy(bits_in), port_sgemm.UnaryLinearAcc(**kw))
        assert got.dtype == torch.int8 and got.shape == (PERIOD,)
        np.testing.assert_array_equal(got.numpy(), want)
    # a batch of output streams at once
    batch = np.stack([bits_in, bits_in[::-1]], axis=1)
    acc = port_sgemm.UnaryLinearAcc(in_features=4)
    np.testing.assert_array_equal(
        port_sgemm.scaled_output_stream(torch.from_numpy(batch.copy()), acc).numpy(),
        np.asarray(ref_sgemm.scaled_output_stream(
            batch, ref_sgemm.UnaryLinearAcc(in_features=4))))


# ---------------------------------------------------------------------------
# Backend contract: resolve grammar, execute, cycles, price
# ---------------------------------------------------------------------------

def _fields(be):
    return (be.name, be.bits, be.stream_len, be.pricing_design, be.exact,
            be.has_synthesis_data, be.cycle_scale)


@pytest.mark.parametrize("spec,kw", [
    ("ugemm_stochastic", dict(bits=8)),
    ("ugemm_stochastic", dict(bits=4)),
    ("ugemm_stochastic:64", dict(bits=8)),
    ("ugemm_stochastic:16", dict(bits=4)),
    ("ugemm_stochastic", dict(bits=8, stream_len=64)),
    ("ugemm_stochastic:64", dict(bits=8, stream_len=64)),
    ("ugemm", dict(bits=4))])
def test_resolve_grammar_equals_reference(spec, kw):
    p, r = port_backends.resolve(spec, **kw), ref_backends.resolve(spec, **kw)
    assert _fields(p) == _fields(r)
    for k in (1, 64, 4096):
        assert p.cycles(k) == r.cycles(k)
    assert port_backends.resolve(p) is p
    again = port_backends.resolve(p, bits=4)
    assert _fields(again) == _fields(ref_backends.resolve(r, bits=4))
    if p.stream_len:
        assert _fields(port_backends.resolve(p, stream_len=32)) == \
            _fields(ref_backends.resolve(r, stream_len=32))


@pytest.mark.parametrize("spec,kw", [
    ("ugemm_stochastic:zero", dict(bits=8)),
    ("ugemm_stochastic:16", dict(bits=8, stream_len=32)),
    ("bgemm", dict(bits=8, stream_len=64)),
    ("ugemm", dict(bits=8, stream_len=64)),
    ("tubgemm_cuda", dict(bits=4, stream_len=16)),
    ("ugemm_stochastic", dict(bits=8, stream_len=0)),
    ("bgemm:16", dict(bits=8))])
def test_resolve_refusals_equal_reference(spec, kw):
    with pytest.raises(ValueError):
        ref_backends.resolve(spec.replace("_cuda", "_pallas"), **kw)
    with pytest.raises(ValueError):
        port_backends.resolve(spec, **kw)


def test_available_lists_the_family():
    assert "ugemm_stochastic" in port_backends.available()
    assert port_backends.STOCHASTIC_DESIGN == ref_sgemm.STOCHASTIC_DESIGN \
        == port_sgemm.STOCHASTIC_DESIGN


def test_design_spec_is_pure():
    before = port_sims.DESIGNS
    spec = port_sgemm.stochastic_design_spec(32)
    assert port_sims.DESIGNS == before and "ugemm_stochastic" not in before
    assert spec.wc_cycles_fn(8, 4096) == 32 and not spec.exact
    with pytest.raises(ValueError):
        port_sgemm.stochastic_design_spec(0)


def test_backend_execute_stream_and_batch_equal_reference():
    a, b = _codes(4, 32, 6), _codes(32, 8, 7)
    p = port_backends.resolve("ugemm_stochastic:32", bits=BITS)
    r = ref_backends.resolve("ugemm_stochastic:32", bits=BITS)
    np.testing.assert_array_equal(
        p.execute(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
        np.asarray(r.execute(jnp.asarray(a), jnp.asarray(b))))
    out, cycles = p.stream(torch.from_numpy(a), torch.from_numpy(b))
    assert cycles == 32 == p.cycles(32)
    a3 = np.stack([a, _codes(4, 32, 8)])
    np.testing.assert_array_equal(
        p.execute(torch.from_numpy(a3), torch.from_numpy(b)).numpy(),
        np.asarray(r.execute(jnp.asarray(a3), jnp.asarray(b))))


@pytest.mark.parametrize("spec,bits", [("ugemm_stochastic", 8),
                                       ("ugemm_stochastic:64", 8),
                                       ("ugemm_stochastic:16", 4),
                                       ("ugemm_stochastic:100", 4)])
def test_cycle_scale_pricing_equals_reference(spec, bits):
    kw = dict(name="probe", m=4, k=256, n_out=64, bit_sparsity=0.3, count=2)
    want = ref_backends.resolve(spec, bits=bits).price(
        [ref_acct.GemmCall(**kw)], unit_n=64, num_units=4)
    got = port_backends.resolve(spec, bits=bits).price(
        [port_acct.GemmCall(**kw)], unit_n=64, num_units=4)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    full = port_backends.resolve("ugemm_stochastic", bits=bits).price(
        [port_acct.GemmCall(**kw)], unit_n=64, num_units=4)
    scale = port_backends.resolve(spec, bits=bits).cycle_scale
    assert got.wc_energy_uj == pytest.approx(full.wc_energy_uj * scale)


def test_execution_records_stream_len():
    x = np.random.default_rng(0).normal(size=(1, 2, 16)).astype(np.float32)
    w = np.random.default_rng(1).normal(size=(16, 8)).astype(np.float32)
    with ref_backends.use_backend("ugemm_stochastic", bits=BITS,
                                  stream_len=32) as rex:
        want = ref_common.dense(jnp.asarray(w), jnp.asarray(x), name="probe")
    with port_backends.use_backend("ugemm_stochastic", bits=BITS,
                                   stream_len=32) as pex:
        got = port_common.dense(torch.from_numpy(w), torch.from_numpy(x),
                                name="probe")
    assert pex.calls[0].stream_len == rex.calls[0].stream_len == 32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# Plans, lint, planner
# ---------------------------------------------------------------------------

def _entry(mod, **kw):
    base = dict(pattern="layers/attn/wq", design="ugemm_stochastic", bits=8,
                stream_len=32)
    base.update(kw)
    return mod.SiteAssignment(**base)


def test_plan_round_trip_keeps_stream_len():
    plans = {}
    for name, mod in (("ref", ref_backends), ("port", port_backends)):
        plans[name] = mod.BackendPlan(
            sites=(_entry(mod), _entry(mod, pattern="lm_head", design="bgemm",
                                       bits=4, stream_len=0)),
            meta=(("max_rel_mse", 0.05),))
    assert plans["port"].to_json() == plans["ref"].to_json()
    back = port_backends.BackendPlan.from_json(plans["ref"].to_json())
    assert back == plans["port"]
    assert back.sites[0].stream_len == 32
    assert back.sites[0].engine_label == "ugemm_stochastic@8:32"
    assert back.distinct_engines() == (("bgemm", 4, 0),
                                       ("ugemm_stochastic", 8, 32))
    be = back.sites[0].backend()
    assert _fields(be) == _fields(plans["ref"].sites[0].backend())


@pytest.mark.parametrize("case", ["exact-design", "guard", "guard-relaxed",
                                  "guard-ok", "no-stream"])
def test_lint_on_stochastic_plans_equals_reference(case):
    kw = {"exact-design": dict(design="bgemm", bits=4),
          "guard": dict(stream_len=4),
          "guard-relaxed": dict(stream_len=4, guard_relaxed=True),
          "guard-ok": dict(stream_len=256),
          "no-stream": dict(stream_len=0)}[case]
    found = {}
    for name, mod, lint in (("ref", ref_backends, ref_lint),
                            ("port", port_backends, port_lint)):
        plan = mod.BackendPlan(sites=(_entry(mod, **kw),),
                               meta=(("max_rel_mse", 0.05),))
        found[name] = [(f.rule, f.severity) for f in lint.lint_plan(plan)]
    assert found["port"] == found["ref"]
    if case in ("exact-design", "no-stream"):
        assert ("invalid-stream", "error") in found["port"]
    if case == "guard":
        assert ("stream-guard", "error") in found["port"]


@pytest.fixture(scope="module")
def smoke():
    ref_cfg = ref_configs.get_smoke_config("llama3-8b")
    port_cfg = port_configs.get_smoke_config("llama3-8b")
    ref_params = ref_model.init_params(ref_cfg, jax.random.PRNGKey(0))
    port_params = port_model.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, ref_params), device="cpu")
    return ref_cfg, port_cfg, ref_params, port_params


def test_site_candidates_equal_reference(smoke):
    ref_cfg, port_cfg, ref_params, port_params = smoke
    rsite = ref_planner.discover_sites(ref_cfg, ref_params, batch=2)[0]
    psite = port_planner.discover_sites(port_cfg, port_params, batch=2)[0]
    designs = port_planner.DEFAULT_DESIGNS + (port_planner.STOCHASTIC_DESIGN,)
    kw = dict(bits_candidates=(4, 8), designs=designs, unit_n=64,
              num_units=16, stream_lens=(4, 64, 256))
    rpruned, ppruned = [], []
    want = ref_planner.site_candidates(rsite, pruned=rpruned, **kw)
    got = port_planner.site_candidates(psite, pruned=ppruned, **kw)
    key = lambda c: (c.design, c.bits, c.stream_len, c.guard_ok)  # noqa: E731
    assert [key(c) for c in got] == [key(c) for c in want]
    assert any(c.design == "ugemm_stochastic" for c in got)
    for g, w in zip(got, want):
        assert g.rel_mse == pytest.approx(w.rel_mse, rel=1e-5)
        for f in ("dyn_energy_uj", "wc_energy_uj", "dyn_latency_us"):
            assert getattr(g, f) == pytest.approx(getattr(w, f), rel=1e-6)
    assert [(r["design"], r["bits"], r.get("stream_len")) for r in ppruned] \
        == [(r["design"], r["bits"], r.get("stream_len")) for r in rpruned]


@pytest.mark.parametrize("stream_lens,bits", [((16, 32), (2, 4, 8)),
                                              ((64, 256), (8,))])
def test_build_plan_stream_lens_equals_reference(smoke, stream_lens, bits):
    ref_cfg, port_cfg, ref_params, port_params = smoke
    designs = port_planner.DEFAULT_DESIGNS + (port_planner.STOCHASTIC_DESIGN,)
    kw = dict(batch=2, designs=designs, bits_candidates=bits,
              stream_lens=stream_lens, unit_n=64, num_units=16)
    want = ref_planner.build_plan(ref_cfg, ref_params, **kw)
    got = port_planner.build_plan(port_cfg, port_params, **kw)
    assert [(e.pattern, e.design, e.bits, e.stream_len, e.guard_relaxed)
            for e in got.sites] == \
        [(e.pattern, e.design, e.bits, e.stream_len, e.guard_relaxed)
         for e in want.sites]
    gm, wm = got.metadata(), want.metadata()
    assert gm["stream_lens"] == wm["stream_lens"] == sorted(stream_lens)
    assert gm["totals"]["uniform_best"] == wm["totals"]["uniform_best"]
    assert len(gm["range_pruned"]) == len(wm["range_pruned"])
    assert port_backends.BackendPlan.from_json(got.to_json()) == got
    names = [s.name for s in port_planner.discover_sites(port_cfg, port_params)]
    assert port_lint.lint_plan(got, site_names=names) == []
    md = port_planner.to_markdown(got)
    assert "Distinct backends chosen" in md


def test_stochastic_plan_executes_under_use_plan(smoke):
    """A hand-made plan with rate-coded entries runs every site on its
    engine, as the reference does, with the same site outputs."""
    ref_cfg, port_cfg, ref_params, port_params = smoke
    sites = (("layers/mlp/*", "ugemm_stochastic", 4, 16),
             ("layers/attn/*", "ugemm", 4, 0), ("lm_head", "bgemm", 8, 0))
    rplan = ref_backends.BackendPlan(sites=tuple(
        ref_backends.SiteAssignment(p, d, b, stream_len=L)
        for p, d, b, L in sites))
    pplan = port_backends.BackendPlan.from_json(rplan.to_json())
    tokens = np.random.default_rng(0).integers(0, ref_cfg.vocab_size, (2, 5))
    cfg32 = dict(compute_dtype="float32")
    with ref_backends.use_plan(rplan) as rex:
        want, _ = ref_model.forward(ref_params, ref_cfg.replace(**cfg32),
                                    jnp.asarray(tokens, jnp.int32))
    with port_backends.use_plan(pplan) as pex:
        got, _ = port_model.forward(port_params, port_cfg.replace(**cfg32),
                                    torch.from_numpy(tokens.astype(np.int32)))
    assert {(c.site, c.backend, c.stream_len) for c in pex.calls} == \
        {(c.site, c.backend, c.stream_len) for c in rex.calls}
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-4)
