"""Port vs reference: uGEMM and the stream simulators of ``core/gemm_sims``,
stochastic rounding, ``fake_quant``, the deprecated dispatch shims and the
legacy kernel-mirror registration.

Contracts, on the same numpy-seeded codes:

* ``ugemm_exact``: bit-exact against the reference's at 2 and 4 bits; at 8
  bits within ``rtol=1e-4, atol=1e-2`` of it (the reference sums its scaled
  LUT entries in float32, in XLA's order — the bound its own
  ``tests/test_core_unary.py`` holds ``ugemm_stream`` to) and bit-exact
  against the reference's ``ugemm_stream`` (the exact integer count);
* ``ugemm_stream`` / ``tugemm_stream`` / ``tubgemm_stream``: outputs and
  cycles bit-exact against the reference and against the port's own
  slot-by-slot ``*_stream_scan`` loops (tiny shapes only);
* the chunked count gives the same bits at any byte budget, and no operand
  of a chunk product exceeds the budget;
* stochastic rounding fed the reference's own uniform draw: codes
  bit-identical; ``fake_quant``: bit-identical in the input's dtype.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import backends as ref_backends
from repro.core import gemm_sims as ref_sims
from repro.core import quantization as ref_quant
from repro_torch import backends as port_backends
from repro_torch.core import gemm_sims as port_sims
from repro_torch.core import quantization as port_quant
from repro_torch.kernels import backends as port_kernel_backends
from repro_torch.stochastic import sgemm as port_sgemm

BITS = (2, 4, 8)
SHAPES = [(1, 1, 1), (3, 5, 4), (8, 64, 32), (5, 300, 7), (17, 129, 33)]


def _codes(bits, shape, seed):
    v = 2 ** (bits - 1) - 1
    return np.random.default_rng(seed).integers(-v, v + 1, shape).astype(np.int8)


def _pair(bits, m, k, n, seed=0):
    return _codes(bits, (m, k), seed), _codes(bits, (k, n), seed + 1)


def _t(x):
    return torch.from_numpy(np.array(x))


def _j(x):
    return jnp.asarray(x)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("bits", BITS)
def test_ugemm_exact_against_reference(bits, shape):
    a, b = _pair(bits, *shape)
    got = port_sims.ugemm_exact(_t(a), _t(b), bits=bits)
    assert got.dtype == torch.float32 and got.shape == shape[::2]
    want = np.asarray(ref_sims.ugemm_exact(_j(a), _j(b), bits=bits))
    stream, _ = ref_sims.ugemm_stream(_j(a), _j(b), bits)
    np.testing.assert_array_equal(got.numpy(), np.asarray(stream))
    if bits < 8:
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-2)
    if bits == 2:      # uGEMM is exact at 2 bits
        np.testing.assert_array_equal(
            got.numpy(), port_sims.bgemm_exact(_t(a), _t(b)).numpy())


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("design", ["ugemm", "tugemm", "tubgemm"])
def test_stream_simulators_against_reference(design, bits, shape):
    a, b = _pair(bits, *shape, seed=7)
    got, cycles = getattr(port_sims, f"{design}_stream")(_t(a), _t(b), bits)
    want, r_cycles = getattr(ref_sims, f"{design}_stream")(_j(a), _j(b), bits)
    assert cycles == r_cycles
    assert got.dtype == (torch.float32 if design == "ugemm" else torch.int32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    spec = port_sims.get_design(design)
    assert cycles == spec.wc_cycles_fn(bits, shape[1])


@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("design", ["ugemm", "tugemm", "tubgemm"])
def test_stream_simulators_equal_their_scans(design, bits):
    for shape, seed in (((2, 3, 2), 0), ((3, 2, 4), 1), ((1, 5, 1), 2)):
        if design == "tugemm" and bits == 8 and shape[1] > 3:
            continue            # 64 x 64 slot pairs a step: keep it tiny
        a, b = _pair(bits, *shape, seed=seed)
        fast, cyc = getattr(port_sims, f"{design}_stream")(_t(a), _t(b), bits)
        slow, scyc = getattr(port_sims, f"{design}_stream_scan")(_t(a), _t(b),
                                                                 bits)
        r_slow, r_cyc = getattr(ref_sims, f"{design}_stream_scan")(
            _j(a), _j(b), bits)
        assert cyc == scyc == r_cyc
        np.testing.assert_array_equal(fast.numpy(), slow.numpy())
        np.testing.assert_array_equal(slow.numpy(), np.asarray(r_slow))


def test_registry_runs_every_design_in_the_reference_order():
    assert port_sims.DESIGNS == ref_sims.DESIGNS
    a, b = _pair(4, 3, 9, 5, seed=3)
    for name in port_sims.DESIGNS:
        p, r = port_sims.get_design(name), ref_sims.get_design(name)
        np.testing.assert_array_equal(
            p.exact_fn(_t(a), _t(b), 4).numpy(),
            np.asarray(r.exact_fn(_j(a), _j(b), 4)))
        (po, pc), (ro, rc) = p.stream_fn(_t(a), _t(b), 4), r.stream_fn(
            _j(a), _j(b), 4)
        assert pc == rc
        np.testing.assert_array_equal(po.numpy(), np.asarray(ro))
        assert p.exact == r.exact
        for bits in BITS:
            for k in (1, 64, 4096):
                assert p.wc_cycles_fn(bits, k) == r.wc_cycles_fn(bits, k)


@pytest.mark.parametrize("bits", BITS)
def test_chunk_budget_invariance(monkeypatch, bits):
    a, b = _pair(bits, 9, 700, 40, seed=11)
    want_u = port_sims.ugemm_exact(_t(a), _t(b), bits=bits)
    want_s = port_sgemm.stochastic_gemm(_t(a), _t(b), bits, stream_len=48)
    seen = []
    real = port_sims._chunk_product

    def recording(a_chunk, w_chunk):
        seen.append((a_chunk.numel() * a_chunk.element_size(),
                     w_chunk.numel() * w_chunk.element_size()))
        return real(a_chunk, w_chunk)

    monkeypatch.setattr(port_sims, "_chunk_product", recording)
    for budget in (4 * 40, 4 * 40 * 3, 10_000, 1 << 16, 1 << 30):
        seen.clear()
        monkeypatch.setattr(port_sims, "CHUNK_BUDGET_BYTES", budget)
        got_u = port_sims.ugemm_exact(_t(a), _t(b), bits=bits)
        got_s = port_sgemm.stochastic_gemm(_t(a), _t(b), bits, stream_len=48)
        assert torch.equal(got_u, want_u) and torch.equal(got_s, want_s)
        assert seen and max(max(pair) for pair in seen) <= budget
        if budget == 4 * 40:   # one k row of one threshold per product
            assert len(seen) >= 700
    np.testing.assert_array_equal(
        want_u.numpy(), np.asarray(ref_sims.ugemm_stream(_j(a), _j(b), bits)[0]))


def test_counts_exact_past_the_float32_window():
    # K * L = 70,000 * 256 > 2^24: the chunks split K so every float32
    # partial count stays exact; the int64 LUT sum is the oracle
    bits, k = 8, 70_000
    a, b = _pair(bits, 2, k, 3, seed=5)
    sa, sb = port_sims._unified_tables(bits)
    lut = sa.to(torch.int64) @ sb.to(torch.int64).T
    ia, ib = np.abs(a.astype(np.int64)), np.abs(b.astype(np.int64))
    sgn = np.sign(a.astype(np.int64))[:, :, None] * np.sign(
        b.astype(np.int64))[None]
    want = (lut.numpy()[ia[:, :, None], ib[None]] * sgn).sum(axis=1)
    got = port_sims.signed_slot_counts(_t(a), _t(b),
                                       port_sims.SlotGroups(sa, sb))
    np.testing.assert_array_equal(got.numpy(), want)
    r_c, k_c = port_sims._chunk_plan(2, k, 3, 127, 256)
    assert k_c * 256 < 2 ** 24 and k_c < k


@pytest.mark.parametrize("engine", ["ugemm_exact", "stochastic_gemm",
                                    "measured_rel_rmse"])
def test_operands_on_two_devices_are_refused(engine):
    # neither engine moves an operand: codes on two devices raise, so no
    # weight is copied to the host and contracted there unannounced
    from repro_torch.stochastic import error as port_error
    a = torch.zeros((2, 8), dtype=torch.int8)
    b = torch.zeros((8, 3), dtype=torch.int8, device="meta")
    fn = {"ugemm_exact": lambda x, y: port_sims.ugemm_exact(x, y, bits=4),
          "stochastic_gemm": lambda x, y: port_sgemm.stochastic_gemm(
              x, y, 4, stream_len=16),
          "measured_rel_rmse": lambda x, y: port_error.measured_rel_rmse(
              x, y, 4, 16)}[engine]
    for x, y in ((a, b), (b.T.contiguous(), a.T.contiguous())):
        with pytest.raises(ValueError, match="different devices"):
            fn(x, y)


def test_non_monotone_port_b_table_is_refused():
    pulses = torch.tensor([[0, 1], [1, 0]], dtype=torch.bool)
    with pytest.raises(ValueError, match="monotone"):
        port_sims.SlotGroups(pulses, pulses)


def test_backend_execute_guard_and_batch():
    # batched with a shared weight, per-problem weights: bit-exact at 4 bits
    be = port_backends.resolve("ugemm", bits=4)
    a, b = _pair(4, 4, 32, 6, seed=2)
    a3 = np.stack([a, _codes(4, (4, 32), 9)])
    for b_ in (b, np.stack([b, _codes(4, (32, 6), 10)])):
        np.testing.assert_array_equal(
            be.execute(_t(a3), _t(b_)).numpy(),
            np.asarray(ref_backends.resolve("ugemm", bits=4).execute(
                _j(a3), _j(b_))))
    # uGEMM's float32 counts are exact only while 2^bits * K < 2^24
    with pytest.raises(ValueError):
        port_backends.resolve("ugemm", bits=8).execute(
            torch.zeros((1, 1 << 16), dtype=torch.int8),
            torch.zeros((1 << 16, 1), dtype=torch.int8))


# ---------------------------------------------------------------------------
# quantization: stochastic rounding and fake_quant
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("per_channel", [True, False])
@pytest.mark.parametrize("bits", BITS)
def test_stochastic_rounding_with_the_reference_draw(bits, per_channel):
    x = np.random.default_rng(bits).normal(size=(33, 17)).astype(np.float32)
    x[:, 3] = 0.0                                  # an all-zero channel
    key = jax.random.PRNGKey(bits)
    want = ref_quant.quantize(_j(x), bits=bits, per_channel=per_channel,
                              stochastic_rounding=True, rng=key)
    u = np.asarray(jax.random.uniform(key, x.shape, jnp.float32))
    got = port_quant.quantize(_t(x), bits=bits, per_channel=per_channel)
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))
    codes = port_quant._stochastic_codes(_t(x), got.scale, bits, _t(u))
    keep = np.ones(x.shape, bool)
    if per_channel:
        keep[:, 3] = False   # the reference divides 0 by a flushed zero scale
    np.testing.assert_array_equal(codes.numpy()[keep],
                                  np.asarray(want.values)[keep])
    assert not codes.numpy()[~keep].any()


def test_stochastic_rounding_draws_from_the_generator():
    x = torch.linspace(-1, 1, 101).reshape(1, -1)
    with pytest.raises(ValueError, match="generator"):
        port_quant.quantize(x, bits=4, stochastic_rounding=True)
    runs = []
    for seed in (0, 0, 1):
        gen = torch.Generator().manual_seed(seed)
        runs.append(port_quant.quantize(x, bits=4, per_channel=False,
                                        stochastic_rounding=True,
                                        generator=gen).values)
    assert torch.equal(runs[0], runs[1]) and not torch.equal(runs[0], runs[2])
    det = port_quant.quantize(x, bits=4, per_channel=False).values
    assert int((runs[0].to(torch.int32) - det).abs().max()) <= 1


@pytest.mark.parametrize("per_channel", [True, False])
@pytest.mark.parametrize("bits", BITS)
def test_fake_quant(bits, per_channel):
    x = np.random.default_rng(bits + 10).normal(size=(6, 9)).astype(np.float32)
    got = port_quant.fake_quant(_t(x), bits=bits, per_channel=per_channel)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(ref_quant.fake_quant(
            _j(x), bits=bits, per_channel=per_channel)))


# ---------------------------------------------------------------------------
# deprecated shims and the legacy kernel-mirror registration
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shim", ["gemm", "stream_gemm", "gemm_batched"])
def test_deprecated_shims_warn_once_and_delegate(monkeypatch, shim):
    monkeypatch.setattr(port_sims, "_DEPRECATION_EMITTED", set())
    a, b = _pair(4, 3, 16, 5, seed=4)
    if shim == "gemm_batched":
        a = np.stack([a, _codes(4, (3, 16), 8)])
    for design in ("ugemm", "tubgemm", "bgemm"):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            got = getattr(port_sims, shim)(design, _t(a), _t(b), bits=4)
        be = port_backends.resolve(design, bits=4)
        want = be.stream(_t(a), _t(b)) if shim == "stream_gemm" \
            else be.execute(_t(a), _t(b))
        if shim == "stream_gemm":
            assert got[1] == want[1]
            got, want = got[0], want[0]
        assert torch.equal(got, want)
        dep = [w for w in caught if issubclass(w.category, DeprecationWarning)]
        assert len(dep) == (1 if design == "ugemm" else 0), shim


def test_kernel_backends_scope_restores_designs():
    before = port_sims.DESIGNS
    with port_kernel_backends.kernel_backends() as names:
        assert names == ("tugemm_cuda", "tubgemm_cuda")
        assert port_sims.DESIGNS == before + names
        be = port_backends.resolve("tubgemm_cuda", bits=4)
        a, b = _pair(4, 2, 8, 3, seed=1)
        assert torch.equal(be.execute(_t(a), _t(b)),
                           port_sims.bgemm_exact(_t(a), _t(b)))
    assert port_sims.DESIGNS == before
    with pytest.raises(RuntimeError):
        with port_kernel_backends.kernel_backends():
            assert "tugemm_cuda" in port_sims.DESIGNS
            raise RuntimeError("inside the scope")
    assert port_sims.DESIGNS == before


def test_register_kernel_backends_warns_once_and_is_not_run_at_import(
        monkeypatch):
    assert "tugemm_cuda" not in port_sims.DESIGNS
    monkeypatch.setattr(port_sims, "_DEPRECATION_EMITTED", set())
    with port_sims.scoped_registry():
        with pytest.warns(DeprecationWarning,
                          match="kernels.backends.register_kernel_backends"):
            port_kernel_backends.register_kernel_backends()
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            assert port_kernel_backends.register_kernel_backends() == (
                "tugemm_cuda", "tubgemm_cuda")
        assert "tubgemm_cuda" in port_sims.DESIGNS
    assert "tugemm_cuda" not in port_sims.DESIGNS
