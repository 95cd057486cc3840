"""Port vs reference: MLA attention (deepseek-v3 smoke config, fp32, CPU),
and the flash wrapper at MLA's shapes (q/k head dim 192, a narrower V).

Parameters come from the reference's ``init_params`` through the port's
``params_from_numpy``; every input from the test's own
``np.random.default_rng(seed)``.

* ``mla_defs`` shapes equal the reference's;
* prefill logits, the latent ``ckv`` / ``krope`` caches and three decode
  steps <= 1e-4 (every cached call runs the absorbed form);
* ``w_uk`` / ``w_uv`` are backend sites on the no-cache forward and plain
  einsums on the cached path, in both packages;
* ``flash_attention`` with Dv < D and at D = 192, through the plain
  versions, against the reference's ``naive_attention`` (values 2e-5,
  gradients 2e-4 in float32, 3e-2 in bfloat16: the tolerances of
  ``tests/test_torch_flash_attention.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import backends as ref_backends
from repro import configs as ref_configs
from repro.kernels import flash_attention as ref_flash
from repro.models import attention as ref_attn
from repro.models import model as ref_model
from repro_torch import backends as port_backends
from repro_torch import configs as port_configs
from repro_torch.kernels import flash_attention as port_flash
from repro_torch.models import attention as port_attn
from repro_torch.models import common as port_common
from repro_torch.models import model as port_model

ARCH = "deepseek-v3-671b"
TOL = 1e-4
VAL_TOL = 2e-5
GRAD_TOL = 2e-4
BF16_TOL = 3e-2


@pytest.fixture(scope="module")
def setup():
    ref_cfg = ref_configs.get_smoke_config(ARCH).replace(compute_dtype="float32")
    port_cfg = port_configs.get_smoke_config(ARCH).replace(compute_dtype="float32")
    ref_params = ref_model.init_params(ref_cfg, jax.random.PRNGKey(0))
    port_params = port_model.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, ref_params), device="cpu")
    tokens = np.random.default_rng(0).integers(
        0, ref_cfg.vocab_size, (2, 9)).astype(np.int32)
    return ref_cfg, port_cfg, ref_params, port_params, tokens


def _maxdiff(ref, port) -> float:
    return float(np.abs(np.asarray(ref, np.float64)
                        - port.detach().double().numpy()).max())


def test_mla_defs_shapes():
    for get in ("get_config", "get_smoke_config"):
        ref_cfg = getattr(ref_configs, get)(ARCH)
        port_cfg = getattr(port_configs, get)(ARCH)
        ref_defs, port_defs = ref_attn.mla_defs(ref_cfg), port_attn.mla_defs(port_cfg)
        assert sorted(ref_defs) == sorted(port_defs)
        for name, d in ref_defs.items():
            assert port_defs[name].shape == d.shape, name
            assert port_defs[name].init == d.init, name
            assert port_defs[name].fan_in_axes == d.fan_in_axes, name
        assert port_attn.attention_defs(port_cfg).keys() == port_defs.keys()
    one = port_attn.init_kv_cache(port_cfg, 3, 7, torch.float32, device="cpu")
    assert {k: tuple(v.shape) for k, v in one.items()} == {
        "ckv": (3, 7, port_cfg.mla.kv_lora_rank),
        "krope": (3, 7, port_cfg.mla.rope_head_dim)}


def test_prefill_caches_and_decode_match_reference(setup):
    ref_cfg, port_cfg, ref_params, port_params, tokens = setup
    total = 12
    ref_caches = ref_model.init_caches(ref_cfg, 2, total, dtype=jnp.float32)
    caches = port_model.init_caches(port_cfg, 2, total, dtype=torch.float32,
                                    device="cpu")
    assert set(caches["attn"]) == {"ckv", "krope"}
    ref_logits, ref_caches = ref_model.prefill(
        ref_params, ref_cfg, jnp.asarray(tokens), caches=ref_caches)
    logits, caches = port_model.prefill(port_params, port_cfg,
                                        torch.from_numpy(tokens), caches=caches)
    assert _maxdiff(ref_logits, logits) <= TOL
    for key in ("ckv", "krope"):
        assert tuple(caches["attn"][key].shape) == ref_caches["attn"][key].shape
        assert _maxdiff(ref_caches["attn"][key], caches["attn"][key]) <= TOL
    tok = np.asarray(jnp.argmax(ref_logits[:, -1:], axis=-1)).astype(np.int32)
    np.testing.assert_array_equal(tok, torch.argmax(logits[:, -1:], -1).numpy())
    for pos in (9, 10, 11):
        ref_step, ref_caches = ref_model.decode_step(
            ref_params, ref_cfg, jnp.asarray(tok), caches=ref_caches,
            cache_pos=pos)
        step, caches = port_model.decode_step(
            port_params, port_cfg, torch.from_numpy(tok), caches=caches,
            cache_pos=pos)
        assert _maxdiff(ref_step, step) <= TOL
        ref_tok = np.asarray(jnp.argmax(ref_step[:, -1:], -1)).astype(np.int32)
        np.testing.assert_array_equal(ref_tok, torch.argmax(step[:, -1:], -1).numpy())
        tok = ref_tok
    for key in ("ckv", "krope"):
        assert _maxdiff(ref_caches["attn"][key], caches["attn"][key]) <= TOL


def _ref_sites(fn):
    """Site names the reference's backend scope records while ``fn`` runs."""
    with ref_backends.use_backend("tubgemm", bits=4) as ex:
        fn()
    return [c.site for c in ex.calls]


def test_w_uk_w_uv_are_sites_only_without_a_cache(setup):
    ref_cfg, port_cfg, ref_params, port_params, tokens = setup
    toks = torch.from_numpy(tokens)
    with port_backends.use_backend("tubgemm", bits=4) as fwd, \
            port_common.activation_scaling("per-row"):
        port_model.forward(port_params, port_cfg, toks)
    caches = port_model.init_caches(port_cfg, 2, 10, dtype=torch.float32,
                                    device="cpu")
    with port_backends.use_backend("tubgemm", bits=4) as cached:
        port_model.prefill(port_params, port_cfg, toks, caches=caches)
        port_model.decode_step(port_params, port_cfg, toks[:, -1:],
                               caches=caches, cache_pos=9)
    attn = ["w_dq", "w_uq", "w_dkv", "w_kr"]
    moe_shared = ["moe/shared/w_up", "moe/shared/w_gate", "moe/shared/w_down"]

    def layer_sites(extra):
        return [f"layers/attn/{n}" for n in attn + extra] + ["layers/attn/wo"] \
            + [f"layers/{n}" for n in moe_shared]

    fwd_sites = [c.site for c in fwd.calls]
    assert fwd_sites == layer_sites(["w_uk", "w_uv"]) * 2 + ["lm_head"]
    assert [c.site for c in cached.calls] == (layer_sites([]) * 2 + ["lm_head"]) * 2
    # the reference's scanned layer body records its sites once: compare sets
    ref_fwd = _ref_sites(lambda: ref_model.forward(
        ref_params, ref_cfg, jnp.asarray(tokens)))
    ref_caches = ref_model.init_caches(ref_cfg, 2, 10, dtype=jnp.float32)
    ref_cached = _ref_sites(lambda: ref_model.prefill(
        ref_params, ref_cfg, jnp.asarray(tokens), caches=ref_caches))
    assert set(ref_fwd) == set(fwd_sites)
    assert set(ref_cached) == {c.site for c in cached.calls}
    # wo's site contracts the (H * v_head_dim, D) matrix
    wo = next(c for c in fwd.calls if c.site == "layers/attn/wo")
    assert (wo.k, wo.n_out) == (port_cfg.num_heads * port_cfg.mla.v_head_dim,
                                port_cfg.d_model)


# (B, Sq, Skv, H, D, Dv): MLA's head dims, a ragged tile, Sq != Skv, and a
# narrower V at D = 128
MLA_CASES = [(1, 64, 64, 2, 192, 128), (2, 20, 20, 1, 192, 128),
             (1, 40, 20, 1, 192, 128), (1, 20, 40, 2, 192, 192),
             (1, 77, 77, 2, 128, 64), (2, 33, 33, 1, 128, 96)]


def _naive_vjp(q, k, v, g, causal, dtype):
    fn = lambda a, b, c: ref_attn.naive_attention(a, b, c, causal=causal)
    want, vjp = jax.vjp(fn, *(jnp.asarray(x, dtype) for x in (q, k, v)))
    return want, vjp(jnp.asarray(g, dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("case", MLA_CASES, ids=str)
def test_flash_narrow_v_and_d192_match_reference(case, causal, dtype):
    b, sq, skv, h, d, dv = case
    rng = np.random.default_rng(sq * 13 + skv + d + dv)
    q = rng.standard_normal((b, sq, h, d)).astype(np.float32)
    k = rng.standard_normal((b, skv, h, d)).astype(np.float32)
    v = rng.standard_normal((b, skv, h, dv)).astype(np.float32)
    g = rng.standard_normal((b, sq, h, dv)).astype(np.float32)
    want, want_grads = _naive_vjp(q, k, v, g, causal, getattr(jnp, dtype))
    tdt = getattr(torch, dtype)
    tq, tk, tv = (torch.from_numpy(x).to(tdt).requires_grad_(True)
                  for x in (q, k, v))
    got = port_flash.flash_attention(tq, tk, tv, causal=causal)
    assert got.shape == (b, sq, h, dv) and got.dtype == tdt
    grads = torch.autograd.grad(got, (tq, tk, tv), torch.from_numpy(g).to(tdt))
    val_tol, grad_tol = (VAL_TOL, GRAD_TOL) if dtype == "float32" \
        else (BF16_TOL, BF16_TOL)
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=val_tol, atol=val_tol)
    for name, a, w in zip("qkv", grads, want_grads):
        assert a.shape == (b, (sq if name == "q" else skv), h,
                           dv if name == "v" else d)
        np.testing.assert_allclose(a.float().numpy(), np.asarray(w, np.float32),
                                   rtol=grad_tol, atol=grad_tol, err_msg=f"d{name}")


def test_zero_padded_v_equals_the_plain_narrow_v():
    """The kernels take one head dim, so the wrapper pads V with zeros: the
    plain versions, which take a narrower V as it is, give the same
    numbers, and the padded columns of O and dV are exactly 0."""
    rng = np.random.default_rng(9)
    bh, s, d, dv = 3, 70, 192, 128
    q, k, do = (torch.from_numpy(rng.standard_normal((bh, s, n)).astype(np.float32))
                for n in (d, d, dv))
    v = torch.from_numpy(rng.standard_normal((bh, s, dv)).astype(np.float32))
    vp = torch.nn.functional.pad(v, (0, d - dv))
    dop = torch.nn.functional.pad(do, (0, d - dv))
    o, lse = port_flash.flash_fwd_plain(q, k, v, causal=True)
    op, lsep = port_flash.flash_fwd_plain(q, k, vp, causal=True)
    assert o.shape == (bh, s, dv)
    assert torch.equal(op[..., dv:], torch.zeros_like(op[..., dv:]))
    torch.testing.assert_close(op[..., :dv], o, rtol=0, atol=1e-6)
    torch.testing.assert_close(lsep, lse, rtol=0, atol=1e-6)
    delta = torch.sum(do * o, dim=-1)
    dq = port_flash.flash_bwd_dq_plain(q, k, v, do, lse, delta, causal=True)
    dqp = port_flash.flash_bwd_dq_plain(q, k, vp, dop, lse, delta, causal=True)
    torch.testing.assert_close(dqp, dq, rtol=0, atol=1e-6)
    dk, dvv = port_flash.flash_bwd_dkv_plain(q, k, v, do, lse, delta, causal=True)
    dkp, dvp = port_flash.flash_bwd_dkv_plain(q, k, vp, dop, lse, delta, causal=True)
    torch.testing.assert_close(dkp, dk, rtol=0, atol=1e-6)
    torch.testing.assert_close(dvp[..., :dv], dvv, rtol=0, atol=1e-6)
    assert torch.equal(dvp[..., dv:], torch.zeros_like(dvp[..., dv:]))
    with pytest.raises(ValueError, match="exceeds"):
        port_flash.flash_attention(torch.zeros(1, 4, 1, 64),
                                   torch.zeros(1, 4, 1, 64),
                                   torch.zeros(1, 4, 1, 128))


@pytest.mark.parametrize("causal", [True, False])
def test_flash_d192_matches_reference_kernel(causal):
    """At D = 192 with V as wide, the reference's own flash kernel (interpret
    mode) takes the shape too: values and gradients against it."""
    rng = np.random.default_rng(11)
    q, k, v, g = (rng.standard_normal((1, 40, 2, 192)).astype(np.float32)
                  for _ in range(4))
    want, vjp = jax.vjp(lambda a, b_, c: ref_flash.flash_attention(
        a, b_, c, causal=causal, bq=16, bk=16, interpret=True),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want_grads = vjp(jnp.asarray(g))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    got = port_flash.flash_attention(tq, tk, tv, causal=causal)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=VAL_TOL, atol=VAL_TOL)
    for name, a, w in zip("qkv", torch.autograd.grad(got, (tq, tk, tv),
                                                     torch.from_numpy(g)),
                          want_grads):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), rtol=GRAD_TOL,
                                   atol=GRAD_TOL, err_msg=f"d{name}")
