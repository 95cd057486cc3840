"""Port vs reference: the recurrent families — Mamba2 SSD, RWKV6 and the
zamba2 hybrid stack (smoke widths, fp32, CPU).

The same numpy-seeded inputs go through the reference function and its
port.  Model parameters come from the reference's ``init_params`` with
every leaf that starts as zeros or ones (the token-shift mixes ``mu_*``,
the decay LoRA's ``wb``, the bonus ``u``, the norm biases and scales, the
conv biases, ``d_skip``) replaced by seeded random values first
(``chip_smoke.real_values``, the rule the card check uses) — left at init,
the token shift, the decay LoRA and the bonus would contribute nothing and
a bug in them would not show — then converted with the port's
``params_from_numpy``.

* ``ssd_recurrent_ref`` / ``ssd_chunked`` (chunks 4, 7, 8, 24; two groups;
  a state carried across two calls), ``wkv_recurrent_ref`` /
  ``wkv_chunked`` (chunks 4, 5, 32; with ``u`` = 0 both give 0 at t = 0
  and a multiple of ``v_0`` at t = 1), ``ssm_fwd`` and ``rwkv_block_fwd``
  (full, and token by token with a cache): outputs and states within
  1e-5;
* zamba2, rwkv6 and a pure Mamba2 stack: ``forward``, ``prefill`` and three
  ``decode_step`` logits within 1e-4, greedy tokens equal, every cache
  leaf within 1e-5; every site's int32 output under
  ``use_backend("tubgemm", bits=4)`` per-row EQUAL, site names in order
  (and equal to ``chip_smoke.recorded_sites``);
* ``pack_weights`` of both recurrent trees, at 4 bits and under a plan:
  words and scales equal to the reference's, every site's int32 output of
  the packed forward EQUAL to the reference's; the one-shot serve mode's
  ``run_backend_execution`` / ``run_plan_execution`` from packed stores
  equal to the float store's; the ``serve`` CLI's ``plan``, ``--backend-plan
  --packed`` and ``--execute-backend tubgemm --packed`` on both archs;
* the intra-chunk decay masked before ``exp``: where the reference's
  ``dt`` gradient is not finite, the port's is; the reference's formula
  inside the port gives a bit-identical forward and the same non-finite
  gradient; where both are finite, the gradients agree;
* ``loss_and_grads`` against ``jax.value_and_grad(loss_fn)``, also at
  RWKV6's init parameters, where the reference's gradient of the bonus
  ``u`` dwarfs every other leaf (its first WKV output is 0, so group norm
  divides by sqrt(eps));
* the planner (``shared/…`` sites counted once per group), the plan,
  ``iter_weight_matrices`` and the shared sites' measured cycles;
* the registry's order and cells, full-config parameter counts, and
  ``ServingEngine``'s refusal with the reference's message.
"""

import dataclasses
import importlib.util
import math
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
from repro.models import config as ref_config
from repro.models import model as ref_model
from repro.models import rwkv as ref_rwkv
from repro.models import ssm as ref_ssm
from repro.serving import energy as ref_energy
from repro.serving import engine as ref_engine
from repro_torch import backends as port_backends
from repro_torch import configs as port_configs
from repro_torch.core import packing as port_packing
from repro_torch.eval import planner as port_planner
from repro_torch.launch import serve as port_serve
from repro_torch.launch import steps as port_steps
from repro_torch.models import blocks as port_blocks
from repro_torch.models import common as port_common
from repro_torch.models import config as port_config
from repro_torch.models import model as port_model
from repro_torch.models import rwkv as port_rwkv
from repro_torch.models import ssm as port_ssm
from repro_torch.serving import ServingEngine
from repro_torch.serving import energy as port_energy

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _load_chip_smoke():
    """``chip_smoke.py`` as a module: its ``real_values`` and
    ``recorded_sites`` are the ones its recurrent phase runs on the card."""
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CHIP_SMOKE = _load_chip_smoke()
TOL = 1e-4          # logits, as in test_torch_families.py
STATE_TOL = 1e-5    # kernel-free modules, states and caches
B, S, STEPS = 2, 9, 3
RECURRENT = ("zamba2-1.2b", "rwkv6-3b")
MAMBA = "mamba2"     # a pure Mamba2 stack (family "ssm", cfg.ssm set)


def _mamba_cfg(pkg):
    """A pure Mamba2 stack at smoke widths (two B/C groups, chunk 8)."""
    return pkg.ModelConfig(
        arch_id=MAMBA, family="ssm", attention="none", num_layers=2,
        d_model=64, num_heads=4, num_kv_heads=4, d_ff=128, vocab_size=256,
        ssm=pkg.SSMConfig(state_dim=8, head_dim=16, expand=2, n_groups=2,
                          conv_kernel=4, chunk=8),
        remat=False)


def _cfgs(arch):
    if arch == MAMBA:
        ref_cfg, port_cfg = _mamba_cfg(ref_config), _mamba_cfg(port_config)
    else:
        ref_cfg = ref_configs.get_smoke_config(arch)
        port_cfg = port_configs.get_smoke_config(arch)
    return (ref_cfg.replace(compute_dtype="float32"),
            port_cfg.replace(compute_dtype="float32"))


def _leaves(tree, prefix=()):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _leaves(tree[k], prefix + (k,))
        else:
            yield prefix + (k,), tree[k]


@pytest.fixture(scope="module")
def arch_setup():
    cache = {}

    def get(arch):
        if arch not in cache:
            ref_cfg, port_cfg = _cfgs(arch)
            rng = np.random.default_rng(sum(map(ord, arch)))
            raw = jax.tree_util.tree_map(
                np.asarray, ref_model.init_params(ref_cfg, jax.random.PRNGKey(0)))
            tree = CHIP_SMOKE.real_values(ref_model.model_defs(ref_cfg), raw, rng)
            ref_params = jax.tree_util.tree_map(jnp.asarray, tree)
            port_params = port_model.params_from_numpy(tree, device="cpu")
            tokens = rng.integers(0, ref_cfg.vocab_size, (B, S)).astype(np.int32)
            cache[arch] = (ref_cfg, port_cfg, ref_params, port_params, tokens)
        return cache[arch]

    return get


def _np(t):
    return t.detach().double().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float64)


def _maxdiff(ref, port) -> float:
    return float(np.abs(_np(ref) - _np(port)).max())


def _close(ref, port, tol=STATE_TOL, what=""):
    np.testing.assert_allclose(_np(port), _np(ref), rtol=tol, atol=tol,
                               err_msg=what)


def _t(a):
    return torch.from_numpy(np.asarray(a))


# ---------------------------------------------------------------------------
# Kernel-free modules
# ---------------------------------------------------------------------------

def _ssd_inputs(seed, bs=2, s=24, h=4, p=8, g=2, n=6):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((bs, s, h, p)).astype(np.float32)
    dt = rng.uniform(0.01, 0.3, (bs, s, h)).astype(np.float32)
    a = -np.exp(rng.uniform(0.0, np.log(16.0), h)).astype(np.float32)
    b = rng.standard_normal((bs, s, g, n)).astype(np.float32)
    c = rng.standard_normal((bs, s, g, n)).astype(np.float32)
    return x, dt, a, b, c


@pytest.mark.parametrize("chunk", [4, 7, 8, 24])
def test_ssd_oracle_and_chunked_match_reference(chunk):
    x, dt, a, b, c = _ssd_inputs(chunk)
    cut = 11                                  # two calls, the state carried
    parts = [(0, cut), (cut, x.shape[1])]
    for name, ref_fn, port_fn in (
            ("recurrent", ref_ssm.ssd_recurrent_ref, port_ssm.ssd_recurrent_ref),
            ("chunked", lambda *v, init_state=None: ref_ssm.ssd_chunked(
                *v, chunk, init_state=init_state),
             lambda *v, init_state=None: port_ssm.ssd_chunked(
                 *v, chunk, init_state=init_state))):
        ref_state = port_state = None
        for lo, hi in parts:
            sl = [v[:, lo:hi] for v in (x, dt)] + [a] + [v[:, lo:hi] for v in (b, c)]
            ref_y, ref_state = ref_fn(*map(jnp.asarray, sl), init_state=ref_state)
            port_y, port_state = port_fn(*map(_t, sl), init_state=port_state)
            _close(ref_y, port_y, what=f"{name} y [{lo}:{hi}]")
            _close(ref_state, port_state, what=f"{name} state [{lo}:{hi}]")
    # the chunked port against its own oracle over the whole sequence
    y_rec, st_rec = port_ssm.ssd_recurrent_ref(*map(_t, (x, dt, a, b, c)))
    y_chk, st_chk = port_ssm.ssd_chunked(*map(_t, (x, dt, a, b, c)), chunk)
    _close(y_rec, y_chk, tol=1e-4)
    _close(st_rec, st_chk, tol=1e-4)


def _wkv_inputs(seed, b=2, s=23, h=3, k=8):
    """Per-step log decays in [-0.8, -0.05]: a chunk's cumulative decay
    stays inside the reference's +-EXP_CLAMP exponent clamp."""
    rng = np.random.default_rng(seed)
    r, kk, v = (rng.standard_normal((b, s, h, k)).astype(np.float32)
                for _ in range(3))
    logw = -rng.uniform(0.05, 0.8, (b, s, h, k)).astype(np.float32)
    u = (0.3 * rng.standard_normal((h, k))).astype(np.float32)
    return r, kk, v, logw, u


@pytest.mark.parametrize("chunk", [4, 5, 32])
def test_wkv_oracle_and_chunked_match_reference(chunk):
    r, k, v, logw, u = _wkv_inputs(chunk)
    cut = 13
    for name, ref_fn, port_fn in (
            ("recurrent", ref_rwkv.wkv_recurrent_ref, port_rwkv.wkv_recurrent_ref),
            ("chunked",
             lambda *a, init_state=None: ref_rwkv.wkv_chunked(
                 *a, chunk=chunk, init_state=init_state),
             lambda *a, init_state=None: port_rwkv.wkv_chunked(
                 *a, chunk=chunk, init_state=init_state))):
        ref_state = port_state = None
        for lo, hi in ((0, cut), (cut, r.shape[1])):
            sl = [t[:, lo:hi] for t in (r, k, v, logw)] + [u]
            ref_y, ref_state = ref_fn(*map(jnp.asarray, sl), init_state=ref_state)
            port_y, port_state = port_fn(*map(_t, sl), init_state=port_state)
            _close(ref_y, port_y, what=f"{name} y [{lo}:{hi}]")
            _close(ref_state, port_state, what=f"{name} state [{lo}:{hi}]")
    y_rec, st_rec = port_rwkv.wkv_recurrent_ref(*map(_t, (r, k, v, logw, u)))
    y_chk, st_chk = port_rwkv.wkv_chunked(*map(_t, (r, k, v, logw, u)), chunk=chunk)
    _close(y_rec, y_chk, tol=1e-4)
    _close(st_rec, st_chk, tol=1e-4)


def test_wkv_without_bonus_gives_t0_zero_and_t1_a_multiple_of_v0():
    """With the bonus ``u`` at its init 0 and no state, WKV's first output
    is exactly 0 and its second is ``v_0`` times the one dot product
    r_1 . k_0 a head, in the reference and the port alike — a fact about the
    oracle: where that product nearly cancels, the head's variance falls
    below group norm's eps and RWKV6's gradient at init turns on rounding
    (ROADMAP, Reference caveats)."""
    r, k, v, logw, u = _wkv_inputs(11)
    u = np.zeros_like(u)
    scale = np.einsum("bhk,bhk->bh", r[:, 1], k[:, 0])[..., None]
    for y in (np.asarray(ref_rwkv.wkv_chunked(*map(jnp.asarray, (r, k, v, logw, u)))[0]),
              port_rwkv.wkv_chunked(*map(_t, (r, k, v, logw, u)))[0].numpy()):
        assert not y[:, 0].any()
        np.testing.assert_allclose(y[:, 1], scale * v[:, 0], rtol=STATE_TOL,
                                   atol=STATE_TOL)


def _block_setup(kind):
    """(reference cfg, port cfg, ref params, port params, block fns, cache
    inits) of one Mamba2 or RWKV6 block, real values in every leaf."""
    if kind == "ssm":
        ref_cfg, port_cfg = _cfgs(MAMBA)
        defs_fn = (ref_ssm.ssm_defs, port_ssm.ssm_defs)
        fns = (ref_ssm.ssm_fwd, port_ssm.ssm_fwd)
        caches = (lambda: ref_ssm.init_ssm_cache(ref_cfg, B),
                  lambda: port_ssm.init_ssm_cache(port_cfg, B, device="cpu"))
    else:
        ref_cfg, port_cfg = _cfgs("rwkv6-3b")
        defs_fn = (ref_rwkv.rwkv_defs, port_rwkv.rwkv_defs)
        fns = (ref_rwkv.rwkv_block_fwd, port_rwkv.rwkv_block_fwd)
        caches = (lambda: ref_rwkv.init_rwkv_cache(ref_cfg, B),
                  lambda: port_rwkv.init_rwkv_cache(port_cfg, B, device="cpu"))
    defs = defs_fn[0](ref_cfg)
    raw = jax.tree_util.tree_map(np.asarray, ref_common.init_tree(
        defs, jax.random.PRNGKey(1), jnp.float32))
    tree = CHIP_SMOKE.real_values(defs, raw, np.random.default_rng(5))
    return (ref_cfg, port_cfg, jax.tree_util.tree_map(jnp.asarray, tree),
            port_model.params_from_numpy(tree, device="cpu"), fns, caches)


@pytest.mark.parametrize("kind", ["ssm", "rwkv"])
def test_block_full_and_token_by_token_match_reference(kind):
    ref_cfg, port_cfg, ref_p, port_p, (ref_fn, port_fn), (ref_c0, port_c0) = \
        _block_setup(kind)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((B, 11, ref_cfg.d_model)).astype(np.float32)
    ref_out, _ = ref_fn(ref_p, jnp.asarray(x), ref_cfg)
    port_out, none = port_fn(port_p, _t(x), port_cfg)
    assert none is None
    _close(ref_out, port_out, what="full sequence")
    # a 4-token prefill with a cache, then one token at a time
    ref_c, port_c = ref_c0(), port_c0()
    for lo, hi in [(0, 4)] + [(t, t + 1) for t in range(4, x.shape[1])]:
        ref_o, ref_c = ref_fn(ref_p, jnp.asarray(x[:, lo:hi]), ref_cfg, cache=ref_c)
        port_o, port_c = port_fn(port_p, _t(x[:, lo:hi]), port_cfg, cache=port_c)
        _close(ref_o, port_o, what=f"tokens [{lo}:{hi}]")
        _close(ref_out[:, lo:hi], port_o, tol=1e-4, what=f"vs full [{lo}:{hi}]")
        assert list(port_c) == list(ref_c)
        for key in ref_c:
            _close(ref_c[key], port_c[key], what=f"cache {key} after {hi}")


# ---------------------------------------------------------------------------
# The intra-chunk decay, masked before exp
# ---------------------------------------------------------------------------

def _overflow_case(dt_value):
    """B=1, S=64, H=2 with A = [-1, -16], chunk 64: above the diagonal the
    reference's segment sums reach 63 * dt * 16."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((1, 64, 2, 4)).astype(np.float32)
    dt = np.full((1, 64, 2), dt_value, np.float32)
    a = np.array([-1.0, -16.0], np.float32)
    b = rng.standard_normal((1, 64, 1, 4)).astype(np.float32)
    c = rng.standard_normal((1, 64, 1, 4)).astype(np.float32)
    return x, dt, a, b, c


def _ref_grads(x, dt, a, b, c):
    def loss(x, dt):
        return ref_ssm.ssd_chunked(x, dt, jnp.asarray(a), jnp.asarray(b),
                                   jnp.asarray(c), 64)[0].sum()
    return jax.grad(loss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(dt))


def _port_grads(x, dt, a, b, c):
    xt = _t(x).requires_grad_(True)
    dtt = _t(dt).requires_grad_(True)
    y, _ = port_ssm.ssd_chunked(xt, dtt, _t(a), _t(b), _t(c), 64)
    y.sum().backward()
    return y.detach(), xt.grad, dtt.grad


def _where_decay(seg, causal):
    """The reference's formula: ``where(causal, exp(seg), 0)``."""
    return torch.where(causal, torch.exp(seg), torch.zeros((), dtype=seg.dtype))


def test_masked_decay_keeps_the_gradient_finite_where_the_reference_overflows(
        monkeypatch):
    x, dt, a, b, c = _overflow_case(0.1)
    port_y, gx, gdt = _port_grads(x, dt, a, b, c)
    assert torch.isfinite(gx).all() and torch.isfinite(gdt).all()
    # the reference: forward within 1e-5 (another framework's summation),
    # its dt gradient not finite (exp overflows above the diagonal, 0 * inf)
    ref_y, _ = ref_ssm.ssd_chunked(*map(jnp.asarray, (x, dt, a, b, c)), 64)
    _close(ref_y, port_y)
    ref_gx, ref_gdt = _ref_grads(x, dt, a, b, c)
    assert np.isfinite(np.asarray(ref_gx)).all()
    assert not np.isfinite(np.asarray(ref_gdt)).all()
    _close(ref_gx, gx)
    # the reference's formula inside the port: the forward bit for bit the
    # same, the dt gradient not finite, as the reference's
    monkeypatch.setattr(port_ssm, "_intra_decay", _where_decay)
    where_y, where_gx, where_gdt = _port_grads(x, dt, a, b, c)
    assert torch.equal(where_y, port_y)
    assert torch.equal(where_gx, gx)
    assert not torch.isfinite(where_gdt).all()


def test_masked_decay_gradients_equal_the_reference_where_both_are_finite():
    x, dt, a, b, c = _overflow_case(0.02)
    ref_gx, ref_gdt = _ref_grads(x, dt, a, b, c)
    _, gx, gdt = _port_grads(x, dt, a, b, c)
    assert np.isfinite(np.asarray(ref_gdt)).all()
    _close(ref_gx, gx, what="dx")
    _close(ref_gdt, gdt, what="ddt")


# ---------------------------------------------------------------------------
# Model level
# ---------------------------------------------------------------------------

MODELS = (*RECURRENT, MAMBA)


def test_init_rules_ssm_a_and_ssm_dt():
    """``ssm_a`` is deterministic (equal to the reference's); ``ssm_dt``
    draws from the generator, its dt = softplus(bias) inside [1e-3, 0.1]."""
    ref_d = ref_common.ParamDef((3, 5), (None, None), init="ssm_a")
    port_d = port_common.ParamDef((3, 5), init="ssm_a")
    gen = torch.Generator().manual_seed(0)
    np.testing.assert_allclose(
        port_d.materialize(gen, "cpu", torch.float32).numpy(),
        np.asarray(ref_d.materialize(jax.random.PRNGKey(0), jnp.float32)),
        rtol=1e-6)
    bias = port_common.ParamDef((4096,), init="ssm_dt").materialize(
        gen, "cpu", torch.float32)
    dt = torch.nn.functional.softplus(bias)
    assert float(dt.min()) >= 1e-3 * (1 - 1e-4) and float(dt.max()) <= 0.1 * (1 + 1e-4)
    assert float(torch.log(dt).std()) > 1.0          # log-uniform, not a point


@pytest.mark.parametrize("arch", MODELS)
def test_converter_round_trip(arch, arch_setup):
    ref_cfg, port_cfg, ref_params, port_params, _ = arch_setup(arch)
    ref_leaves = jax.tree_util.tree_flatten_with_path(ref_params)[0]
    port_leaves = list(_leaves(port_params))
    assert [tuple(p.key for p in rp) for rp, _ in ref_leaves] \
        == [pp for pp, _ in port_leaves]
    gen = torch.Generator(device="cpu")
    gen.manual_seed(0)
    own = dict(_leaves(port_model.init_params(port_cfg, gen, device="cpu")))
    assert {k: tuple(v.shape) for k, v in own.items()} \
        == {k: tuple(v.shape) for k, v in port_leaves}
    assert port_model.count_params(port_params) == ref_model.count_params(ref_params)


@pytest.mark.parametrize("arch", MODELS)
def test_forward_prefill_decode_and_caches_match_reference(arch, arch_setup):
    ref_cfg, port_cfg, ref_params, port_params, tokens = arch_setup(arch)
    ref_logits, _ = jax.jit(lambda p, t: ref_model.forward(p, ref_cfg, t))(
        ref_params, jnp.asarray(tokens))
    logits, aux = port_model.forward(port_params, port_cfg, _t(tokens))
    assert tuple(logits.shape) == (B, S, ref_cfg.vocab_size)
    assert _maxdiff(ref_logits, logits) <= TOL
    assert float(aux) == 0.0

    total = S + STEPS
    ref_caches = ref_model.init_caches(ref_cfg, B, total, dtype=jnp.float32)
    caches = port_model.init_caches(port_cfg, B, total, dtype=torch.float32,
                                    device="cpu")
    ref_flat = jax.tree_util.tree_flatten_with_path(ref_caches)[0]
    assert [tuple(p.key for p in rp) for rp, _ in ref_flat] \
        == [pp for pp, _ in _leaves(caches)]
    ref_logits, ref_caches = jax.jit(
        lambda p, c, t: ref_model.prefill(p, ref_cfg, t, caches=c))(
        ref_params, ref_caches, jnp.asarray(tokens))
    logits, caches_out = port_model.prefill(port_params, port_cfg, _t(tokens),
                                            caches=caches)
    assert caches_out is caches                       # written in place
    assert _maxdiff(ref_logits, logits) <= TOL
    ref_step_fn = jax.jit(lambda p, t, c, pos: ref_model.decode_step(
        p, ref_cfg, t, caches=c, cache_pos=pos))
    tok = np.asarray(jnp.argmax(ref_logits[:, -1:], -1)).astype(np.int32)
    np.testing.assert_array_equal(tok, torch.argmax(logits[:, -1:], -1).numpy())
    for pos in range(S, total):
        ref_step, ref_caches = ref_step_fn(ref_params, jnp.asarray(tok),
                                           ref_caches, pos)
        step, _ = port_model.decode_step(port_params, port_cfg, _t(tok),
                                         caches=caches, cache_pos=pos)
        assert _maxdiff(ref_step, step) <= TOL, pos
        tok = np.asarray(jnp.argmax(ref_step[:, -1:], -1)).astype(np.int32)
        np.testing.assert_array_equal(tok, torch.argmax(step[:, -1:], -1).numpy())
    ref_leaves = dict(_leaves(jax.tree_util.tree_map(np.asarray, ref_caches)))
    for path, leaf in _leaves(caches):
        _close(ref_leaves[path], leaf, what=str(path))


@pytest.mark.parametrize("arch", MODELS)
def test_backend_site_outputs_equal_reference(arch, arch_setup):
    ref_cfg, port_cfg, ref_params, port_params, tokens = arch_setup(arch)
    ref_outs = []
    base = ref_backends.resolve("tubgemm", bits=4)

    def recording(a, b, bits, _fn=base.spec.exact_fn):
        out = _fn(a, b, bits)
        ref_outs.append(np.asarray(out))
        return out

    recorder = dataclasses.replace(
        base, spec=dataclasses.replace(base.spec, exact_fn=recording))
    with jax.disable_jit(), ref_backends.use_backend(recorder) as ref_ex, \
            ref_common.activation_scaling("per-row"):
        ref_logits, _ = ref_model.forward(ref_params, ref_cfg, jnp.asarray(tokens))
    port_outs = []
    with port_backends.use_backend(
            "tubgemm", bits=4,
            on_output=lambda s, o: port_outs.append((s, o.numpy()))) as ex, \
            port_common.activation_scaling("per-row"):
        logits, _ = port_model.forward(port_params, port_cfg, _t(tokens))
    sites = [c.site for c in ex.calls]
    assert sites == [c.site for c in ref_ex.calls]
    assert CHIP_SMOKE.recorded_sites(port_cfg, port_params) == sites
    assert len(ref_outs) == len(port_outs) == len(sites)
    for ref_o, (site, o) in zip(ref_outs, port_outs):
        assert o.dtype == np.int32
        np.testing.assert_array_equal(ref_o, o, err_msg=site)
    assert _maxdiff(ref_logits, logits) <= TOL
    if arch == "zamba2-1.2b":
        n_groups = port_blocks.hybrid_counts(port_cfg)[0]
        assert sum(s == "shared/attn/wq" for s in sites) == n_groups
    if arch == "rwkv6-3b":
        assert [s for s in sites if not s.startswith("layers/tm/w_")][:3] \
            == ["layers/cm/w_k", "layers/cm/w_v", "layers/cm/w_r"]


def _packed_setup(arch, selector, arch_setup):
    """Each package's packed store of ``arch`` and the scope that executes
    it: every site at tubGEMM@4 (``bits``), or each package's own plan from
    ``build_plan`` (``plan``)."""
    ref_cfg, port_cfg, ref_params, port_params, tokens = arch_setup(arch)
    if selector == "plan":
        ref_sel = ref_planner.build_plan(ref_cfg, ref_params, batch=2, unit_n=64)
        port_sel = port_planner.build_plan(port_cfg, port_params, batch=2, unit_n=64)
        ref_packed = ref_backends.pack_weights(ref_cfg, ref_params, ref_sel)
        port_packed = port_backends.pack_weights(port_cfg, port_params, port_sel)
        ref_scope = lambda: ref_backends.use_plan(ref_sel)               # noqa: E731
        port_scope = lambda **kw: port_backends.use_plan(port_sel, **kw)  # noqa: E731
    else:
        ref_sel, port_sel = (ref_backends.resolve("tubgemm", bits=4),
                             port_backends.resolve("tubgemm", bits=4))
        ref_packed = ref_backends.pack_weights(ref_cfg, ref_params, bits=4)
        port_packed = port_backends.pack_weights(port_cfg, port_params, bits=4)
        ref_scope = lambda: ref_backends.use_backend(ref_sel)               # noqa: E731
        port_scope = lambda **kw: port_backends.use_backend(port_sel, **kw)  # noqa: E731
    return ref_packed, port_packed, ref_scope, port_scope, port_sel


@pytest.mark.parametrize("selector", ["bits", "plan"])
@pytest.mark.parametrize("arch", RECURRENT)
def test_packed_stores_and_their_site_outputs_equal_reference(
        arch, selector, arch_setup, monkeypatch):
    """``pack_weights`` takes both recurrent trees (RWKV's (d, h, k) site
    weights, zamba2's ``shared/…`` sites) as the reference's does: the same
    packed leaves, words and scales; a forward from the packed store gives
    every site's int32 output EQUAL to the reference's packed forward and
    logits equal to the port's float-store forward bit for bit."""
    ref_cfg, port_cfg, ref_params, port_params, tokens = arch_setup(arch)
    ref_packed, port_packed, ref_scope, port_scope, _ = _packed_setup(
        arch, selector, arch_setup)
    ref_flat = dict(port_planner._walk(ref_packed))
    port_flat = dict(port_planner._walk(port_packed))
    assert ref_flat.keys() == port_flat.keys()
    packed = [n for n, leaf in port_flat.items() if port_packing.is_packed(leaf)]
    assert packed == [n for n, leaf in ref_flat.items() if ref_packing.is_packed(leaf)]
    assert len(packed) == (14 if arch == "zamba2-1.2b" else 8)
    for name in packed:
        r, p = ref_flat[name], port_flat[name]
        assert (p.bits, p.k, p.tail, p.k_shape) == (r.bits, r.k, r.tail, r.k_shape), name
        np.testing.assert_array_equal(np.asarray(r.packed), p.packed.numpy(), err_msg=name)
        np.testing.assert_array_equal(np.asarray(r.scale), p.scale.numpy(), err_msg=name)

    ref_outs = []
    execute = ref_base.GemmBackend.execute

    def recording(self, a, b):
        out = execute(self, a, b)
        ref_outs.append(np.asarray(out))
        return out

    monkeypatch.setattr(ref_base.GemmBackend, "execute", recording)
    with jax.disable_jit(), ref_scope() as ref_ex, ref_common.activation_scaling("per-row"):
        ref_logits, _ = ref_model.forward(ref_packed, ref_cfg, jnp.asarray(tokens))
    monkeypatch.undo()
    runs = []
    for tree in (port_packed, port_params):
        outs = []
        with port_scope(on_output=lambda s, o: outs.append((s, o.clone()))), \
                port_common.activation_scaling("per-row"):
            logits, _ = port_model.forward(tree, port_cfg, _t(tokens))
        runs.append((outs, logits))
    (outs, logits), (_, float_logits) = runs
    assert [s for s, _ in outs] == [c.site for c in ref_ex.calls]
    assert len(ref_outs) == len(outs) > 0
    for want, (site, got) in zip(ref_outs, outs):
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(want, got.numpy(), err_msg=site)
    assert torch.equal(logits, float_logits)
    assert _maxdiff(ref_logits, logits) <= TOL


@pytest.mark.parametrize("selector", ["bits", "plan"])
@pytest.mark.parametrize("arch", RECURRENT)
def test_one_shot_serve_from_packed_stores_equals_the_float_store(
        arch, selector, arch_setup):
    """The one-shot serve mode's ``run_backend_execution`` (``bits``) and
    ``run_plan_execution`` (``plan``) with ``packed=True``: prefill and
    greedy decode through the recurrent caches give the tokens, drift and
    integer-GEMM check of the same run from the float store."""
    _, port_cfg, _, port_params, tokens = arch_setup(arch)
    _, _, _, _, port_sel = _packed_setup(arch, selector, arch_setup)
    prompt = _t(tokens[:, :6])
    results = []
    for packed in (True, False):
        if selector == "plan":
            res = port_serve.run_plan_execution(port_cfg, port_params, prompt,
                                                port_sel, 3, packed=packed)
        else:
            res = port_serve.run_backend_execution(
                port_cfg, port_params, prompt, port_sel, 3, unit_n=64,
                num_units=64, packed=packed)
        results.append(res)
    packed_res, float_res = results
    assert tuple(packed_res["tokens"].shape) == (B, 3)
    assert torch.equal(packed_res["tokens"], float_res["tokens"])
    assert packed_res["drift"] == float_res["drift"]
    assert packed_res["rel_rmse"] == float_res["rel_rmse"]
    rel = packed_res["rel_rmse"]
    assert all(v == 0.0 for v in rel.values()) if isinstance(rel, dict) else rel == 0.0


@pytest.mark.parametrize("arch", RECURRENT)
def test_loss_and_gradients_match_reference(arch, arch_setup):
    ref_cfg, port_cfg, ref_params, port_params, tokens = arch_setup(arch)

    def loss_of(p):
        return ref_model.loss_fn(p, ref_cfg, jnp.asarray(tokens[:, :-1]),
                                 jnp.asarray(tokens[:, 1:]))[0]

    ref_loss, ref_grads = jax.jit(jax.value_and_grad(loss_of))(ref_params)
    tree = port_steps._trainable(port_model.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, ref_params), device="cpu"))
    loss, _, grads = port_steps.loss_and_grads(port_cfg, tree, {
        "tokens": _t(tokens[:, :-1]), "targets": _t(tokens[:, 1:])})
    assert abs(float(ref_loss) - float(loss)) <= TOL * abs(float(ref_loss))
    ref_leaves = dict(_leaves(jax.tree_util.tree_map(np.asarray, ref_grads)))
    port_leaves = dict(_leaves(grads))
    assert set(port_leaves) == set(ref_leaves)
    for path, g in port_leaves.items():
        scale = float(np.abs(ref_leaves[path]).max())
        assert scale > 0.0, path                      # every leaf is read
        assert _maxdiff(ref_leaves[path], g) <= TOL * scale, path


def test_rwkv_gradient_at_init_spikes_in_the_bonus_as_the_reference_does():
    """At init the bonus ``u`` is 0 and the WKV state empty, so each layer's
    first WKV output is exactly 0 and group norm divides its gradient by
    sqrt(0 + 1e-5): the reference's gradient of ``u`` (its first layer's
    above all) dwarfs every other leaf — a fact about the oracle, at RWKV6's
    published head dims (head 64, decay LoRA 64).  The port's gradients, at
    the reference's own init parameters, equal it within 1e-4."""
    kw = dict(num_layers=4, d_model=128, num_heads=2, num_kv_heads=2, d_ff=448,
              vocab_size=512, remat=False, compute_dtype="float32")
    ref_cfg = ref_configs.get_config("rwkv6-3b").replace(
        rwkv=ref_config.RWKVConfig(head_dim=64, decay_lora=64), **kw)
    port_cfg = port_configs.get_config("rwkv6-3b").replace(
        rwkv=port_config.RWKVConfig(head_dim=64, decay_lora=64), **kw)
    raw = jax.tree_util.tree_map(np.asarray,
                                 ref_model.init_params(ref_cfg, jax.random.PRNGKey(0)))
    tokens = np.random.default_rng(1).integers(0, 512, (2, 33)).astype(np.int32)
    ref_loss, ref_grads = jax.jit(jax.value_and_grad(lambda p: ref_model.loss_fn(
        p, ref_cfg, jnp.asarray(tokens[:, :-1]), jnp.asarray(tokens[:, 1:]))[0]))(
        jax.tree_util.tree_map(jnp.asarray, raw))
    loss, _, grads = port_steps.loss_and_grads(
        port_cfg, port_steps._trainable(port_model.params_from_numpy(raw, device="cpu")),
        {"tokens": _t(tokens[:, :-1]), "targets": _t(tokens[:, 1:])})
    ref_leaves = dict(_leaves(jax.tree_util.tree_map(np.asarray, ref_grads)))
    port_leaves = dict(_leaves(grads))
    assert abs(float(ref_loss) - float(loss)) <= TOL * abs(float(ref_loss))
    for path, g in port_leaves.items():
        scale = float(np.abs(ref_leaves[path]).max())
        assert _maxdiff(ref_leaves[path], g) <= TOL * scale, path

    u = ("layers", "tm", "u")
    for leaves in (ref_leaves, {k: _np(v) for k, v in port_leaves.items()}):
        norms = sorted(((float(np.linalg.norm(v)), k) for k, v in leaves.items()),
                       reverse=True)
        assert norms[0][1] == u and norms[0][0] > 100 * norms[1][0], norms[:2]
        by_layer = np.linalg.norm(leaves[u].reshape(kw["num_layers"], -1), axis=1)
        assert by_layer[0] > 0.9 * norms[0][0], by_layer


# ---------------------------------------------------------------------------
# Planner, energy walk, registry, engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", MODELS)
def test_planner_sites_and_plan_equal_reference(arch, arch_setup):
    ref_cfg, port_cfg, ref_params, port_params, _ = arch_setup(arch)
    ref_sites = ref_planner.discover_sites(ref_cfg, ref_params, batch=4)
    port_sites = port_planner.discover_sites(port_cfg, port_params, batch=4)
    keys = [(s.name, s.m, s.k, s.n_out, s.count) for s in port_sites]
    assert keys == [(s.name, s.m, s.k, s.n_out, s.count) for s in ref_sites]
    shared = [s for s in port_sites if s.name.startswith("shared/")]
    if port_cfg.family == "hybrid":
        n_groups = port_blocks.hybrid_counts(port_cfg)[0]
        assert len(shared) == 7 and all(s.count == n_groups for s in shared)
        for s in shared:
            copies, applications = port_planner._site_copies(s, s.weight_matrix())
            assert (copies.shape[0], applications) == (1, n_groups)
    else:
        assert not shared
    ref_plan = ref_planner.build_plan(ref_cfg, ref_params, batch=4, unit_n=64)
    port_plan = port_planner.build_plan(port_cfg, port_params, batch=4, unit_n=64)
    assert len(port_plan.sites) == len(ref_plan.sites) == len(keys)
    for r, p in zip(ref_plan.sites, port_plan.sites):
        assert (p.pattern, p.design, p.bits, p.m, p.k, p.n_out, p.count) \
            == (r.pattern, r.design, r.bits, r.m, r.k, r.n_out, r.count)
        assert p.dyn_energy_uj == pytest.approx(r.dyn_energy_uj, rel=1e-12)
        assert p.rel_mse == pytest.approx(r.rel_mse, rel=1e-5)


@pytest.mark.parametrize("arch", MODELS)
def test_iter_weight_matrices_equal_reference(arch, arch_setup):
    ref_cfg, port_cfg, ref_params, port_params, _ = arch_setup(arch)
    ref_w = [(n, w.shape) for n, w in ref_energy.iter_weight_matrices(ref_cfg, ref_params)]
    port_w = [(n, tuple(w.shape))
              for n, w in port_energy.iter_weight_matrices(port_cfg, port_params)]
    assert port_w == ref_w
    names = {n for n, _ in port_w}
    if arch == "rwkv6-3b":
        assert {"layers/tm/w_o", "layers/tm/wa", "layers/tm/wb"} <= names
    else:
        assert {"layers/ssm/conv_x_w", "layers/ssm/conv_bc_w"} <= names


def test_shared_site_cycles_within_bounds(arch_setup):
    """Zamba2's shared block: one physical weight applied n_groups times a
    step — the measured cycles stay within [floor, wc] (the reference's
    tests/test_planner.py::test_hybrid_shared_sites_measure_and_plan)."""
    _, cfg, _, params, _ = arch_setup("zamba2-1.2b")
    plan = port_planner.build_plan(cfg, params, batch=2, unit_n=64,
                                   num_units=64, designs=("tubgemm",),
                                   bits_candidates=(4,))
    n_groups = port_blocks.hybrid_counts(cfg)[0]
    sites = {s.name: s for s in port_planner.discover_sites(cfg, params, batch=2)}
    shared = [e for e in plan.sites if e.pattern.startswith("shared/")]
    assert shared
    for e in shared:
        assert e.count == n_groups
        cyc = port_planner.measure_site_cycles(sites[e.pattern], e,
                                               unit_n=64, num_units=64)
        assert cyc["dyn_floor"] - 0.5 <= cyc["measured"] <= cyc["wc"] + 0.5


def test_registry_order_and_cells_equal_reference():
    assert port_configs.ARCH_IDS == ref_configs.ARCH_IDS
    assert port_configs.SHAPES == ref_configs.SHAPES
    for include in (False, True):
        assert port_configs.cells(include) == ref_configs.cells(include)
    assert len(port_configs.cells(True)) == 40 and len(port_configs.cells()) == 32
    assert {a for a, s in port_configs.cells() if s == "long_500k"} == set(RECURRENT)


def _def_count(defs, param_def) -> int:
    if isinstance(defs, param_def):
        return math.prod(defs.shape)
    return sum(_def_count(v, param_def) for v in defs.values())


@pytest.mark.parametrize("arch,lo,hi", [("zamba2-1.2b", 1.1e9, 1.25e9),
                                        ("rwkv6-3b", 3.0e9, 3.15e9)])
def test_full_config_parameter_counts(arch, lo, hi):
    ref_n = _def_count(ref_model.model_defs(ref_configs.get_config(arch)),
                       ref_common.ParamDef)
    port_n = _def_count(port_model.model_defs(port_configs.get_config(arch)),
                        port_common.ParamDef)
    assert port_n == ref_n and lo < port_n < hi


@pytest.mark.parametrize("arch", RECURRENT)
def test_engine_refuses_recurrent_like_the_reference(arch, arch_setup):
    ref_cfg, port_cfg, ref_params, port_params, _ = arch_setup(arch)
    with pytest.raises(ValueError) as ref_err:
        ref_engine.ServingEngine(ref_cfg, ref_params)
    with pytest.raises(ValueError) as port_err:
        ServingEngine(port_cfg, port_params, device="cpu")
    assert str(port_err.value) == str(ref_err.value)


@pytest.mark.parametrize("arch", RECURRENT)
def test_serve_cli_plans_and_serves_packed_recurrent_archs(arch, tmp_path, capsys):
    """``serve plan`` writes a plan for the recurrent arch, and the one-shot
    ``serve`` mode replays it from packed stores (``--backend-plan
    --packed``) and runs ``--execute-backend tubgemm --packed``, each with
    bit-exact integer GEMMs."""
    base = ["--arch", arch, "--smoke", "--device", "cpu"]
    plan = tmp_path / "plan.json"
    assert port_serve.main(["plan", *base, "--batch", "2", "--plan-out", str(plan)]) == 0
    capsys.readouterr()
    assert port_serve.main(["serve", *base, "--backend-plan", str(plan), "--packed",
                            "--tokens", "3"]) == 0
    out = capsys.readouterr().out
    assert "analysis: OK" in out
    assert "int GEMMs vs binary oracle on tubgemm@4: bit-exact" in out
    assert port_serve.main(["serve", *base, "--execute-backend", "tubgemm", "--packed",
                            "--tokens", "3"]) == 0
    assert "int GEMMs vs binary oracle: bit-exact" in capsys.readouterr().out
