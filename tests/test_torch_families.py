"""Port vs reference: the attention-transformer families, every registered
architecture the port adds to llama3-8b (smoke configs, fp32, CPU).

Parameters come from the reference's ``init_params`` through the port's
``params_from_numpy``; tokens and frame / patch embeddings (the audio and
vlm frontend stubs) from the test's own ``np.random.default_rng(seed)``.

* the converter round trip (same leaves, same parameter count);
* ``forward``, ``prefill`` and three ``decode_step`` logits <= 1e-4, greedy
  tokens equal;
* every site's int32 output of the forward under
  ``use_backend("tubgemm", bits=4)`` with per-row scaling EQUAL;
* the planner's sites (the shared expert, the MLA projections, ``wo``,
  ``lm_head``) and its plan equal to the reference's;
* a frontend stub's loss and gradients from embeddings against
  ``jax.value_and_grad`` (the unread token table: a zero gradient);
* full-config parameter counts from ``model_defs`` EQUAL for every
  registered id;
* ``ServingEngine`` refuses MoE and MLA with the reference's message.

The recurrent families (zamba2-1.2b, rwkv6-3b and a pure Mamba2 stack) are
held against the reference in ``tests/test_torch_recurrent.py``.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import backends as ref_backends
from repro import configs as ref_configs
from repro.models import common as ref_common
from repro.models import model as ref_model
from repro.eval import planner as ref_planner
from repro.serving import engine as ref_engine
from repro_torch import backends as port_backends
from repro_torch import configs as port_configs
from repro_torch.eval import planner as port_planner
from repro_torch.launch import steps as port_steps
from repro_torch.models import common as port_common
from repro_torch.models import model as port_model
from repro_torch.serving import ServingEngine

NEW_ARCHS = ("gemma-7b", "phi3-mini-3.8b", "internlm2-1.8b", "chameleon-34b",
             "musicgen-medium", "phi3.5-moe-42b-a6.6b", "deepseek-v3-671b")
TOL = 1e-4
B, S, STEPS = 2, 9, 3


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
            ref_cfg = ref_configs.get_smoke_config(arch).replace(
                compute_dtype="float32")
            port_cfg = port_configs.get_smoke_config(arch).replace(
                compute_dtype="float32")
            ref_params = ref_model.init_params(ref_cfg, jax.random.PRNGKey(0))
            port_params = port_model.params_from_numpy(
                jax.tree_util.tree_map(np.asarray, ref_params), device="cpu")
            rng = np.random.default_rng(sum(map(ord, arch)))
            tokens = rng.integers(0, ref_cfg.vocab_size, (B, S)).astype(np.int32)
            embeds = (rng.standard_normal((B, S, ref_cfg.d_model)).astype(np.float32)
                      if ref_cfg.frontend_stub else None)
            cache[arch] = (ref_cfg, port_cfg, ref_params, port_params, tokens,
                           embeds)
        return cache[arch]

    return get


def _maxdiff(ref, port) -> float:
    return float(np.abs(np.asarray(ref, np.float64)
                        - port.detach().double().numpy()).max())


def _inputs(tokens, embeds):
    """(reference kwargs, port kwargs): embeddings for a frontend stub."""
    if embeds is not None:
        return ({"embeds": jnp.asarray(embeds)},
                {"embeds": torch.from_numpy(embeds)})
    return {"tokens": jnp.asarray(tokens)}, {"tokens": torch.from_numpy(tokens)}


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_converter_round_trip(arch, arch_setup):
    ref_cfg, port_cfg, ref_params, port_params, _, _ = arch_setup(arch)
    ref_leaves = jax.tree_util.tree_flatten_with_path(ref_params)[0]
    port_leaves = list(_leaves(port_params))
    assert len(ref_leaves) == len(port_leaves)
    for (rpath, rleaf), (ppath, pleaf) in zip(ref_leaves, port_leaves):
        assert tuple(p.key for p in rpath) == ppath
        np.testing.assert_array_equal(np.asarray(rleaf), pleaf.numpy())
    assert port_model.count_params(port_params) == ref_model.count_params(ref_params)
    gen = torch.Generator(device="cpu")
    gen.manual_seed(0)
    own = dict(_leaves(port_model.init_params(port_cfg, gen, device="cpu")))
    assert {k: tuple(v.shape) for k, v in own.items()} \
        == {k: tuple(v.shape) for k, v in port_leaves}


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_forward_prefill_decode_match_reference(arch, arch_setup):
    ref_cfg, port_cfg, ref_params, port_params, tokens, embeds = arch_setup(arch)
    ref_in, port_in = _inputs(tokens, embeds)
    ref_logits, ref_aux = jax.jit(
        lambda p, **kw: ref_model.forward(p, ref_cfg, **kw))(ref_params, **ref_in)
    logits, aux = port_model.forward(port_params, port_cfg, **port_in)
    assert tuple(logits.shape) == (B, S, ref_cfg.vocab_size)
    assert _maxdiff(ref_logits, logits) <= TOL
    assert _maxdiff(ref_aux, aux) <= 1e-5
    assert (float(aux) > 0.0) == ref_cfg.is_moe

    total = S + STEPS
    ref_caches = ref_model.init_caches(ref_cfg, B, total, dtype=jnp.float32)
    caches = port_model.init_caches(port_cfg, B, total, dtype=torch.float32,
                                    device="cpu")
    ref_logits, ref_caches = jax.jit(
        lambda p, c, **kw: ref_model.prefill(p, ref_cfg, caches=c, **kw))(
        ref_params, ref_caches, **ref_in)
    logits, caches = port_model.prefill(port_params, port_cfg, caches=caches,
                                        **port_in)
    assert _maxdiff(ref_logits, logits) <= TOL
    ref_step_fn = jax.jit(lambda p, t, c, pos: ref_model.decode_step(
        p, ref_cfg, t, caches=c, cache_pos=pos))
    tok = np.asarray(jnp.argmax(ref_logits[:, -1:], -1)).astype(np.int32)
    np.testing.assert_array_equal(tok, torch.argmax(logits[:, -1:], -1).numpy())
    for pos in range(S, total):
        ref_step, ref_caches = ref_step_fn(ref_params, jnp.asarray(tok),
                                           ref_caches, pos)
        step, caches = port_model.decode_step(
            port_params, port_cfg, torch.from_numpy(tok), caches=caches,
            cache_pos=pos)
        assert _maxdiff(ref_step, step) <= TOL, pos
        tok = np.asarray(jnp.argmax(ref_step[:, -1:], -1)).astype(np.int32)
        np.testing.assert_array_equal(tok, torch.argmax(step[:, -1:], -1).numpy())
    for key, ref_c in ref_caches["attn"].items():
        assert _maxdiff(ref_c, caches["attn"][key]) <= TOL, key


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_backend_site_outputs_equal_reference(arch, arch_setup):
    ref_cfg, port_cfg, ref_params, port_params, tokens, embeds = arch_setup(arch)
    ref_in, port_in = _inputs(tokens, embeds)
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
        ref_logits, _ = ref_model.forward(ref_params, ref_cfg, **ref_in)
    port_outs = []
    with port_backends.use_backend(
            "tubgemm", bits=4,
            on_output=lambda s, o: port_outs.append((s, o.numpy()))) as ex, \
            port_common.activation_scaling("per-row"):
        logits, _ = port_model.forward(port_params, port_cfg, **port_in)
    assert [c.site for c in ex.calls] == [c.site for c in ref_ex.calls]
    assert len(ref_outs) == len(port_outs) == len(ex.calls)
    for ref_o, (site, o) in zip(ref_outs, port_outs):
        assert o.dtype == np.int32
        np.testing.assert_array_equal(ref_o, o, err_msg=site)
    assert _maxdiff(ref_logits, logits) <= TOL


@pytest.mark.parametrize("arch", ["phi3.5-moe-42b-a6.6b", "deepseek-v3-671b",
                                  "musicgen-medium"])
def test_planner_sites_and_plan_equal_reference(arch, arch_setup):
    ref_cfg, port_cfg, ref_params, port_params, _, _ = arch_setup(arch)
    ref_sites = ref_planner.discover_sites(ref_cfg, ref_params, batch=4)
    port_sites = port_planner.discover_sites(port_cfg, port_params, batch=4)
    keys = [(s.name, s.m, s.k, s.n_out, s.count) for s in port_sites]
    assert keys == [(s.name, s.m, s.k, s.n_out, s.count) for s in ref_sites]
    ref_plan = ref_planner.build_plan(ref_cfg, ref_params, batch=4, unit_n=64)
    port_plan = port_planner.build_plan(port_cfg, port_params, batch=4, unit_n=64)
    assert len(port_plan.sites) == len(ref_plan.sites) == len(keys)
    for r, p in zip(ref_plan.sites, port_plan.sites):
        assert (p.pattern, p.design, p.bits, p.m, p.k, p.n_out, p.count) \
            == (r.pattern, r.design, r.bits, r.m, r.k, r.n_out, r.count)
        assert p.dyn_energy_uj == pytest.approx(r.dyn_energy_uj, rel=1e-12)
        assert p.rel_mse == pytest.approx(r.rel_mse, rel=1e-5)


@pytest.mark.parametrize("arch", ["musicgen-medium", "chameleon-34b"])
def test_frontend_stub_gradients_match_reference(arch, arch_setup):
    ref_cfg, port_cfg, ref_params, port_params, tokens, embeds = arch_setup(arch)

    def loss_of(p):
        return ref_model.loss_fn(p, ref_cfg, None, jnp.asarray(tokens[:, 1:]),
                                 embeds=jnp.asarray(embeds[:, :-1]))[0]

    ref_loss, ref_grads = jax.jit(jax.value_and_grad(loss_of))(ref_params)
    tree = port_steps._trainable(port_model.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, ref_params), device="cpu"))
    loss, _, grads = port_steps.loss_and_grads(port_cfg, tree, {
        "targets": torch.from_numpy(tokens[:, 1:]),
        "embeds": torch.from_numpy(embeds[:, :-1])})
    assert abs(float(ref_loss) - float(loss)) <= TOL
    ref_leaves = dict(_leaves(jax.tree_util.tree_map(np.asarray, ref_grads)))
    for path, g in _leaves(grads):
        assert _maxdiff(ref_leaves[path], g) <= TOL, path
    assert not bool(grads["embed"].any())       # embeddings bypass the table


@pytest.mark.parametrize("feed", ["tokens", "embeds"])
def test_loss_and_grads_refuses_a_leaf_the_loss_does_not_read(feed):
    """Only the token table of a model fed embeddings may go unread: any
    other leaf the loss never reaches still makes ``loss_and_grads`` raise."""
    cfg = port_configs.get_smoke_config("musicgen-medium").replace(num_layers=1)
    gen = torch.Generator().manual_seed(0)
    tree = port_steps._trainable(port_model.init_params(cfg, gen, device="cpu"))
    tree["stray"] = torch.zeros(3, requires_grad=True)
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 9)).astype(np.int32))
    batch = {"targets": tokens[:, 1:]}
    if feed == "embeds":
        batch["embeds"] = torch.from_numpy(
            rng.standard_normal((2, 8, cfg.d_model)).astype(np.float32))
    else:
        batch["tokens"] = tokens[:, :-1]
    with pytest.raises(RuntimeError, match="not have been used"):
        port_steps.loss_and_grads(cfg, tree, batch)


def _def_count(defs, param_def) -> int:
    if isinstance(defs, param_def):
        return math.prod(defs.shape)
    return sum(_def_count(v, param_def) for v in defs.values())


def test_full_config_parameter_counts_equal_reference():
    assert port_configs.ARCH_IDS == ref_configs.ARCH_IDS
    for arch in port_configs.ARCH_IDS:
        ref_n = _def_count(ref_model.model_defs(ref_configs.get_config(arch)),
                           ref_common.ParamDef)
        port_n = _def_count(port_model.model_defs(port_configs.get_config(arch)),
                            port_common.ParamDef)
        assert port_n == ref_n, arch
    # deepseek-v3 at 61 layers lands near its published 671 B
    assert 6.0e11 < _def_count(port_model.model_defs(
        port_configs.get_config("deepseek-v3-671b")), port_common.ParamDef) < 8.0e11


@pytest.mark.parametrize("arch", ["deepseek-v3-671b"])
def test_engine_refuses_moe_and_mla_like_the_reference(arch, arch_setup):
    ref_cfg, port_cfg, ref_params, port_params, _, _ = arch_setup(arch)
    with pytest.raises(ValueError) as ref_err:
        ref_engine.ServingEngine(ref_cfg, ref_params)
    with pytest.raises(ValueError) as port_err:
        ServingEngine(port_cfg, port_params)
    assert str(port_err.value) == str(ref_err.value)
