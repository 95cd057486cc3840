"""Port vs reference: Mixture-of-Experts (``models/moe.py``), fp32, CPU.

The same numpy inputs go through ``repro.models.moe`` and
``repro_torch.models.moe``; parameters come from the reference's
``init_params`` through the port's ``params_from_numpy``.  Every input is
drawn from the test's own ``np.random.default_rng(seed)``.

* routing: indices EQUAL (ties to the lower index, as ``lax.top_k``),
  weights and probabilities <= 1e-6, softmax and sigmoid scoring;
* capacity: ``_capacity`` equal, and a forced overflow with tied weights
  at the boundary drops the same tokens;
* ``_local_expert_pass``, ``moe_fwd`` (with a shared expert) and
  ``_aux_loss`` <= 1e-5 (fp32 sums in different orders);
* the shared expert's site outputs under ``use_backend("tubgemm", bits=4)``
  with per-row activation scaling EQUAL (int32);
* ``loss_fn`` value and every gradient <= 1e-4 against
  ``jax.value_and_grad``, phi3.5-moe and deepseek-v3 smoke configs.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import backends as ref_backends
from repro import configs as ref_configs
from repro.models import common as ref_common
from repro.models import model as ref_model
from repro.models import moe as ref_moe
from repro_torch import backends as port_backends
from repro_torch import configs as port_configs
from repro_torch.models import common as port_common
from repro_torch.models import model as port_model
from repro_torch.models import moe as port_moe

MOE_ARCHS = ("phi3.5-moe-42b-a6.6b", "deepseek-v3-671b")


def _cfgs(arch):
    return (ref_configs.get_smoke_config(arch).replace(compute_dtype="float32"),
            port_configs.get_smoke_config(arch).replace(compute_dtype="float32"))


@pytest.fixture(scope="module")
def models():
    out = {}
    for arch in MOE_ARCHS:
        ref_cfg, port_cfg = _cfgs(arch)
        ref_params = ref_model.init_params(ref_cfg, jax.random.PRNGKey(0))
        tree = jax.tree_util.tree_map(np.asarray, ref_params)
        out[arch] = (ref_cfg, port_cfg, ref_params,
                     port_model.params_from_numpy(tree, device="cpu"))
    return out


def _layer0(tree):
    """Layer 0's MoE parameters of a stacked tree (numpy or torch)."""
    def cut(node):
        return {k: cut(v) for k, v in node.items()} if isinstance(node, dict) \
            else node[0]
    return cut(tree["layers"]["moe"])


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _maxdiff(ref, port) -> float:
    return float(np.abs(_np(ref).astype(np.float64) - _np(port)).max())


@pytest.mark.parametrize("scoring", ["softmax", "sigmoid"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_routing_matches_reference(arch, scoring):
    ref_cfg, port_cfg = _cfgs(arch)
    rng = np.random.default_rng(1)
    e = ref_cfg.moe.num_experts
    x = rng.standard_normal((37, ref_cfg.d_model)).astype(np.float32)
    x[5:9] = 0.0          # all-zero rows: every expert ties, lowest indices win
    router = (rng.standard_normal((ref_cfg.d_model, e)) / 8).astype(np.float32)
    r_idx, r_w, r_p = ref_moe._routing(jnp.asarray(router), jnp.asarray(x),
                                       ref_cfg, scoring)
    p_idx, p_w, p_p = port_moe._routing(torch.from_numpy(router),
                                        torch.from_numpy(x), port_cfg, scoring)
    np.testing.assert_array_equal(np.asarray(r_idx), p_idx.numpy())
    np.testing.assert_array_equal(p_idx[5:9].numpy(),
                                  np.tile(np.arange(ref_cfg.moe.top_k), (4, 1)))
    assert _maxdiff(r_w, p_w) <= 1e-6
    assert _maxdiff(r_p, p_p) <= 1e-6


def test_capacity_matches_reference():
    for arch in MOE_ARCHS:
        for full in (False, True):
            ref_cfg = (ref_configs.get_config if full
                       else ref_configs.get_smoke_config)(arch)
            port_cfg = (port_configs.get_config if full
                        else port_configs.get_smoke_config)(arch)
            for t in (1, 2, 3, 4, 5, 8, 17, 64, 256, 512, 1000, 4096):
                assert port_moe._capacity(t, port_cfg) == ref_moe._capacity(t, ref_cfg)
    # phi3.5-moe's prefill at T = 2 x 256 keeps 80 tokens an expert (64 expected)
    assert port_moe._capacity(512, port_configs.get_config(MOE_ARCHS[0])) == 80


def test_capacity_overflow_drops_the_same_tokens():
    """Expert 0 draws more tokens than its capacity, all at one weight, so
    which are kept is decided by the tie order alone (lower index first).
    The smoke config's capacity factor 2.0 never drops at top-2 of 4
    experts, so both configs take 1.0 here."""
    ref_cfg, port_cfg = (c.replace(moe=dataclasses.replace(c.moe, capacity_factor=1.0))
                         for c in _cfgs("phi3.5-moe-42b-a6.6b"))
    e, d, ffe = ref_cfg.moe.num_experts, ref_cfg.d_model, ref_cfg.moe.d_ff_expert
    rng = np.random.default_rng(2)
    t = 24
    cap = port_moe._capacity(t, port_cfg)
    assert cap == ref_moe._capacity(t, ref_cfg) < t
    x = rng.standard_normal((t, d)).astype(np.float32)
    idx = np.stack([np.zeros(t, np.int32),
                    1 + np.arange(t, dtype=np.int32) % (e - 1)], axis=1)
    w = np.full((t, 2), 0.5, np.float32)                   # tied at the boundary
    wg, wu = (rng.standard_normal((e, d, ffe)).astype(np.float32) / 8
              for _ in range(2))
    wd = rng.standard_normal((e, ffe, d)).astype(np.float32) / 8
    ref = ref_moe._local_expert_pass(
        jnp.asarray(x), jnp.asarray(idx), jnp.asarray(w), jnp.asarray(wg),
        jnp.asarray(wu), jnp.asarray(wd), ref_cfg, 0)
    port = port_moe._local_expert_pass(
        torch.from_numpy(x), torch.from_numpy(idx), torch.from_numpy(w),
        torch.from_numpy(wg), torch.from_numpy(wu), torch.from_numpy(wd),
        port_cfg)
    assert _maxdiff(ref, port) <= 1e-5
    # expert 0 kept exactly the first `cap` tokens: take it away and see
    only0 = np.where(np.arange(e)[:, None, None] == 0, 0.0, 1.0).astype(np.float32)
    rest = port_moe._local_expert_pass(
        torch.from_numpy(x), torch.from_numpy(idx), torch.from_numpy(w),
        torch.from_numpy(wg * only0), torch.from_numpy(wu * only0),
        torch.from_numpy(wd), port_cfg)
    changed = (port - rest).abs().amax(dim=1) > 0
    np.testing.assert_array_equal(changed.numpy(), np.arange(t) < cap)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_expert_pass_moe_fwd_and_aux(arch, models):
    ref_cfg, port_cfg, ref_params, port_params = models[arch]
    rp, pp = _layer0(ref_params), _layer0(port_params)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 11, ref_cfg.d_model)).astype(np.float32)
    x_flat = x.reshape(-1, ref_cfg.d_model)
    r_idx, r_w, r_p = ref_moe._routing(rp["router"], jnp.asarray(x_flat), ref_cfg)
    p_idx, p_w, p_p = port_moe._routing(pp["router"], torch.from_numpy(x_flat),
                                        port_cfg)
    np.testing.assert_array_equal(np.asarray(r_idx), p_idx.numpy())
    ref_pass = ref_moe._local_expert_pass(
        jnp.asarray(x_flat), r_idx, r_w, rp["w_gate"], rp["w_up"], rp["w_down"],
        ref_cfg, 0)
    port_pass = port_moe._local_expert_pass(
        torch.from_numpy(x_flat), p_idx, p_w, pp["w_gate"], pp["w_up"],
        pp["w_down"], port_cfg)
    assert _maxdiff(ref_pass, port_pass) <= 1e-5
    assert _maxdiff(ref_moe._aux_loss(r_p, r_idx, ref_cfg),
                    port_moe._aux_loss(p_p, p_idx, port_cfg)) <= 1e-5
    ref_out, ref_aux = ref_moe.moe_fwd(rp, jnp.asarray(x), ref_cfg)
    port_out, port_aux = port_moe.moe_fwd(pp, torch.from_numpy(x), port_cfg)
    assert ("shared" in pp) == (arch == "deepseek-v3-671b")
    assert _maxdiff(ref_out, port_out) <= 1e-5
    assert _maxdiff(ref_aux, port_aux) <= 1e-5


def test_shared_expert_sites_bit_equal_under_tubgemm(models):
    ref_cfg, port_cfg, ref_params, port_params = models["deepseek-v3-671b"]
    rp, pp = _layer0(ref_params), _layer0(port_params)
    x = np.random.default_rng(4).standard_normal(
        (2, 7, ref_cfg.d_model)).astype(np.float32)
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
        ref_out, _ = ref_moe.moe_fwd(rp, jnp.asarray(x), ref_cfg)
    port_outs = []
    with port_backends.use_backend(
            "tubgemm", bits=4,
            on_output=lambda s, o: port_outs.append((s, o.numpy()))) as ex, \
            port_common.activation_scaling("per-row"):
        port_out, _ = port_moe.moe_fwd(pp, torch.from_numpy(x), port_cfg)
    # only the shared expert is a site; router and routed experts stay float
    assert [s for s, _ in port_outs] == ["shared/w_up", "shared/w_gate",
                                         "shared/w_down"]
    assert [c.site for c in ex.calls] == [c.site for c in ref_ex.calls]
    assert len(ref_outs) == len(port_outs)
    for ref_o, (site, o) in zip(ref_outs, port_outs):
        assert o.dtype == np.int32
        np.testing.assert_array_equal(ref_o, o, err_msg=site)
    assert _maxdiff(ref_out, port_out) <= 1e-5


def _walk(tree, prefix=()):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _walk(tree[k], prefix + (k,))
        else:
            yield prefix + (k,), tree[k]


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_loss_and_gradients_match_reference(arch, models):
    ref_cfg, port_cfg, ref_params, _ = models[arch]
    rng = np.random.default_rng(5)
    toks = rng.integers(0, ref_cfg.vocab_size, (2, 13)).astype(np.int32)

    def loss_of(p):
        return ref_model.loss_fn(p, ref_cfg, jnp.asarray(toks[:, :-1]),
                                 jnp.asarray(toks[:, 1:]))[0]

    ref_loss, ref_grads = jax.jit(jax.value_and_grad(loss_of))(ref_params)
    params = port_model.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, ref_params), device="cpu")
    leaves = [t.requires_grad_(True) for _, t in _walk(params)]
    loss, parts = port_model.loss_fn(params, port_cfg,
                                     torch.from_numpy(toks[:, :-1]),
                                     torch.from_numpy(toks[:, 1:]))
    grads = torch.autograd.grad(loss, leaves)
    assert float(parts["aux"].detach()) > 0.0            # the MoE loss reaches loss_fn
    assert abs(float(ref_loss) - float(loss.detach())) <= 1e-4
    ref_leaves = dict(_walk(jax.tree_util.tree_map(np.asarray, ref_grads)))
    for (path, _), g in zip(_walk(params), grads):
        assert _maxdiff(ref_leaves[path], g) <= 1e-4, path
