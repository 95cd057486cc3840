"""Port vs reference: the dense-family model (llama3-8b smoke config, fp32).

The reference runs OUTSIDE any mesh (its sharding helper is then a no-op).
Parameters come from the reference's ``init_params`` through the port's
``params_from_numpy``; tokens come from a numpy seed.

* float path — ``forward`` / ``prefill`` / ``decode_step`` logits and KV
  caches agree to <= 1e-4 abs (fp32 matmuls summed in different orders);
* under ``use_backend("tubgemm", bits=4)`` with per-row activation scaling —
  the integer GEMM output of every site is EQUAL, logits <= 1e-4.
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
from repro_torch import backends as port_backends
from repro_torch import configs as port_configs
from repro_torch.models import common as port_common
from repro_torch.models import model as port_model

TOL = 1e-4


@pytest.fixture(scope="module")
def setup():
    ref_cfg = ref_configs.get_smoke_config("llama3-8b").replace(
        compute_dtype="float32")
    port_cfg = port_configs.get_smoke_config("llama3-8b").replace(
        compute_dtype="float32")
    ref_params = ref_model.init_params(ref_cfg, jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(np.asarray, ref_params)
    port_params = port_model.params_from_numpy(tree, device="cpu")
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, ref_cfg.vocab_size, (2, 9)).astype(np.int32)
    return ref_cfg, port_cfg, ref_params, port_params, tokens


def _maxdiff(ref, port):
    return float(np.abs(np.asarray(ref) - port.detach().numpy()).max())


def test_converter_round_trip(setup):
    _, port_cfg, ref_params, port_params, _ = setup
    ref_leaves = jax.tree_util.tree_flatten_with_path(ref_params)[0]

    def walk(tree, prefix=()):
        for k in sorted(tree):
            if isinstance(tree[k], dict):
                yield from walk(tree[k], prefix + (k,))
            else:
                yield prefix + (k,), tree[k]

    port_leaves = list(walk(port_params))
    assert len(ref_leaves) == len(port_leaves)
    for (rpath, rleaf), (ppath, pleaf) in zip(ref_leaves, port_leaves):
        assert tuple(p.key for p in rpath) == ppath       # same sorted walk
        assert tuple(rleaf.shape) == tuple(pleaf.shape)
        np.testing.assert_array_equal(np.asarray(rleaf), pleaf.numpy())
    assert port_model.count_params(port_params) == ref_model.count_params(ref_params)
    # the port's own initialiser builds the same tree (shapes, dtypes)
    gen = torch.Generator(device="cpu")
    gen.manual_seed(0)
    own = dict(walk(port_model.init_params(port_cfg, gen, device="cpu")))
    assert {k: tuple(v.shape) for k, v in own.items()} \
        == {k: tuple(v.shape) for k, v in port_leaves}
    assert float(own[("final_norm",)].min()) == 1.0
    assert abs(float(own[("embed",)].std()) - 0.02) < 2e-3
    half = port_model.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, ref_params), device="cpu",
        dtype=torch.bfloat16)
    assert half["lm_head"].dtype == torch.bfloat16


def test_entry_points_demand_a_device_by_default(setup):
    _, port_cfg, _, _, _ = setup
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device exists")
    with pytest.raises(RuntimeError, match="cuda"):
        port_model.init_params(port_cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        port_model.init_caches(port_cfg, 1, 4)


def test_forward_logits(setup):
    ref_cfg, port_cfg, ref_params, port_params, tokens = setup
    ref_logits, _ = ref_model.forward(ref_params, ref_cfg, jnp.asarray(tokens))
    logits, aux = port_model.forward(port_params, port_cfg, torch.from_numpy(tokens))
    assert tuple(logits.shape) == (2, 9, ref_cfg.vocab_size)
    assert float(aux) == 0.0
    assert _maxdiff(ref_logits, logits) <= TOL


def test_prefill_and_decode_logits(setup):
    ref_cfg, port_cfg, ref_params, port_params, tokens = setup
    total = 12
    ref_caches = ref_model.init_caches(ref_cfg, 2, total, dtype=jnp.float32)
    caches = port_model.init_caches(port_cfg, 2, total, dtype=torch.float32,
                                    device="cpu")
    ref_logits, ref_caches = ref_model.prefill(ref_params, ref_cfg,
                                               jnp.asarray(tokens), caches=ref_caches)
    logits, caches = port_model.prefill(port_params, port_cfg,
                                        torch.from_numpy(tokens), caches=caches)
    assert _maxdiff(ref_logits, logits) <= TOL
    for key in ("k", "v"):
        assert _maxdiff(ref_caches["attn"][key], caches["attn"][key]) <= TOL
    tok = np.asarray(jnp.argmax(ref_logits[:, -1:], axis=-1)).astype(np.int32)
    np.testing.assert_array_equal(
        tok, torch.argmax(logits[:, -1:], dim=-1).numpy())
    for pos in (9, 10, 11):
        ref_step, ref_caches = ref_model.decode_step(
            ref_params, ref_cfg, jnp.asarray(tok), caches=ref_caches,
            cache_pos=pos)
        step, caches = port_model.decode_step(
            port_params, port_cfg, torch.from_numpy(tok), caches=caches,
            cache_pos=pos)
        assert tuple(step.shape) == (2, 1, ref_cfg.vocab_size)
        assert _maxdiff(ref_step, step) <= TOL
        tok = np.asarray(jnp.argmax(ref_step[:, -1:], axis=-1)).astype(np.int32)


@pytest.mark.parametrize("act_scale", ["per-row", "per-tensor"])
def test_backend_scope_integer_sites_equal(setup, act_scale):
    ref_cfg, port_cfg, ref_params, port_params, tokens = setup
    ref_outs = []
    base = ref_backends.resolve("tubgemm", bits=4)

    def recording(a, b, bits, _fn=base.spec.exact_fn):
        out = _fn(a, b, bits)
        ref_outs.append(np.asarray(out))
        return out

    recorder = dataclasses.replace(
        base, spec=dataclasses.replace(base.spec, exact_fn=recording))
    # eager reference: lax.scan unrolls in Python, so every layer's integer
    # GEMM output is a concrete array the recorder can keep
    with jax.disable_jit(), ref_backends.use_backend(recorder) as ref_ex, \
            ref_common.activation_scaling(act_scale):
        ref_logits, _ = ref_model.forward(ref_params, ref_cfg, jnp.asarray(tokens))
    port_outs = []
    with port_backends.use_backend(
            "tubgemm", bits=4,
            on_output=lambda site, out: port_outs.append((site, out.numpy()))) as ex, \
            port_common.activation_scaling(act_scale):
        logits, _ = port_model.forward(port_params, port_cfg,
                                       torch.from_numpy(tokens))
    sites = ["layers/attn/wq", "layers/attn/wk", "layers/attn/wv",
             "layers/attn/wo", "layers/mlp/w_up", "layers/mlp/w_gate",
             "layers/mlp/w_down"] * ref_cfg.num_layers + ["lm_head"]
    assert [s for s, _ in port_outs] == sites == [c.site for c in ex.calls]
    assert len(ref_outs) == len(port_outs)
    for ref_out, (site, out) in zip(ref_outs, port_outs):
        np.testing.assert_array_equal(ref_out, out, err_msg=site)
    ref_sites = {(c.site, c.m, c.k, c.n_out, c.bits) for c in ref_ex.calls}
    assert {(c.site, c.m, c.k, c.n_out, c.bits) for c in ex.calls} == ref_sites
    assert _maxdiff(ref_logits, logits) <= TOL


def test_weight_code_cache_is_bit_identical(setup):
    _, port_cfg, _, port_params, tokens = setup
    toks = torch.from_numpy(tokens)
    runs = []
    cache: dict = {}
    for weight_cache in (None, cache, cache):     # per call, fill, reuse
        outs = []
        with port_backends.use_backend(
                "tubgemm_cuda", bits=4, weight_cache=weight_cache,
                on_output=lambda s, o: outs.append(o.clone())), \
                port_common.activation_scaling("per-row"):
            logits, _ = port_model.forward(port_params, port_cfg, toks)
        runs.append((logits, outs))
    assert len(cache) == 7 * port_cfg.num_layers + 1
    for logits, outs in runs[1:]:
        assert torch.equal(logits, runs[0][0])
        assert all(torch.equal(a, b) for a, b in zip(outs, runs[0][1]))
    from repro_torch.core.quantization import quantize
    wq = quantize(port_params["lm_head"], bits=4)
    kept, cached = cache[(port_params["lm_head"].data_ptr(), (64, 512),
                          torch.float32, 4)]
    assert kept.data_ptr() == port_params["lm_head"].data_ptr()
    assert torch.equal(wq.values, cached.values) and torch.equal(wq.scale, cached.scale)


def test_scopes_and_unported_options(setup):
    _, port_cfg, _, port_params, tokens = setup
    assert port_backends.active_execution() is None
    with port_backends.use_backend("bgemm", bits=8) as outer:
        with port_backends.site_scope("layers"), port_backends.site_scope("attn"):
            assert port_backends.current_site("wq") == "layers/attn/wq"
        with port_backends.use_backend("tugemm", bits=2) as inner:
            assert port_backends.active_backend() is inner.backend
        assert port_backends.active_backend() is outer.backend
    assert port_backends.current_site() == ""
    with pytest.raises(ValueError):
        with port_common.activation_scaling("per-column"):
            pass
    # grid= shards every dense contraction on a 2x2 grid: the same sites
    # and logits bit-identical to the single unit's
    with port_backends.use_backend("tubgemm", bits=4, grid=(2, 2)) as gx:
        assert port_backends.active_backend().grid == (2, 2)
        grid_logits, _ = port_model.forward(port_params, port_cfg,
                                            torch.from_numpy(tokens))
    with port_backends.use_backend("tubgemm", bits=4) as fx:
        flat_logits, _ = port_model.forward(port_params, port_cfg,
                                            torch.from_numpy(tokens))
    assert [c.site for c in gx.calls] == [c.site for c in fx.calls]
    assert torch.equal(grid_logits, flat_logits)
    # quant_backend="ugemm" runs uGEMM's multiplier (held to the reference
    # in tests/test_torch_quant_gemm.py and tests/test_torch_serving.py)
    logits, _ = port_model.forward(port_params, port_cfg.replace(
        quant_bits=4, quant_kernel=True, quant_backend="ugemm"),
        torch.from_numpy(tokens))
    assert bool(torch.isfinite(logits).all())
