"""The port's launch-side cost tools on the CPU: ``hlo_cost`` (counted on
``meta``), ``hlo_stats`` (H100 roofline terms), ``steps.input_specs`` and
``dryrun``, held to the reference where the two compute the same number."""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from repro import configs as ref_configs
from repro.launch import hlo_cost as ref_hlo_cost
from repro.launch import steps as ref_steps
from repro_torch import configs
from repro_torch.analysis import jaxpr_scan
from repro_torch.eval.planner import _walk
from repro_torch.kernels import flash_attention as flash_lib
from repro_torch.kernels.flash_attention import flash_ops
from repro_torch.launch import dryrun, hlo_cost, hlo_stats, steps
from repro_torch.models import model as model_lib

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def meta(*shape):
    return torch.empty(shape, dtype=torch.float32, device="meta")


def ref_flops(fn, *shapes):
    specs = [jax.ShapeDtypeStruct(s, jnp.float32) for s in shapes]
    return ref_hlo_cost.analyze(jax.jit(fn).lower(*specs).compile().as_text()).flops


# ---------------------------------------------------------------------------
# hlo_cost: the three functions of tests/test_distributed.py
# ---------------------------------------------------------------------------

def test_chained_matmuls_flops_equal_the_reference():
    def f(x, w):
        c = x
        for _ in range(24):
            c = torch.tanh(c @ w)
        return c

    def f_ref(x, w):
        return lax.scan(lambda c, _: (jnp.tanh(c @ w), None), x, None,
                        length=24)[0]

    cost = hlo_cost.analyze(f, meta(8, 128), meta(128, 128))
    assert cost.flops == 2 * 8 * 128 * 128 * 24
    assert cost.flops == ref_flops(f_ref, (8, 128), (128, 128))
    assert cost.dot_flops_by_comp == {"mm": cost.flops}
    assert cost.collective_bytes == 0.0


def test_nested_loop_flops_equal_the_reference():
    def g(x, w):
        for _ in range(6):
            for _ in range(4):
                x = x @ w
        return x

    def g_ref(x, w):
        def outer(c, _):
            return lax.scan(lambda ci, _: (ci @ w, None), c, None, length=4)[0], None
        return lax.scan(outer, x, None, length=6)[0]

    cost = hlo_cost.analyze(g, meta(8, 64), meta(64, 64))
    assert cost.flops == 2 * 8 * 64 * 64 * 24
    assert cost.flops == ref_flops(g_ref, (8, 64), (64, 64))


def test_stacked_weights_are_read_once_a_layer():
    layers, d = 16, 256

    def f(x, ws):
        for w in ws:                    # a view of each layer's slice
            x = torch.tanh(x @ w)
        return x

    def f_ref(x, ws):
        return lax.scan(lambda c, w: (jnp.tanh(c @ w), None), x, ws)[0]

    cost = hlo_cost.analyze(f, meta(4, d), meta(layers, d, d))
    stack_bytes = layers * d * d * 4
    assert stack_bytes <= cost.bytes_accessed < 6 * stack_bytes
    assert cost.flops == ref_flops(f_ref, (4, d), (layers, d, d))


def test_products_and_bytes_are_counted_per_op():
    a, b, bias = meta(3, 5), meta(5, 7), meta(7)
    cost = hlo_cost.analyze(lambda: torch.addmm(bias, a, b))
    assert cost.flops == 2 * 3 * 7 * 5
    # operands plus the result, 4 bytes each
    assert cost.bytes_accessed == 4 * (7 + 15 + 35 + 21)
    assert cost.peak_live_bytes == 4 * 21
    views = hlo_cost.analyze(lambda: a.view(15).view(3, 5).t().unsqueeze(0))
    assert views.bytes_accessed == 0 and views.flops == 0
    # a reshape of a transposed tensor copies: read once, written once
    assert hlo_cost.analyze(lambda: a.t().reshape(15)).bytes_accessed == 2 * 4 * 15


def test_live_bytes_drop_when_a_result_is_freed():
    x = meta(1024)

    def f():
        for _ in range(8):
            y = x * 2          # each result freed before the next
            del y

    assert hlo_cost.analyze(f).peak_live_bytes == 4 * 1024


# ---------------------------------------------------------------------------
# hlo_stats: roofline with the H100's data-sheet peaks
# ---------------------------------------------------------------------------

def test_roofline_terms_on_the_h100():
    coll = hlo_stats.CollectiveStats(total_bytes=1e9, by_op={}, counts={})
    t = hlo_stats.roofline({"flops": 989e12, "bytes accessed": 3.35e12}, coll,
                           chips=4, model_flops=989e12 * 4 * 0.5)
    assert t.compute_s == pytest.approx(1.0)
    assert t.memory_s == pytest.approx(1.0)
    assert t.collective_s == pytest.approx(1e9 / 450e9)
    assert t.dominant in ("compute", "memory")
    assert t.useful_flops_ratio == pytest.approx(0.5)
    assert t.roofline_fraction == pytest.approx(0.5)
    none = hlo_stats.no_collectives()
    assert none.total_bytes == 0 and set(none.by_op) == set(hlo_stats.COLLECTIVES)


# ---------------------------------------------------------------------------
# steps.input_specs, dryrun
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,shape", configs.cells())
def test_input_specs_equal_the_references(arch, shape):
    ins = steps.input_specs(configs.get_config(arch), shape)
    ref = ref_steps.input_specs(ref_configs.get_config(arch), shape)
    assert sorted(ins) == sorted(ref)
    for key, t in ins.items():
        assert t.device.type == "meta"
        assert tuple(t.shape) == tuple(ref[key].shape), key
        assert str(t.dtype).split(".")[1] == str(ref[key].dtype), key


def test_cache_input_specs_equal_the_references():
    for arch in ("llama3-8b", "zamba2-1.2b", "rwkv6-3b", "deepseek-v3-671b"):
        got = steps.cache_input_specs(configs.get_smoke_config(arch), 2, 64)
        want = ref_steps.cache_input_specs(ref_configs.get_smoke_config(arch), 2, 64)
        flat = {"/".join(str(p.key) for p in path): leaf
                for path, leaf in jax.tree_util.tree_flatten_with_path(want)[0]}

        def walk(tree, prefix=()):
            for k in sorted(tree):
                if isinstance(tree[k], dict):
                    yield from walk(tree[k], prefix + (k,))
                else:
                    yield "/".join(prefix + (k,)), tree[k]

        ours = dict(walk(got))
        assert sorted(ours) == sorted(flat), arch
        for path, t in ours.items():
            assert tuple(t.shape) == tuple(flat[path].shape), (arch, path)


_REF_SIZES = r"""
import json
from repro import configs
from repro.launch import dryrun
out = {}
for arch, shape in configs.cells():
    cfg = configs.get_config(arch)
    out[f"{arch}|{shape}"] = [*dryrun._param_sizes(cfg),
                              dryrun.model_flops(cfg, shape)]
print(json.dumps(out))
"""


def test_param_sizes_and_model_flops_equal_the_references():
    # the reference's dryrun pins 512 host devices through XLA_FLAGS as its
    # first statement: it runs in a process of its own
    env = {"PYTHONPATH": os.path.join(ROOT, "src"), "PATH": "/usr/bin:/bin",
           "JAX_PLATFORMS": "cpu", "HOME": os.environ.get("HOME", "/tmp")}
    proc = subprocess.run([sys.executable, "-c", _REF_SIZES], capture_output=True,
                          text=True, timeout=300, env=env, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr
    ref = json.loads(proc.stdout.strip().splitlines()[-1])
    assert "XLA_FLAGS" not in os.environ or "512" not in os.environ["XLA_FLAGS"]
    assert sorted(ref) == sorted(f"{a}|{s}" for a, s in configs.cells())
    for key, (total, active, mf) in ref.items():
        arch, shape = key.split("|")
        cfg = configs.get_config(arch)
        assert dryrun._param_sizes(cfg) == (total, active), key
        assert dryrun.model_flops(cfg, shape) == mf, key


REFERENCE_KEYS = {"arch", "shape", "mesh", "chips", "cost_analysis",
                  "memory_analysis", "hlo_cost", "roofline"}
HLO_COST_KEYS = {"flops", "bytes", "collective_bytes", "coll_by_op", "coll_counts"}
ROOFLINE_KEYS = {"compute_s", "memory_s", "collective_s", "dominant",
                 "model_flops", "useful_flops_ratio", "roofline_fraction",
                 "step_time_s"}


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
def test_smoke_cell_writes_the_references_keys(shape, tmp_path):
    cfg = configs.get_smoke_config("llama3-8b")
    rec = dryrun.run_cell("llama3-8b", shape, out_dir=str(tmp_path), cfg=cfg)
    doc = json.loads((tmp_path / f"llama3-8b_{shape}_1.json").read_text())
    assert REFERENCE_KEYS <= set(doc)
    assert set(doc["hlo_cost"]) == HLO_COST_KEYS
    assert set(doc["roofline"]) == ROOFLINE_KEYS
    assert doc["mesh"] == "1" and doc["chips"] == 1
    assert doc["hlo_cost"]["collective_bytes"] == 0.0
    assert doc["cost_analysis"]["flops"] == doc["hlo_cost"]["flops"] > 0
    assert rec["roofline"]["model_flops"] == dryrun.model_flops(cfg, shape)
    # argument bytes are exact: parameters (+ fp32 AdamW moments), inputs,
    # caches
    sh = configs.SHAPES[shape]
    b, s = sh["global_batch"], sh["seq_len"]
    n_params = sum(t.numel() for _, t in
                   _walk(jaxpr_scan.abstract_params(cfg)))
    if shape == "train_4k":
        # + the int32 step counters of the state and of AdamW
        want = 3 * 4 * n_params + 2 * 4 * b * s + 2 * 4
    else:
        caches = steps.cache_input_specs(cfg, b, s)
        tokens = b * (s if shape == "prefill_32k" else 1) * 4
        want = 4 * n_params + tokens + dryrun.tree_bytes(caches)
    assert doc["memory_analysis"]["argument_size_in_bytes"] == want


def test_train_flops_count_the_backward_and_remat():
    # the backward's products are twice the forward's, and flash's backward
    # is its two kernels, as flash_ops counts them; remat recomputes the
    # layers (not the head), stopping once the saved tensors are rebuilt
    cfg = configs.get_smoke_config("llama3-8b")
    tokens = torch.empty((2, 32), dtype=torch.int32, device="meta")
    with torch.no_grad():
        fwd = hlo_cost.analyze(model_lib.forward, jaxpr_scan.abstract_params(cfg),
                               cfg, tokens).dot_flops_by_comp
    head = 2 * 2 * 32 * cfg.d_model * cfg.vocab_size
    flash = {name: cfg.num_layers * f for name, f in flash_ops(
        2 * cfg.num_heads, 32, 32, cfg.resolved_head_dim, causal=True).items()}

    def products(flops):
        return sum(f for op, f in flops.items() if op in hlo_cost.PRODUCTS)

    assert fwd["flash_fwd"] == flash["flash_fwd"] and "flash_bwd_dq" not in fwd
    plain = dryrun.trace_step(cfg.replace(remat=False), "train", 2, 32)["cost"]
    assert products(plain.dot_flops_by_comp) == 3 * products(fwd)
    assert {op: f for op, f in plain.dot_flops_by_comp.items()
            if op.startswith("flash")} == flash
    assert plain.flops == 3 * products(fwd) + sum(flash.values())
    remat = dryrun.trace_step(cfg.replace(remat=True), "train", 2, 32)["cost"]
    assert 3 * products(fwd) < products(remat.dot_flops_by_comp) \
        <= 4 * products(fwd) - head
    assert (flash["flash_fwd"] < remat.dot_flops_by_comp["flash_fwd"]
            <= 2 * flash["flash_fwd"])


def test_meta_attention_is_one_operation_per_flash_kernel():
    # on meta the model's attention takes the flash wrappers, as on the
    # card: one operation a kernel, its operands read once and its outputs
    # written once, no (S x S) score tile among the results
    bh, s, d = 8, 512, 64
    q, k, v = meta(bh, s, d), meta(bh, s, d), meta(bh, s, d)
    cost = hlo_cost.analyze(flash_lib.flash_fwd, q, k, v, causal=True)
    assert cost.ops == 1
    assert cost.flops == flash_ops(bh, s, s, d, causal=True)["flash_fwd"]
    assert cost.bytes_accessed == 4 * (4 * bh * s * d + bh * s)
    assert cost.top_bytes[0][2] == "flash_fwd"
    b, h, s = 2, 4, 2048
    x = torch.empty((b, s, h, d), device="meta", requires_grad=True)
    counter = hlo_cost.CostCounter()
    with counter:
        out = flash_lib.flash_attention(x, x, x, causal=True)
        torch.autograd.grad(out.sum(), x)
    ops = {op for op, _ in counter.contrib}
    assert {"flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"} <= ops
    assert not ops & {"bmm", "mm", "baddbmm"}
    # a few (B, S, H, D) slabs live at once, not the fp32 (B, H, S, S) scores
    assert counter.peak <= 8 * b * s * h * d * 4 < b * h * s * s * 4


def test_multi_pod_is_refused_naming_item_6():
    with pytest.raises(NotImplementedError, match="512 positions"):
        dryrun.run_cell("llama3-8b", "decode_32k", multi_pod=True, out_dir=None)


def test_cli_writes_a_cell(tmp_path, capsys):
    rc = dryrun.main(["--arch", "zamba2-1.2b", "--shape", "long_500k",
                      "--out", str(tmp_path)])
    assert rc == 0
    assert "OK   zamba2-1.2b x long_500k x 1" in capsys.readouterr().out
    assert (tmp_path / "zamba2-1.2b_long_500k_1.json").exists()
    assert dryrun.main(["--arch", "llama3-8b", "--shape", "long_500k",
                        "--out", str(tmp_path)]) == 0      # skipped
    assert "SKIP" in capsys.readouterr().out


def test_dryrun_decode_matches_a_real_decode_step_on_the_cpu():
    # the meta trace runs the same code as a real step: same output shapes
    cfg = configs.get_smoke_config("llama3-8b").replace(compute_dtype="float32")
    gen = torch.Generator().manual_seed(0)
    params = model_lib.init_params(cfg, gen, device="cpu")
    caches = model_lib.init_caches(cfg, 2, 16, dtype=torch.bfloat16, device="cpu")
    tokens = torch.zeros((2, 1), dtype=torch.int32)
    logits, _ = model_lib.decode_step(params, cfg, tokens, caches=caches,
                                      cache_pos=15)
    traced = dryrun.trace_step(cfg, "decode", 2, 16)
    assert traced["output_bytes"] == (logits.numel() * logits.element_size()
                                      + dryrun.tree_bytes(caches))
    assert np.isfinite(traced["cost"].flops) and traced["cost"].flops > 0
