"""The port's GPipe schedule (``repro_torch.launch.pipeline``) on the CPU,
held to the reference's: ``split_stages`` bit for bit, the forward and its
gradient against the reference's sequential model on
``tests/test_pipeline.py``'s fixture, the forward against the reference's
own ``pipeline_apply`` on 4 fake devices (its gradient raises under jax
0.9.0), and a transformer stack through the pipeline against
``stack_fwd``."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch.pipeline import split_stages as ref_split_stages
from repro_torch import configs
from repro_torch.launch.mesh import Mesh, make_pipeline_mesh
from repro_torch.launch.pipeline import (bubble_fraction, pipeline_apply,
                                         split_stages)
from repro_torch.models import blocks
from repro_torch.models import model as model_lib

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
L, D, MB, M, P = 8, 16, 4, 6, 4      # tests/test_pipeline.py's fixture


def fixture_arrays():
    rng = np.random.default_rng(0)
    ws = rng.normal(0, 0.3, (L, D, D)).astype(np.float32)
    bs = rng.normal(0, 0.1, (L, D)).astype(np.float32)
    x = rng.normal(0, 1, (M, MB, D)).astype(np.float32)
    return ws, bs, x


def stage_fn(stage_params, h):
    sw, sb = stage_params
    for i in range(sw.shape[0]):
        h = torch.tanh(h @ sw[i] + sb[i])
    return h


def ref_sequential(params, x):
    ws, bs = params
    h = x.reshape(M * MB, D)
    for i in range(L):
        h = jnp.tanh(h @ ws[i] + bs[i])
    return h.reshape(M, MB, D)


def port_pipeline(ws, bs, x):
    staged = split_stages((ws, bs), P)
    return pipeline_apply(stage_fn, staged, x, make_pipeline_mesh(P, "cpu"))


def test_split_stages_equals_the_reference_bit_for_bit():
    ws, bs, _ = fixture_arrays()
    got = split_stages((torch.from_numpy(ws), torch.from_numpy(bs)), P)
    want = ref_split_stages((jnp.asarray(ws), jnp.asarray(bs)), P)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert np.array_equal(g.numpy(), np.asarray(w))
    with pytest.raises(ValueError, match="not divisible"):
        split_stages({"w": torch.zeros(6, 2)}, 4)


def test_forward_and_gradient_equal_the_reference_sequential_model():
    ws, bs, x = fixture_arrays()
    tw, tb = (torch.from_numpy(a).requires_grad_(True) for a in (ws, bs))
    out = port_pipeline(tw, tb, torch.from_numpy(x))
    ref_out = ref_sequential((jnp.asarray(ws), jnp.asarray(bs)), jnp.asarray(x))
    assert float(np.max(np.abs(out.detach().numpy() - np.asarray(ref_out)))) < 1e-5
    grads = torch.autograd.grad(torch.sum(out ** 2), (tw, tb))
    ref_grads = jax.grad(lambda p: jnp.sum(ref_sequential(p, jnp.asarray(x)) ** 2))(
        (jnp.asarray(ws), jnp.asarray(bs)))
    for g, r in zip(grads, ref_grads):
        assert float(np.max(np.abs(g.numpy() - np.asarray(r)))) < 1e-4


_REF_PIPELINE = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp
import numpy as np
from repro.launch.mesh import make_mesh
from repro.launch.pipeline import pipeline_apply, split_stages

rng = np.random.default_rng(0)
L, D, MB, M = 8, 16, 4, 6
ws = jnp.asarray(rng.normal(0, 0.3, (L, D, D)), jnp.float32)
bs = jnp.asarray(rng.normal(0, 0.1, (L, D)), jnp.float32)
x = jnp.asarray(rng.normal(0, 1, (M, MB, D)), jnp.float32)

def stage_fn(stage_params, h):
    sw, sb = stage_params
    for i in range(sw.shape[0]):
        h = jnp.tanh(h @ sw[i] + sb[i])
    return h

mesh = make_mesh((4,), ("pod",))
with mesh:
    out = pipeline_apply(stage_fn, split_stages((ws, bs), 4), x, mesh)
np.save(sys.argv[1], np.asarray(out))
"""


def test_forward_equals_the_reference_pipeline_on_four_devices(tmp_path):
    # the device count must be pinned before jax initializes: a process of
    # its own, as tests/test_pipeline.py runs it; the forward only, since
    # the reference's gradient raises under jax 0.9.0
    env = {"PYTHONPATH": os.path.join(ROOT, "src"), "PATH": "/usr/bin:/bin",
           "HOME": os.environ.get("HOME", "/tmp"), "JAX_PLATFORMS": "cpu",
           "JAX_DISABLE_MOST_OPTIMIZATIONS": "1"}
    path = tmp_path / "ref_out.npy"
    proc = subprocess.run([sys.executable, "-c", _REF_PIPELINE, str(path)],
                          capture_output=True, text=True, timeout=600, env=env)
    assert proc.returncode == 0, proc.stderr[-2000:]
    ws, bs, x = fixture_arrays()
    with torch.no_grad():
        out = port_pipeline(*(torch.from_numpy(a) for a in (ws, bs, x)))
    assert float(np.max(np.abs(out.numpy() - np.load(path)))) < 1e-5


def test_schedule_calls_each_stage_once_a_microbatch():
    calls = []

    def counting(stage_params, h):
        calls.append(int(stage_params[0]))
        return h + 1

    staged = (torch.arange(P), )
    x = torch.zeros(M, 1)
    out = pipeline_apply(counting, staged, x, make_pipeline_mesh(P, "cpu"))
    assert torch.equal(out, torch.full((M, 1), float(P)))
    assert sorted(calls) == sorted(list(range(P)) * M)
    assert bubble_fraction(P, M) == pytest.approx((P - 1) / (M + P - 1))


def test_stages_on_several_devices_raise_naming_item_6():
    mesh = Mesh((2,), ("pod",), (torch.device("cpu"), torch.device("meta")))
    with pytest.raises(NotImplementedError, match="item 6"):
        pipeline_apply(stage_fn, (torch.zeros(2, 1, D, D), torch.zeros(2, 1, D)),
                       torch.zeros(2, MB, D), mesh)


def test_transformer_stack_through_the_pipeline_equals_stack_fwd():
    # llama3-8b's smoke widths, 4 layers in 2 stages of 2, 3 microbatches
    # of 2 x 16, fp32: the per-microbatch run is the same arithmetic, the
    # whole-batch stack_fwd the same up to summation order
    cfg = configs.get_smoke_config("llama3-8b").replace(
        num_layers=4, compute_dtype="float32", remat=False)
    gen = torch.Generator().manual_seed(0)
    params = model_lib.init_params(cfg, gen, device="cpu")
    layers = {"layers": params["layers"]}
    n_stages, n_micro, mb, seq = 2, 3, 2, 16
    stage_cfg = cfg.replace(num_layers=cfg.num_layers // n_stages)
    positions = torch.arange(seq)[None, :]
    x = torch.randn((n_micro, mb, seq, cfg.d_model), generator=gen)

    def stage(stage_params, h):
        return blocks.stack_fwd({"layers": stage_params}, h, stage_cfg,
                                positions=positions)[0]

    def walk(tree, prefix=""):
        for k in sorted(tree):
            if isinstance(tree[k], dict):
                yield from walk(tree[k], f"{prefix}{k}/")
            else:
                yield f"{prefix}{k}", tree[k]

    flat = dict(walk(layers["layers"]))
    for v in flat.values():
        v.requires_grad_(True)
    out = pipeline_apply(stage, split_stages(layers["layers"], n_stages), x,
                         make_pipeline_mesh(n_stages, "cpu"))
    with torch.no_grad():
        per_micro = torch.stack([blocks.stack_fwd(layers, x[i], cfg,
                                                  positions=positions)[0]
                                 for i in range(n_micro)])
    assert torch.equal(out.detach(), per_micro)
    whole = blocks.stack_fwd(layers, x.reshape(n_micro * mb, seq, -1), cfg,
                             positions=positions)[0].reshape(out.shape)
    scale = float(whole.detach().abs().max())
    assert float((out - whole).abs().max()) <= 1e-5 * scale
    names = sorted(flat)
    got = torch.autograd.grad(torch.sum(out ** 2), [flat[n] for n in names])
    want = torch.autograd.grad(torch.sum(whole ** 2), [flat[n] for n in names])
    for n, g, w in zip(names, got, want):
        assert float((g - w).abs().max()) <= 1e-4 * float(w.abs().max()), n
