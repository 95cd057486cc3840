"""The port's GPipe pipeline across ranks (``launch/pipeline.py`` on a
``torch.distributed`` mesh with a ``pod`` axis) on 4 ``gloo`` ranks,
against the reference's ``pipeline_apply`` on 4 fake XLA devices and
against the port's one-device pipeline.

One module-scoped spawn of 4 ranks (``gloo``, a ``file://`` store, a
per-rank timeout) runs every port-side case and writes each rank's
outputs; one subprocess runs the reference (``XLA_FLAGS`` pins the device
count before jax starts): its 4-device pipeline forward and, since its
pipeline gradient raises under jax 0.9.0, the gradient of its sequential
model; the main process computes the one-device counterparts.  Cases:

* ``tests/test_pipeline.py``'s fixture (``L, D, MB = 8, 16, 4``) on a
  ``("pod",)`` x 4 mesh at ``M`` = 6, 3 (fewer microbatches than stages)
  and 5: the forward on every rank within 1e-5 of the reference's and
  equal to the one-device port; every weight gradient, gathered over
  ``pod``, within 1e-4 of the reference's sequential gradient and within
  1e-5 x max|g| of the one-device port; ``dL/dx`` identical on every rank;
* a ``("pod", "data")`` 2 x 2 mesh, each data line on its own ``x``: its
  output and gradients against the one-device 2-stage pipeline;
* llama3-8b's smoke widths, fp32, remat, 4 layers in 4 stages through
  ``stack_fwd``, each rank fed only its own stage (leaves of leading
  dimension 1): against the one-device pipeline;
* the ``collective-permute`` counter of one forward and backward against a
  hand count, with every other collective's counts stated;
* a mesh of the wrong size and a staged leaf of the wrong leading
  dimension raise.

The ranks import no jax: this module imports none.
"""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

ROOT = Path(__file__).resolve().parents[1]
WORLD = 4
L, D, MB = 8, 16, 4                 # tests/test_pipeline.py's fixture
MICRO = (6, 3, 5)
LINES = 2                           # the ("pod", "data") 2 x 2 case
SMOKE = dict(layers=4, micro=3, mb=2, seq=16)
RANK_TIMEOUT_S = 240


def fixture_arrays():
    rng = np.random.default_rng(0)
    ws = rng.normal(0, 0.3, (L, D, D)).astype(np.float32)
    bs = rng.normal(0, 0.1, (L, D)).astype(np.float32)
    x = rng.normal(0, 1, (max(MICRO), MB, D)).astype(np.float32)
    x_lines = rng.normal(0, 1, (LINES, max(MICRO), MB, D)).astype(np.float32)
    return ws, bs, x, x_lines


def stage_fn(stage_params, h):
    sw, sb = stage_params
    for i in range(sw.shape[0]):
        h = torch.tanh(h @ sw[i] + sb[i])
    return h


def _smoke_cfg():
    from repro_torch import configs
    return configs.get_smoke_config("llama3-8b").replace(
        num_layers=SMOKE["layers"], compute_dtype="float32", remat=True)


def _smoke_inputs():
    """Layers and microbatches of the smoke case, drawn alike on every
    rank and in this process."""
    from repro_torch.models import model as model_lib
    cfg = _smoke_cfg()
    gen = torch.Generator().manual_seed(0)
    layers = model_lib.init_params(cfg, gen, device="cpu")["layers"]
    x = torch.randn((SMOKE["micro"], SMOKE["mb"], SMOKE["seq"], cfg.d_model),
                    generator=gen)
    return cfg, layers, x


def _leaves(tree, prefix=""):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _leaves(tree[k], f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", tree[k]


def _smoke_run(cfg, staged, x, mesh):
    """``stack_fwd`` stages through ``pipeline_apply``; the output and the
    gradient of sum(out**2) for every staged leaf."""
    from repro_torch.launch.pipeline import pipeline_apply
    from repro_torch.models import blocks
    stage_cfg = cfg.replace(num_layers=SMOKE["layers"] // mesh.shape[0])
    positions = torch.arange(SMOKE["seq"])[None, :]

    def stage(stage_params, h):
        return blocks.stack_fwd({"layers": stage_params}, h, stage_cfg,
                                positions=positions)[0]

    flat = dict(_leaves(staged))
    for leaf in flat.values():
        leaf.requires_grad_(True)
    out = pipeline_apply(stage, staged, x, mesh)
    grads = torch.autograd.grad(torch.sum(out ** 2), list(flat.values()))
    return out.detach(), dict(zip(flat, grads))


def _fixture_run(ws, bs, x, mesh, n_stages):
    """The fixture through ``pipeline_apply``: the output, the gradients of
    sum(out**2) for the stacked weights and biases, and for ``x``."""
    from repro_torch.launch.pipeline import pipeline_apply, split_stages
    tw, tb, tx = (torch.from_numpy(a).requires_grad_(True) for a in (ws, bs, x))
    out = pipeline_apply(stage_fn, split_stages((tw, tb), n_stages), tx, mesh)
    gw, gb, gx = torch.autograd.grad(torch.sum(out ** 2), (tw, tb, tx))
    return out.detach().numpy(), gw.numpy(), gb.numpy(), gx.numpy()


def _counts() -> dict:
    from repro_torch.launch import collectives as coll
    return {k: (coll.BYTES[k], coll.SENT[k], coll.CALLS[k]) for k in coll.BYTES}


# ---------------------------------------------------------------------------
# the ranks
# ---------------------------------------------------------------------------

def _rank_main(rank: int, init_file: str, work: str) -> None:
    import torch.distributed as dist
    from repro_torch.launch import collectives as coll
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch.pipeline import pipeline_apply, split_stages
    torch.set_num_threads(1)
    mesh_lib.init_distributed("cpu", init_method=f"file://{init_file}",
                              rank_=rank, world=WORLD, timeout_s=120)
    ws, bs, x, x_lines = fixture_arrays()
    out: dict = {}
    mesh = mesh_lib.make_pipeline_mesh(WORLD, "cpu")
    out["mesh"] = np.array([mesh.distributed, mesh.axis_index("pod"),
                            mesh.shape == (WORLD,)])
    for m in MICRO:
        coll.reset()
        (out[f"out/{m}"], out[f"gw/{m}"], out[f"gb/{m}"],
         out[f"gx/{m}"]) = _fixture_run(ws, bs, x[:m], mesh, WORLD)
        out[f"counts/{m}"] = np.array([_counts()[k] for k in sorted(coll.BYTES)])
    # ("pod", "data"): data line d runs the 2-stage pipeline on x_lines[d]
    grid = mesh_lib.make_mesh((2, LINES), ("pod", "data"), "cpu")
    line = grid.axis_index("data")
    (out["lines/out"], out["lines/gw"], out["lines/gb"],
     out["lines/gx"]) = _fixture_run(ws, bs, x_lines[line], grid, 2)
    out["lines/line"] = np.array(line)
    # smoke widths, each rank fed its own stage only
    cfg, layers, sx = _smoke_inputs()
    own = pytree.tree_map(lambda v: v[rank:rank + 1].clone(),
                          split_stages(layers, WORLD))
    smoke_out, smoke_grads = _smoke_run(cfg, own, sx, mesh)
    out["smoke/out"] = smoke_out.numpy()
    for k, g in smoke_grads.items():
        out[f"smoke/grad/{k}"] = g[0].numpy()
    # refusals, on every rank alike
    try:
        mesh_lib.make_pipeline_mesh(WORLD - 1, "cpu")
        out["refuse/size"] = np.array("")
    except ValueError as exc:
        out["refuse/size"] = np.array(str(exc))
    try:
        pipeline_apply(stage_fn, (torch.zeros(2, 2, D, D), torch.zeros(2, 2, D)),
                       torch.zeros(1, MB, D), mesh)
        out["refuse/leaf"] = np.array("")
    except ValueError as exc:
        out["refuse/leaf"] = np.array(str(exc))
    dist.destroy_process_group()
    np.savez(os.path.join(work, f"rank{rank}.npz"), **out)


# ---------------------------------------------------------------------------
# the reference's side, in its own process (4 fake XLA devices)
# ---------------------------------------------------------------------------

REF_SCRIPT = r"""
import os, sys
import numpy as np
import jax, jax.numpy as jnp
from repro.launch.mesh import make_mesh
from repro.launch.pipeline import pipeline_apply, split_stages
work, = sys.argv[1:]
inp = dict(np.load(os.path.join(work, "inputs.npz")))
ws, bs = jnp.asarray(inp["ws"]), jnp.asarray(inp["bs"])

def stage_fn(stage_params, h):
    sw, sb = stage_params
    for i in range(sw.shape[0]):
        h = jnp.tanh(h @ sw[i] + sb[i])
    return h

def sequential(params, x):
    w, b = params
    h = x.reshape(-1, x.shape[-1])
    for i in range(w.shape[0]):
        h = jnp.tanh(h @ w[i] + b[i])
    return h.reshape(x.shape)

mesh = make_mesh((4,), ("pod",))
out = {}
for m in [int(v) for v in inp["micro"]]:
    x = jnp.asarray(inp["x"][:m])
    with mesh:
        out[f"out/{m}"] = np.asarray(
            pipeline_apply(stage_fn, split_stages((ws, bs), 4), x, mesh))
    (gw, gb), gx = jax.grad(lambda p, x: jnp.sum(sequential(p, x) ** 2),
                            argnums=(0, 1))((ws, bs), x)
    out[f"gw/{m}"], out[f"gb/{m}"], out[f"gx/{m}"] = map(np.asarray, (gw, gb, gx))
np.savez(os.path.join(work, "ref.npz"), **out)
print("REF_DONE")
"""


def _one_device() -> dict:
    """The port's one-device pipeline on every case's inputs."""
    from repro_torch.launch.mesh import make_pipeline_mesh
    from repro_torch.launch.pipeline import split_stages
    ws, bs, x, x_lines = fixture_arrays()
    one: dict = {}
    for m in MICRO:
        (one[f"out/{m}"], one[f"gw/{m}"], one[f"gb/{m}"],
         one[f"gx/{m}"]) = _fixture_run(ws, bs, x[:m],
                                        make_pipeline_mesh(WORLD, "cpu"), WORLD)
    for d in range(LINES):
        (one[f"lines/out/{d}"], one[f"lines/gw/{d}"], one[f"lines/gb/{d}"],
         one[f"lines/gx/{d}"]) = _fixture_run(ws, bs, x_lines[d],
                                              make_pipeline_mesh(2, "cpu"), 2)
    cfg, layers, sx = _smoke_inputs()
    out, grads = _smoke_run(cfg, split_stages(layers, WORLD), sx,
                            make_pipeline_mesh(WORLD, "cpu"))
    one["smoke/out"] = out.numpy()
    for k, g in grads.items():
        one[f"smoke/grad/{k}"] = g.numpy()
    return one


@pytest.fixture(scope="module")
def pipe_run():
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory() as work:
        ws, bs, x, _ = fixture_arrays()
        np.savez(os.path.join(work, "inputs.npz"), ws=ws, bs=bs, x=x,
                 micro=np.array(MICRO))
        env = dict(os.environ, JAX_PLATFORMS="cpu",
                   XLA_FLAGS="--xla_force_host_platform_device_count=4",
                   PYTHONPATH=os.pathsep.join(
                       [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]))
        ref = subprocess.Popen([sys.executable, "-c", REF_SCRIPT, work],
                               env=env, cwd=str(ROOT),
                               stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                               text=True)
        try:
            ctx = mp.start_processes(
                _rank_main, args=(os.path.join(work, "store"), work),
                nprocs=WORLD, join=False, start_method="spawn")
            try:
                # join returns False each time one rank of several ends
                deadline = time.monotonic() + RANK_TIMEOUT_S
                while not ctx.join(timeout=max(1.0, deadline
                                               - time.monotonic())):
                    if time.monotonic() > deadline:
                        raise TimeoutError(f"the {WORLD} ranks ran past "
                                           f"{RANK_TIMEOUT_S} s")
            finally:
                for p in ctx.processes:
                    if p.is_alive():
                        p.kill()
            one = _one_device()
            stdout, stderr = ref.communicate(timeout=RANK_TIMEOUT_S)
        finally:
            if ref.poll() is None:
                ref.kill()
        assert ref.returncode == 0 and "REF_DONE" in stdout, stderr[-3000:]
        ranks = [dict(np.load(os.path.join(work, f"rank{r}.npz")))
                 for r in range(WORLD)]
        refs = dict(np.load(os.path.join(work, "ref.npz")))
        yield {"ranks": ranks, "ref": refs, "one": one}


def _max_abs(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a) - np.asarray(b))))


def _gathered(run, key: str, n_stages: int = WORLD, ranks=None) -> np.ndarray:
    """A stacked leaf's gradient, gathered over ``pod``: stage p's layers
    from the rank at position p; every other stage's block of that rank's
    gradient is zero."""
    per = L // n_stages
    ranks = ranks or run["ranks"]
    blocks = []
    for p, res in enumerate(ranks):
        g = res[key]
        others = np.delete(g, np.s_[p * per:(p + 1) * per], axis=0)
        assert not others.any(), f"{key}: position {p} has gradient outside " \
                                 f"its stage"
        blocks.append(g[p * per:(p + 1) * per])
    return np.concatenate(blocks)


def test_make_pipeline_mesh_puts_one_rank_a_stage(pipe_run):
    for r, res in enumerate(pipe_run["ranks"]):
        assert res["mesh"].tolist() == [True, r, True]


@pytest.mark.parametrize("m", MICRO)
def test_forward_equals_the_reference_on_four_devices_and_one_device(pipe_run, m):
    ref, one = pipe_run["ref"][f"out/{m}"], pipe_run["one"][f"out/{m}"]
    for r, res in enumerate(pipe_run["ranks"]):
        got = res[f"out/{m}"]
        assert got.shape == ref.shape == (m, MB, D)
        assert _max_abs(got, ref) < 1e-5, f"rank {r}"
        assert np.array_equal(got, one), f"rank {r}"


@pytest.mark.parametrize("m", MICRO)
def test_gradients_equal_the_reference_and_one_device(pipe_run, m):
    ref, one = pipe_run["ref"], pipe_run["one"]
    for name in ("gw", "gb"):
        got = _gathered(pipe_run, f"{name}/{m}")
        assert _max_abs(got, ref[f"{name}/{m}"]) < 1e-4, name
        scale = float(np.abs(one[f"{name}/{m}"]).max())
        assert _max_abs(got, one[f"{name}/{m}"]) <= 1e-5 * scale, name
    gx = pipe_run["ranks"][0][f"gx/{m}"]
    for r, res in enumerate(pipe_run["ranks"][1:], 1):
        assert np.array_equal(res[f"gx/{m}"], gx), f"dL/dx differs on rank {r}"
    assert _max_abs(gx, ref[f"gx/{m}"]) < 1e-4
    assert _max_abs(gx, one[f"gx/{m}"]) <= 1e-5 * float(np.abs(gx).max())


def test_each_data_line_runs_its_own_pipeline(pipe_run):
    ranks, one = pipe_run["ranks"], pipe_run["one"]
    # ("pod", "data") 2 x 2, row-major: rank = 2 * pod + data
    for d in range(LINES):
        line = [ranks[d], ranks[LINES + d]]
        for pos, res in enumerate(line):
            assert int(res["lines/line"]) == d
            assert np.array_equal(res["lines/out"], one[f"lines/out/{d}"]), \
                f"line {d}, pod {pos}"
            assert np.array_equal(res["lines/gx"], one[f"lines/gx/{d}"])
        for name in ("gw", "gb"):
            got = _gathered(pipe_run, f"lines/{name}", 2, line)
            want = one[f"lines/{name}/{d}"]
            assert _max_abs(got, want) <= 1e-5 * float(np.abs(want).max()), name
    assert not np.array_equal(one["lines/out/0"], one["lines/out/1"])


def test_transformer_stack_on_own_stage_leaves_equals_one_device(pipe_run):
    one = pipe_run["one"]
    names = sorted(k[len("smoke/grad/"):] for k in one
                   if k.startswith("smoke/grad/"))
    assert names
    for r, res in enumerate(pipe_run["ranks"]):
        assert np.array_equal(res["smoke/out"], one["smoke/out"]), f"rank {r}"
        for n in names:
            want = one[f"smoke/grad/{n}"][r]
            got = res[f"smoke/grad/{n}"]
            assert got.shape == want.shape
            assert _max_abs(got, want) <= 1e-5 * float(np.abs(want).max()), \
                f"rank {r} {n}"


def test_permute_counter_equals_a_hand_count(pipe_run):
    from repro_torch.launch.collectives import BYTES
    kinds = sorted(BYTES)
    act = MB * D * 4                       # one microbatch's activation, fp32
    for m in MICRO:
        hand_offs = m + WORLD - 2          # T - 1 ticks hand on
        out_bytes = m * MB * D * 4         # the (M, MB, D) output, and dL/dx
        for r, res in enumerate(pipe_run["ranks"]):
            # forward: positions 0..P-2 send; backward: positions 1..P-1
            sends = hand_offs * ((r < WORLD - 1) + (r > 0))
            want = {k: (0, 0.0, 0) for k in kinds}
            want["collective-permute"] = (sends * act, float(sends * act), sends)
            # reduce_from of the output, copy_to's backward of dL/dx
            want["all-reduce"] = (2 * out_bytes,
                                  2 * out_bytes * 2 * (WORLD - 1) / WORLD, 2)
            got = {k: tuple(v) for k, v in zip(kinds, res[f"counts/{m}"].tolist())}
            assert got == want, f"M {m}, rank {r}"


def test_a_wrong_size_or_leaf_raises_on_every_rank(pipe_run):
    for res in pipe_run["ranks"]:
        assert "one rank per position" in str(res["refuse/size"])
        assert "leading dimension 2" in str(res["refuse/leaf"])
