"""Training on a 4-rank ``gloo`` mesh, against the reference's sharded train
step on 4 fake XLA devices.

One module-scoped run: a subprocess runs the reference (``XLA_FLAGS`` pins
4 host devices before jax starts; meshes have ``AxisType.Auto`` axes).  It
first writes its initial parameters and a checkpoint of its own, then jits
``make_train_step`` with its shardings for every case while 4 spawned ranks
(``torch.distributed`` over ``gloo``, a ``file://`` store, no card) run the
port's side; this process runs the port's one-process counterparts.  The
cases are separate tests:

* the sharded train step (smoke widths, float32 compute, batch 4 x 16,
  AdamW lr 1e-3, ``compress_grads`` off and on) for llama3-8b on 2 x 2 and
  1 x 4 ``("data", "model")`` meshes, rwkv6-3b on 2 x 2 (``dp_over_model``:
  its batch splits over data x model, FSDP over ``data``) and
  deepseek-v3-671b on 1 x 4 (MLA, expert-parallel MoE): step-1 loss within
  1e-6 relative and every gathered gradient leaf within 1e-5 x max|leaf| of
  the reference's; the losses of 3 steps within 1e-5 relative of the
  reference's and of the port's one-process step (rwkv6-3b: looser bounds,
  measured, see ``GRAD_TOL``);
* zamba2-1.2b, gemma-7b, phi3.5-moe and musicgen-medium on a mesh against
  the port's one-process step (3 losses within 1e-5 relative);
* ``param_pspecs`` equal to the reference's, leaf for leaf, for the ten
  configs, both phases, on 2 x 2 and 1 x 4;
* ``int8_psum`` over ``data`` bit-identical to the reference's, and its
  bytes on the collective counter equal to a hand count; one row-parallel
  MLP's bytes likewise;
* serving (``make_prefill_step`` / ``make_decode_step``) on a ``("pod",
  "data", "model")`` 2 x 1 x 2 mesh with inference-sharded weights within
  ``MESH_TOL`` of one process's replicated prefill and decode;
* a sharded checkpoint round-trips on 2 x 2, a reference checkpoint
  resumes there, and the CLI trains on a 2 x 2 mesh.

The deepseek case runs on 1 x 4: on a mesh that splits the batch over
``data`` the reference's expert-parallel shard_map returns one data
shard's aux loss (``out_specs=P()``), where the port takes the whole
batch's (ROADMAP, "Reference caveats").  The ranks import no jax: this
module imports none at the top.
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

ROOT = Path(__file__).resolve().parents[1]
WORLD = 4
CASES = (("llama3-8b", (2, 2)), ("llama3-8b", (1, 4)), ("rwkv6-3b", (2, 2)),
         ("deepseek-v3-671b", (1, 4)))
ARCHS = ("llama3-8b", "rwkv6-3b", "deepseek-v3-671b")
#: the other families, held against the port's own one-process step only:
#: the hybrid (its Mamba2 slices gathered, the shared block head-parallel),
#: tied embeddings, MoE with a shared expert, a frontend stub fed
#: embeddings under dp_over_model
OTHERS = (("zamba2-1.2b", (2, 2)), ("gemma-7b", (1, 4)),
          ("phi3.5-moe-42b-a6.6b", (1, 4)), ("musicgen-medium", (2, 2)))
#: expert parallelism on a mesh that also splits the batch over data: the
#: psum and a2a dispatches on 2 x 2 with the capacity lifted (no token
#: dropped), against the port's one-process step
MOE_ARCH, MOE_IMPLS = "phi3.5-moe-42b-a6.6b", ("psum", "a2a")
BATCH, SEQ, STEPS, LR = 4, 16, 3, 1e-3
LOSS1_TOL = 1e-6
#: x max|leaf| and relative; rwkv6-3b's are looser, as measured: its
#: gradient at init runs through the group norm's eps of 1e-5 and turns on
#: rounding (ROADMAP "Reference caveats").  On one process the port's
#: gradient already sits 4.9e-6 x max|leaf| from the reference's (w_o); on
#: the 2 x 2 mesh 5.3e-6 to 1.1e-5 (mu_k, gn_b; the reference's XLA sums
#: vary between runs), and with int8 compression a gradient on a rounding
#: boundary flips a code: the three losses 2.0e-5 relative
GRAD_TOL = {"rwkv6-3b": 3e-5}
LOSSES_TOL = {"rwkv6-3b": 1e-4}
DEFAULT_TOL = 1e-5
MESH_TOL = 1e-5                       # x max|one process|, fp32
SERVE_BATCH, SERVE_PROMPT, SERVE_MAX_LEN, SERVE_DECODES = 4, 8, 32, 3
RANK_TIMEOUT_S = 300


def _case_id(arch, shape, compress) -> str:
    return f"{arch}/{shape[0]}x{shape[1]}/{'ef' if compress else 'plain'}"


def _all_cases():
    return [(a, s, c) for a, s in CASES for c in (False, True)]


def _cfg(arch: str):
    from repro_torch import configs
    return configs.get_smoke_config(arch).replace(compute_dtype="float32")


def _moe_cfg(impl: str):
    import dataclasses
    cfg = _cfg(MOE_ARCH)
    return cfg.replace(moe=dataclasses.replace(
        cfg.moe, ep_impl=impl, capacity_factor=float(cfg.moe.num_experts)))


def _flatten(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flatten(tree[k], f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def _unflatten(flat: dict, prefix: str) -> dict:
    tree: dict = {}
    for key, val in flat.items():
        if not key.startswith(prefix):
            continue
        node = tree
        *path, leaf = key[len(prefix):].split("/")
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = val
    return tree


def _make_inputs(path: Path) -> dict:
    rng = np.random.default_rng(0)
    x = {}
    for arch in ARCHS:
        v = _cfg(arch).vocab_size
        x[f"batch/{arch}/tokens"] = rng.integers(0, v, (STEPS, BATCH, SEQ)
                                                 ).astype(np.int32)
        x[f"batch/{arch}/targets"] = rng.integers(0, v, (STEPS, BATCH, SEQ)
                                                  ).astype(np.int32)
    for arch, _ in OTHERS:
        cfg = _cfg(arch)
        if cfg.frontend_stub:
            x[f"batch/{arch}/embeds"] = rng.normal(
                0, 1, (STEPS, BATCH, SEQ, cfg.d_model)).astype(np.float32)
        else:
            x[f"batch/{arch}/tokens"] = rng.integers(
                0, cfg.vocab_size, (STEPS, BATCH, SEQ)).astype(np.int32)
        x[f"batch/{arch}/targets"] = rng.integers(
            0, cfg.vocab_size, (STEPS, BATCH, SEQ)).astype(np.int32)
    x[f"batch/{MOE_ARCH}/tokens"] = rng.integers(
        0, _cfg(MOE_ARCH).vocab_size, (STEPS, BATCH, SEQ)).astype(np.int32)
    x["psum/a"] = rng.normal(0, 1, (6, 5)).astype(np.float32)
    x["psum/b"] = (rng.normal(0, 1e-3, (7,)) * np.arange(7)).astype(np.float32)
    x["psum/ones"] = np.ones((3, 4), np.float32)
    x["mlp/x"] = rng.normal(0, 1, (2, 5, 64)).astype(np.float32)
    x["serve/prompt"] = rng.integers(0, 512, (SERVE_BATCH, SERVE_PROMPT)
                                     ).astype(np.int32)
    x["serve/tokens"] = rng.integers(0, 512, (SERVE_DECODES, SERVE_BATCH, 1)
                                     ).astype(np.int32)
    np.savez(path, **x)
    return x


# ---------------------------------------------------------------------------
# the port's side, on every rank (no jax)
# ---------------------------------------------------------------------------

def _t(x, dtype=None):
    t = torch.from_numpy(np.array(x))
    return t if dtype is None else t.to(dtype)


def _batch(x, arch, i):
    return {k: _t(x[f"batch/{arch}/{k}"][i]) for k in
            ("tokens", "embeds", "targets") if f"batch/{arch}/{k}" in x}


def _own_losses(x, arch, mesh=None, cfg=None):
    """The port's own state from seed 0 (the mesh's slices of it), three
    steps."""
    from repro_torch.launch import steps as steps_lib
    from repro_torch.optim import AdamWConfig
    cfg, opt_cfg = cfg or _cfg(arch), AdamWConfig(lr=LR)
    gen = torch.Generator()
    gen.manual_seed(0)
    state = steps_lib.init_train_state(cfg, opt_cfg, gen, "cpu", mesh=mesh)
    step = steps_lib.make_train_step(cfg, opt_cfg, mesh=mesh)
    losses = []
    for i in range(STEPS):
        state, m = step(state, _batch(x, arch, i))
        losses.append(float(m["loss"]))
    return np.array(losses)


def _own_grads(x, cfg, mesh=None):
    """Step 1's loss and (gathered) gradients from the port's own seed-0
    state."""
    from repro_torch.launch import steps as steps_lib
    from repro_torch.models import model as model_lib
    from repro_torch.optim import AdamWConfig
    gen = torch.Generator()
    gen.manual_seed(0)
    state = steps_lib.init_train_state(cfg, AdamWConfig(lr=LR), gen, "cpu",
                                       mesh=mesh)
    batch = _batch(x, MOE_ARCH, 0)
    sh = model_lib.make_sharding(cfg, mesh, "train", BATCH)
    if sh is None:
        loss, _, grads = steps_lib.loss_and_grads(cfg, state.params, batch)
        return float(loss), _flatten(grads)
    rows, i = BATCH // sh.batch_shards, sh.batch_index()
    mine = {k: v[i * rows:(i + 1) * rows] for k, v in batch.items()}
    loss, _, grads = steps_lib.mesh_loss_and_grads(cfg, sh, state.params, mine)
    return float(loss), _flatten(model_lib.gather_params(grads, cfg, mesh))


def _rank_moe(x, out, mesh):
    for impl in MOE_IMPLS:
        loss, grads = _own_grads(x, _moe_cfg(impl), mesh)
        out[f"moe2x2/{impl}/loss_grad"] = np.array(loss)
        for k, v in grads.items():
            out[f"moe2x2/{impl}/grad/{k}"] = v.numpy()
        out[f"moe2x2/{impl}/losses"] = _own_losses(x, MOE_ARCH, mesh,
                                                   _moe_cfg(impl))


def _ref_state(ref, arch, compress):
    from repro_torch.launch import steps as steps_lib
    from repro_torch.models import model as model_lib
    from repro_torch.optim import AdamWConfig, adamw_init
    params = model_lib.params_from_numpy(
        _unflatten(ref, f"params/{arch}/"), "cpu")
    opt_cfg = AdamWConfig(lr=LR, compress_grads=compress)
    params = steps_lib._trainable(params)
    return steps_lib.TrainState(params=params, opt=adamw_init(params, opt_cfg),
                                step=torch.zeros((), dtype=torch.int32)), opt_cfg


def _rank_train(x, ref, out, meshes):
    from repro_torch.launch import steps as steps_lib
    from repro_torch.models import model as model_lib
    for arch, shape, compress in _all_cases():
        cid = _case_id(arch, shape, compress)
        cfg, mesh = _cfg(arch), meshes[shape]
        state, opt_cfg = _ref_state(ref, arch, compress)
        state = steps_lib.shard_train_state(state, cfg, mesh)
        if not compress:
            sh = model_lib.make_sharding(cfg, mesh, "train", BATCH)
            rows = BATCH // sh.batch_shards
            i = sh.batch_index()
            mine = {k: v[i * rows:(i + 1) * rows]
                    for k, v in _batch(x, arch, 0).items()}
            loss, _, grads = steps_lib.mesh_loss_and_grads(cfg, sh,
                                                           state.params, mine)
            out[f"{cid}/loss_grad"] = loss.numpy()
            whole = model_lib.gather_params(grads, cfg, mesh)
            for k, v in _flatten(whole).items():
                out[f"{cid}/grad/{k}"] = v.numpy()
        step = steps_lib.make_train_step(cfg, opt_cfg, mesh=mesh)
        losses, norms = [], []
        for i in range(STEPS):
            state, m = step(state, _batch(x, arch, i))
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
        out[f"{cid}/losses"] = np.array(losses)
        out[f"{cid}/norms"] = np.array(norms)
    for arch, shape in OTHERS:
        out[f"others/{arch}"] = _own_losses(x, arch, meshes[shape])


def _rank_threads(x, out, mesh):
    """llama3-8b's remat'd sharded loss on 2 x 2, its backward (and so the
    layers' recompute) run on another thread, as autograd runs a CUDA
    backward on its device thread, against the same backward here."""
    import threading
    from repro_torch.launch import steps as steps_lib
    from repro_torch.models import model as model_lib
    from repro_torch.optim import AdamWConfig
    cfg = _cfg("llama3-8b").replace(remat=True)
    gen = torch.Generator()
    gen.manual_seed(0)
    params = steps_lib.init_train_state(cfg, AdamWConfig(lr=LR), gen, "cpu",
                                        mesh=mesh).params
    sh = model_lib.make_sharding(cfg, mesh, "train", BATCH)
    rows, i = BATCH // sh.batch_shards, sh.batch_index()
    batch = {k: v[i * rows:(i + 1) * rows]
             for k, v in _batch(x, "llama3-8b", 0).items()}
    leaves = list(_flatten(params).values())

    def grads():
        with mesh:
            loss, _ = model_lib.loss_fn(params, cfg, batch["tokens"],
                                        batch["targets"], sh=sh)
        box = {}
        t = threading.Thread(target=lambda: box.update(
            g=torch.autograd.grad(loss, leaves)))
        t.start()
        t.join()
        return box["g"]
    first = grads()
    with mesh:
        loss, _ = model_lib.loss_fn(params, cfg, batch["tokens"],
                                    batch["targets"], sh=sh)
    here = torch.autograd.grad(loss, leaves)
    out["threads/same"] = np.array(all(torch.equal(a, b)
                                       for a, b in zip(first, here)))


def _rank_int8_psum(x, out, mesh):
    from repro_torch.launch import collectives as coll
    from repro_torch.optim import int8_psum
    grads = {"a": _t(x["psum/a"]), "b": _t(x["psum/b"]),
             "ones": _t(x["psum/ones"])}
    coll.reset()
    got = int8_psum(grads, mesh, "data")
    out["psum/bytes"] = np.array(coll.BYTES["all-reduce"])
    out["psum/calls"] = np.array(coll.CALLS["all-reduce"])
    for k, v in got.items():
        out[f"psum/{k}"] = v.numpy()


def _rank_row_parallel(x, out, mesh):
    """One MLP on a 1 x 4 mesh (w_up / w_gate column-, w_down row-parallel):
    its bytes, and its output against the whole MLP's."""
    from repro_torch.launch import collectives as coll
    from repro_torch.models.mlp import mlp_fwd
    cfg = _cfg("llama3-8b").replace(d_ff=256)
    gen = torch.Generator()
    gen.manual_seed(3)
    whole = {k: torch.randn(s, generator=gen) * 0.1 for k, s in
             (("w_up", (64, 256)), ("w_gate", (64, 256)),
              ("w_down", (256, 64)))}
    r = mesh.axis_index("model")
    mine = {"w_up": whole["w_up"][:, 64 * r:64 * (r + 1)],
            "w_gate": whole["w_gate"][:, 64 * r:64 * (r + 1)],
            "w_down": whole["w_down"][64 * r:64 * (r + 1)]}
    coll.reset()
    with torch.no_grad():
        got = mlp_fwd(mine, _t(x["mlp/x"]), cfg, tp=mesh)
    out["mlp/bytes"] = np.array(coll.BYTES["all-reduce"])
    out["mlp/calls"] = np.array(sum(coll.CALLS.values()))
    out["mlp/out"] = got.numpy()
    out["mlp/whole"] = mlp_fwd(whole, _t(x["mlp/x"]), cfg).detach().numpy()


def _packed(cfg, params):
    """``params`` with every dense site's weight an 8-bit packed store."""
    from repro_torch import backends
    return backends.pack_weights(cfg, params, bits=8)


def _packed_scope():
    """Where packed stores execute: an 8-bit backend scope, activations
    quantized per row (a rank's rows get the codes they get in the whole
    batch)."""
    import contextlib
    from repro_torch import backends
    from repro_torch.models.common import activation_scaling
    stack = contextlib.ExitStack()
    stack.enter_context(backends.use_backend("tubgemm", bits=8))
    stack.enter_context(activation_scaling("per-row"))
    return stack


def _rank_serve(x, ref, out, mesh):
    from repro_torch.models import model as model_lib
    cfg = _cfg("llama3-8b")
    params = model_lib.params_from_numpy(_unflatten(ref, "params/llama3-8b/"),
                                         "cpu")
    mine = model_lib.rank_params(params, cfg, mesh)
    out["serve/sliced"] = np.array(
        tuple(mine["layers"]["attn"]["wq"].shape) != tuple(
            params["layers"]["attn"]["wq"].shape))
    out["serve/logits"] = _serve_on_mesh(x, cfg, mine, mesh)
    # packed stores replicate with their modules' tensor-parallel leaves
    mine = model_lib.rank_params(_packed(cfg, params), cfg, mesh)
    with _packed_scope():
        out["serve/packed_logits"] = _serve_on_mesh(x, cfg, mine, mesh)


def _serve_on_mesh(x, cfg, mine, mesh):
    from repro_torch.launch import steps as steps_lib
    from repro_torch.models import model as model_lib
    caches = model_lib.init_caches(cfg, SERVE_BATCH, SERVE_MAX_LEN,
                                   torch.float32, "cpu", mesh=mesh)
    prefill = steps_lib.make_prefill_step(cfg, mesh, SERVE_BATCH,
                                          SERVE_MAX_LEN, mine)
    decode = steps_lib.make_decode_step(cfg, mesh, SERVE_BATCH,
                                        SERVE_MAX_LEN, mine)
    logits, caches = prefill(mine, {"tokens": _t(x["serve/prompt"])}, caches)
    outs = [logits[:, -1:]]
    for i in range(SERVE_DECODES):
        logits, caches = decode(mine, _t(x["serve/tokens"][i]), caches,
                                SERVE_PROMPT + i)
        outs.append(logits)
    return torch.cat(outs, dim=1).numpy()


class _OneLeafShards:
    """``launch.steps.StateShards`` that count the gathered whole leaves
    still alive when the next one is gathered."""

    def __init__(self, cfg, mesh):
        from repro_torch.launch import steps as steps_lib
        self.inner = steps_lib.StateShards(cfg, mesh)
        self.alive, self.gathers, self.most_alive = [], 0, 0

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def gather(self, leaf, spec, host=True):
        import weakref
        self.alive = [r for r in self.alive if r() is not None]
        self.most_alive = max(self.most_alive, len(self.alive))
        whole = self.inner.gather(leaf, spec, host)
        if whole is not None:
            self.alive.append(weakref.ref(whole))
        self.gathers += spec is not None
        return whole


def _rank_checkpoints(ref, out, mesh, work):
    """Restore the reference's checkpoint onto the 2 x 2 mesh; save the
    rank's slices and restore them into a fresh state."""
    from unittest import mock
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.launch import steps as steps_lib
    from repro_torch.optim import AdamWConfig
    cfg = _cfg("llama3-8b")
    opt_cfg = AdamWConfig(lr=LR)
    shards = _OneLeafShards(cfg, mesh)
    target = steps_lib.init_train_state(cfg, opt_cfg, None, "cpu", mesh=mesh)
    got, step, _ = CheckpointManager(os.path.join(work, "refckpt"),
                                     shards=shards).restore_latest(target)
    out["ckpt/ref_step"] = np.array(step)
    whole = steps_lib.gather_train_state(got, cfg, mesh)
    for name, tree in (("params", whole.params), ("m", whole.opt.m),
                       ("v", whole.opt.v)):
        for k, v in _flatten(tree).items():
            out[f"ckpt/ref/{name}/{k}"] = v.detach().numpy()
    out["ckpt/sliced"] = np.array(
        got.params["embed"].shape[0] < cfg.vocab_size)
    mgr = CheckpointManager(os.path.join(work, "ckpt"), shards=shards)
    with mock.patch.object(steps_lib, "CHECKPOINT_BLOCK_BYTES", 4096):
        mgr.save(9, got)              # the stacked leaves in several blocks
    mgr.wait()
    torch.distributed.barrier()
    fresh = steps_lib.init_train_state(cfg, opt_cfg, None, "cpu", mesh=mesh)
    back, step, _ = mgr.restore_latest(fresh)
    same = all(torch.equal(a, b) for a, b in zip(
        _flatten(back.params).values(), _flatten(got.params).values()))
    same &= all(torch.equal(a, b) for a, b in zip(
        _flatten(back.opt.v).values(), _flatten(got.opt.v).values()))
    out["ckpt/round_trip"] = np.array(same and step == 9)
    out["ckpt/gathers"] = np.array(shards.gathers)
    out["ckpt/most_alive"] = np.array(shards.most_alive)


def _rank_cli(out, work):
    """``train --smoke --mesh-shape 2,2 --ckpt-dir`` on this rank (reusing
    the process group, which the CLI tears down last), and the whole
    shapes of what it saved."""
    import json
    from repro_torch import configs
    from repro_torch.launch import train
    ckpt = os.path.join(work, "cli_ckpt")
    out["cli_rc"] = np.array(train.main([
        "--smoke", "--device", "cpu", "--mesh-shape", "2,2", "--steps", "2",
        "--batch", "4", "--seq", "16", "--ckpt-dir", ckpt,
        "--ckpt-every", "1"]))
    with open(os.path.join(ckpt, "step_000000002", "manifest.json")) as fh:
        leaves = json.load(fh)["leaves"]
    cfg = configs.get_smoke_config("llama3-8b")
    out["cli_ckpt_whole"] = np.array(
        leaves["0/embed"]["shape"] == [cfg.vocab_size, cfg.d_model]
        and leaves["1/2/embed"]["shape"] == [cfg.vocab_size, cfg.d_model])


def _rank_main(rank: int, init_file: str, work: str) -> None:
    import torch.distributed as dist
    from repro_torch.launch import mesh as mesh_lib
    torch.set_num_threads(1)
    mesh_lib.init_distributed("cpu", init_method=f"file://{init_file}",
                              rank_=rank, world=WORLD, timeout_s=120)
    x = dict(np.load(os.path.join(work, "inputs.npz")))
    ref = dict(np.load(os.path.join(work, "ref_init.npz")))
    meshes = {s: mesh_lib.make_mesh(s, ("data", "model"), "cpu")
              for s in ((2, 2), (1, 4))}
    pod = mesh_lib.make_mesh((2, 1, 2), ("pod", "data", "model"), "cpu")
    out: dict = {}
    _rank_train(x, ref, out, meshes)
    _rank_moe(x, out, meshes[(2, 2)])
    _rank_threads(x, out, meshes[(2, 2)])
    _rank_int8_psum(x, out, meshes[(2, 2)])
    _rank_row_parallel(x, out, meshes[(1, 4)])
    _rank_serve(x, ref, out, pod)
    _rank_checkpoints(ref, out, meshes[(2, 2)], work)
    _rank_cli(out, work)               # last: it destroys the process group
    assert not dist.is_initialized()
    np.savez(os.path.join(work, f"rank{rank}.npz"), **out)


# ---------------------------------------------------------------------------
# the reference's side, in its own process (4 fake XLA devices)
# ---------------------------------------------------------------------------

REF_SCRIPT = r"""
import os, sys
import numpy as np
import jax, jax.numpy as jnp
work, part = sys.argv[1:]
x = dict(np.load(os.path.join(work, "inputs.npz")))
auto = jax.sharding.AxisType.Auto
def mesh_of(shape, axes=("data", "model")):
    return jax.make_mesh(shape, axes, axis_types=(auto,) * len(shape))
from repro import configs
from repro.checkpoint import manager as ckpt
from repro.launch import steps
from repro.models import model as model_lib
from repro.optim import AdamWConfig, OptState
from repro.optim.compression import int8_psum
CASES = %(cases)r
ARCHS = %(archs)r
def flat(tree, prefix):
    out = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
        out[prefix + "/".join(str(p.key) for p in path)] = np.asarray(leaf)
    return out
def cfg_of(arch):
    return configs.get_smoke_config(arch).replace(compute_dtype="float32")
init = {}
states = {}
for arch in ARCHS:
    st = steps.init_train_state(cfg_of(arch), AdamWConfig(lr=%(lr)r),
                                jax.random.PRNGKey(0))
    states[arch] = st
    init.update(flat(st.params, f"params/{arch}/"))
# a checkpoint with moments that are not zero, for the resume test
st = states["llama3-8b"]
rng = np.random.default_rng(5)
noisy = lambda t: jax.tree_util.tree_map(
    lambda a: jnp.asarray(rng.normal(0, 1, a.shape).astype(np.float32)), t)
ck = steps.TrainState(params=st.params,
                      opt=OptState(step=jnp.int32(7), m=noisy(st.params),
                                   v=jax.tree_util.tree_map(jnp.abs, noisy(st.params)),
                                   ef=None),
                      step=jnp.int32(7))
out = {}
if part == "a":
    ckpt.save(os.path.join(work, "refckpt"), 7, ck)
    init.update(flat(ck.params, "ckpt/params/"))
    init.update(flat(ck.opt.m, "ckpt/m/"))
    init.update(flat(ck.opt.v, "ckpt/v/"))
    np.savez(os.path.join(work, "ref_init.npz"), **init)
    open(os.path.join(work, "ref_init.done"), "w").write("ok")
    m22 = mesh_of((2, 2))
    g = {"a": jnp.asarray(x["psum/a"]), "b": jnp.asarray(x["psum/b"]),
         "ones": jnp.asarray(x["psum/ones"])}
    for k, v in int8_psum(g, m22, "data").items():
        out[f"psum/{k}"] = np.asarray(v)
# part a: llama3-8b and the pspecs; part b: the other two archs
for arch, shape in [c for c in CASES if (c[0] == "llama3-8b") == (part == "a")]:
    cfg = cfg_of(arch)
    mesh = mesh_of(shape)
    batches = [{"tokens": jnp.asarray(x[f"batch/{arch}/tokens"][i]),
                "targets": jnp.asarray(x[f"batch/{arch}/targets"][i])}
               for i in range(%(steps)d)]
    cid = f"{arch}/{shape[0]}x{shape[1]}"
    with mesh:
        p_specs = steps.named(mesh, model_lib.param_pspecs(cfg, mesh))
        b_specs = steps.named(mesh, steps.batch_pspecs(cfg, mesh, batch_size=%(batch)d))
        def loss_of(params, batch):
            return model_lib.loss_fn(params, cfg, batch["tokens"], batch["targets"])
        (loss, _), grads = jax.jit(jax.value_and_grad(loss_of, has_aux=True),
                                   in_shardings=(p_specs, b_specs))(
            states[arch].params, batches[0])
        out[f"{cid}/plain/loss_grad"] = np.asarray(loss)
        out.update(flat(grads, f"{cid}/plain/grad/"))
        for compress in (False, True):
            opt = AdamWConfig(lr=%(lr)r, compress_grads=compress)
            state = steps.init_train_state(cfg, opt, jax.random.PRNGKey(0))
            fn = steps.make_train_step(cfg, mesh, opt, donate=False,
                                       batch_size=%(batch)d)
            losses, norms = [], []
            for b in batches:
                state, m = fn(state, b)
                losses.append(float(m["loss"]))
                norms.append(float(m["grad_norm"]))
            tag = "ef" if compress else "plain"
            out[f"{cid}/{tag}/losses"] = np.array(losses)
            out[f"{cid}/{tag}/norms"] = np.array(norms)
for arch, shape in CASES if part == "a" else ():
    specs = steps.batch_pspecs(cfg_of(arch), mesh_of(shape), batch_size=%(batch)d)
    out[f"bspec/{arch}/{shape[0]}x{shape[1]}"] = np.array(repr(tuple(specs["tokens"])))
for phase in ("train", "inference") if part == "a" else ():
    for shape in ((2, 2), (1, 4)):
        mesh = mesh_of(shape)
        for arch in configs.ARCH_IDS:
            specs = model_lib.param_pspecs(configs.get_config(arch), mesh, phase)
            for path, spec in jax.tree_util.tree_leaves_with_path(
                    specs, is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec)):
                key = "/".join(str(p.key) for p in path)
                out[f"pspec/{phase}/{shape[0]}x{shape[1]}/{arch}/{key}"] = \
                    np.array(repr(tuple(spec)))
np.savez(os.path.join(work, f"ref_{part}.npz"), **out)
print("REF_DONE")
""" % dict(cases=CASES, archs=ARCHS, lr=LR, steps=STEPS, batch=BATCH)


# ---------------------------------------------------------------------------
# the run: ranks and reference side by side, once per module
# ---------------------------------------------------------------------------

def _one_process(x, ref) -> dict:
    """The port's one-process counterparts, in this process."""
    from repro_torch.launch import steps as steps_lib
    from repro_torch.models import model as model_lib
    out = {}
    for arch, shape, compress in _all_cases():
        if shape != CASES[[a for a, _ in CASES].index(arch)][1]:
            continue                    # one per (arch, compress)
        state, opt_cfg = _ref_state(ref, arch, compress)
        step = steps_lib.make_train_step(_cfg(arch), opt_cfg)
        losses = []
        for i in range(STEPS):
            state, m = step(state, _batch(x, arch, i))
            losses.append(float(m["loss"]))
        out[f"{arch}/{'ef' if compress else 'plain'}/losses"] = np.array(losses)
    for arch, _ in OTHERS:
        out[f"others/{arch}"] = _own_losses(x, arch)
    from unittest import mock
    from repro_torch.models import moe as moe_lib
    for impl in MOE_IMPLS:
        with mock.patch.object(moe_lib, "_aux_loss", _sliced_aux_loss(2, 2)
                               if impl == "a2a" else moe_lib._aux_loss):
            loss, grads = _own_grads(x, _moe_cfg(impl))
            out[f"moe2x2/{impl}/losses"] = _own_losses(x, MOE_ARCH,
                                                       cfg=_moe_cfg(impl))
        out[f"moe2x2/{impl}/loss_grad"] = np.array(loss)
        for k, v in grads.items():
            out[f"moe2x2/{impl}/grad/{k}"] = v.numpy()
    cfg = _cfg("llama3-8b")
    params = model_lib.params_from_numpy(_unflatten(ref, "params/llama3-8b/"),
                                         "cpu")
    out["serve/logits"] = _serve_one(x, cfg, params)
    with _packed_scope():
        out["serve/packed_logits"] = _serve_one(x, cfg, _packed(cfg, params))
    return out


def _serve_one(x, cfg, params):
    from repro_torch.models import model as model_lib
    with torch.no_grad():
        caches = model_lib.init_caches(cfg, SERVE_BATCH, SERVE_MAX_LEN,
                                       torch.float32, "cpu")
        logits, caches = model_lib.prefill(params, cfg, _t(x["serve/prompt"]),
                                           caches=caches)
        outs = [logits[:, -1:]]
        for i in range(SERVE_DECODES):
            logits, caches = model_lib.decode_step(
                params, cfg, _t(x["serve/tokens"][i]), caches=caches,
                cache_pos=SERVE_PROMPT + i)
            outs.append(logits)
    return torch.cat(outs, dim=1).numpy()


def _sliced_aux_loss(n_data: int, n_model: int):
    """The a2a dispatch's aux loss on an ``n_data`` x ``n_model`` mesh, on
    one process: the mean over the ``model`` ranks r of E sum_e f_e p_e,
    the fractions over the r-th token slice of every data rank's block."""
    import torch.nn.functional as F

    def aux(probs, topk_idx, cfg, sh=None):
        e = cfg.moe.num_experts
        hits = F.one_hot(topk_idx[..., 0], e).to(torch.float32)
        blocks = torch.arange(probs.shape[0]).reshape(n_data, n_model, -1)
        total = 0.0
        for r in range(n_model):
            rows = blocks[:, r].reshape(-1)
            total = total + e * torch.sum(hits[rows].mean(dim=0)
                                          * probs[rows].mean(dim=0))
        return total / n_model
    return aux


def _wait_for(path: str, proc, limit_s: float) -> None:
    deadline = time.monotonic() + limit_s
    while not os.path.exists(path):
        if proc.poll() is not None:
            raise RuntimeError(f"the reference exited first:\n"
                               f"{proc.stderr.read()[-3000:]}")
        if time.monotonic() > deadline:
            raise TimeoutError(f"no {path} after {limit_s} s")
        time.sleep(0.2)


@pytest.fixture(scope="module")
def train_run():
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory() as work:
        x = _make_inputs(Path(work) / "inputs.npz")
        env = dict(os.environ, JAX_PLATFORMS="cpu",
                   XLA_FLAGS="--xla_force_host_platform_device_count=4",
                   PYTHONPATH=os.pathsep.join(
                       [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]))
        # two reference processes side by side: "a" writes the initial
        # parameters first, then runs llama3-8b and the pspecs; "b" the rest
        refs = [subprocess.Popen([sys.executable, "-c", REF_SCRIPT, work, part],
                                 env=env, cwd=str(ROOT), stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True)
                for part in "ab"]
        try:
            _wait_for(os.path.join(work, "ref_init.done"), refs[0],
                      RANK_TIMEOUT_S)
            init = dict(np.load(os.path.join(work, "ref_init.npz")))
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
            one = _one_process(x, init)
            done = [ref.communicate(timeout=RANK_TIMEOUT_S) for ref in refs]
        finally:
            for ref in refs:
                if ref.poll() is None:
                    ref.kill()
        for ref, (stdout, stderr) in zip(refs, done):
            assert ref.returncode == 0 and "REF_DONE" in stdout, stderr[-3000:]
        ranks = [dict(np.load(os.path.join(work, f"rank{r}.npz")))
                 for r in range(WORLD)]
        ref_out = {}
        for part in "ab":
            ref_out.update(np.load(os.path.join(work, f"ref_{part}.npz")))
        yield {"x": x, "ranks": ranks, "ref": ref_out, "init": init,
               "one": one}


def _same_on_every_rank(run, key):
    first = run["ranks"][0][key]
    for r, out in enumerate(run["ranks"][1:], 1):
        assert np.array_equal(out[key], first), \
            f"rank {r} differs from rank 0 at {key}"
    return first


def _rel(got, want) -> float:
    return float(np.max(np.abs(np.asarray(got) - np.asarray(want))
                        / np.maximum(np.abs(np.asarray(want)), 1e-30)))


CASE_IDS = [f"{a}-{s[0]}x{s[1]}" for a, s in CASES]


@pytest.mark.parametrize("arch,shape", CASES, ids=CASE_IDS)
def test_step1_loss_and_gradients_match_reference(train_run, arch, shape):
    cid = _case_id(arch, shape, False)
    loss = _same_on_every_rank(train_run, f"{cid}/loss_grad")
    assert _rel(loss, train_run["ref"][f"{cid}/loss_grad"]) <= LOSS1_TOL
    grads = {k[len(f"{cid}/grad/"):]: v for k, v in
             train_run["ranks"][0].items() if k.startswith(f"{cid}/grad/")}
    want = {k[len(f"{cid}/grad/"):]: v for k, v in
            train_run["ref"].items() if k.startswith(f"{cid}/grad/")}
    assert grads and sorted(grads) == sorted(want)
    for k, g in grads.items():
        scale = float(np.abs(want[k]).max())
        err = float(np.abs(g - want[k]).max())
        tol = GRAD_TOL.get(arch, DEFAULT_TOL)
        assert err <= tol * scale, f"{k}: {err} > {tol} x {scale}"


@pytest.mark.parametrize("compress", (False, True), ids=("plain", "ef"))
@pytest.mark.parametrize("arch,shape", CASES, ids=CASE_IDS)
def test_three_steps_match_reference_and_one_process(train_run, arch, shape,
                                                     compress):
    cid = _case_id(arch, shape, compress)
    losses = _same_on_every_rank(train_run, f"{cid}/losses")
    norms = _same_on_every_rank(train_run, f"{cid}/norms")
    assert np.all(np.isfinite(losses)) and losses[-1] < losses[0]
    tol = LOSSES_TOL.get(arch, DEFAULT_TOL)
    assert _rel(losses, train_run["ref"][f"{cid}/losses"]) <= tol
    tag = "ef" if compress else "plain"
    assert _rel(losses, train_run["one"][f"{arch}/{tag}/losses"]) <= tol
    # the first step's norm is the whole gradient's, before any update
    assert _rel(norms[0], train_run["ref"][f"{cid}/norms"][0]) <= 1e-5


@pytest.mark.parametrize("arch,shape", OTHERS,
                         ids=[f"{a}-{s[0]}x{s[1]}" for a, s in OTHERS])
def test_other_families_on_a_mesh_match_one_process(train_run, arch, shape):
    losses = _same_on_every_rank(train_run, f"others/{arch}")
    assert np.all(np.isfinite(losses))
    assert _rel(losses, train_run["one"][f"others/{arch}"]) <= DEFAULT_TOL


@pytest.mark.parametrize("phase", ("train", "inference"))
@pytest.mark.parametrize("shape", ((2, 2), (1, 4)), ids=("2x2", "1x4"))
def test_param_pspecs_equal_reference(train_run, phase, shape):
    from repro_torch import configs
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import model as model_lib
    mesh = Mesh(shape, ("data", "model"), (torch.device("cpu"),) * 4)
    prefix = f"pspec/{phase}/{shape[0]}x{shape[1]}/"
    n = 0
    for arch in configs.ARCH_IDS:
        got = _flatten(model_lib.param_pspecs(configs.get_config(arch), mesh,
                                              phase))
        want = {k[len(prefix) + len(arch) + 1:]: str(v) for k, v in
                train_run["ref"].items() if k.startswith(f"{prefix}{arch}/")}
        assert sorted(got) == sorted(want), arch
        for key, spec in got.items():
            ref_spec = eval(want[key])              # a tuple's repr
            ref_spec += (None,) * (len(spec) - len(ref_spec))
            assert spec == ref_spec, f"{arch} {key}: {spec} != {ref_spec}"
            n += 1
    assert n == sum(1 for k in train_run["ref"] if k.startswith(prefix))


@pytest.mark.parametrize("arch,shape", CASES, ids=CASE_IDS)
def test_batch_and_state_pspecs_equal_reference(train_run, arch, shape):
    from repro_torch.launch import steps as steps_lib
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import model as model_lib
    mesh = Mesh(shape, ("data", "model"), (torch.device("cpu"),) * 4)
    cfg = _cfg(arch)
    got = steps_lib.batch_pspecs(cfg, mesh, batch_size=BATCH)
    want = eval(str(train_run["ref"][f"bspec/{arch}/{shape[0]}x{shape[1]}"]))
    assert got["tokens"] == got["targets"] == want + (None,) * (2 - len(want))
    specs = steps_lib.train_state_pspecs(cfg, mesh, compress_grads=True)
    assert specs.params == specs.opt.m == specs.opt.v == specs.opt.ef \
        == model_lib.param_pspecs(cfg, mesh)


def test_int8_psum_is_bit_identical_to_reference(train_run):
    for k in ("a", "b", "ones"):
        got = _same_on_every_rank(train_run, f"psum/{k}")
        assert np.array_equal(got, train_run["ref"][f"psum/{k}"]), k
    # a sum over data = 2, not a mean
    assert np.array_equal(train_run["ranks"][0]["psum/ones"],
                          np.full((3, 4), 2.0, np.float32))
    # hand count: per leaf one fp32 max and the int32 codes, over data
    leaves = [train_run["x"][f"psum/{k}"] for k in ("a", "b", "ones")]
    want = sum(4 + a.size * 4 for a in leaves)
    assert int(_same_on_every_rank(train_run, "psum/bytes")) == want
    assert int(_same_on_every_rank(train_run, "psum/calls")) == 2 * len(leaves)


def test_row_parallel_mlp_counts_one_all_reduce(train_run):
    out = _same_on_every_rank(train_run, "mlp/out")
    whole = train_run["ranks"][0]["mlp/whole"]
    assert float(np.abs(out - whole).max()) <= 1e-5 * float(np.abs(whole).max())
    x = train_run["x"]["mlp/x"]
    assert int(_same_on_every_rank(train_run, "mlp/bytes")) == x.size * 4
    assert int(_same_on_every_rank(train_run, "mlp/calls")) == 1


@pytest.mark.parametrize("weights", ("float", "packed"))
def test_pod_mesh_serving_on_sharded_weights_matches_one_process(train_run,
                                                                weights):
    assert all(bool(r["serve/sliced"]) for r in train_run["ranks"])
    key = "serve/logits" if weights == "float" else "serve/packed_logits"
    got = _same_on_every_rank(train_run, key)
    want = train_run["one"][key]
    assert got.shape == want.shape == (SERVE_BATCH, 1 + SERVE_DECODES, 512)
    assert float(np.abs(got - want).max()) <= MESH_TOL * float(
        np.abs(want).max())


def test_reference_checkpoint_resumes_on_a_2x2_mesh(train_run):
    init = train_run["init"]
    for r, out in enumerate(train_run["ranks"]):
        assert int(out["ckpt/ref_step"]) == 7 and bool(out["ckpt/sliced"])
        for name in ("params", "m", "v"):
            keys = [k for k in init if k.startswith(f"ckpt/{name}/")]
            assert keys
            for k in keys:
                assert np.array_equal(out[f"ckpt/ref/{k[len('ckpt/'):]}"],
                                      init[k]), (r, k)


def test_sharded_checkpoint_round_trips(train_run):
    assert all(bool(r["ckpt/round_trip"]) for r in train_run["ranks"])


def test_sharded_save_gathers_one_leaf_at_a_time(train_run):
    """Every rank gathers the sliced leaves one by one, and no gathered
    whole leaf is alive when the next is gathered."""
    for r in train_run["ranks"]:
        assert int(r["ckpt/gathers"]) > 10
        assert int(r["ckpt/most_alive"]) == 0


def test_train_cli_on_a_2x2_mesh(train_run):
    assert [int(r["cli_rc"]) for r in train_run["ranks"]] == [0] * WORLD
    assert all(bool(r["cli_ckpt_whole"]) for r in train_run["ranks"])


def test_production_mesh_names_both_counts():
    from repro_torch.launch import mesh as mesh_lib
    with pytest.raises(NotImplementedError,
                       match="512 positions and the world has 1 rank"):
        mesh_lib.make_production_mesh(multi_pod=True)


def test_sharding_is_seen_from_another_thread(train_run):
    """A CUDA backward (and remat's recompute in it) runs on autograd's
    device thread: the sharding the loss was taken with reaches it, and
    the gradients equal those of a backward on the loss's own thread."""
    assert all(bool(r["threads/same"]) for r in train_run["ranks"])


@pytest.mark.parametrize("impl", MOE_IMPLS)
def test_moe_on_a_2x2_mesh_matches_one_process(train_run, impl):
    """Expert parallelism over model while the batch splits over data: the
    aux loss from load fractions summed over data, its gradient the whole
    batch's.  One process takes a2a's aux as the a2a path defines it, per
    token slice (``_sliced_aux_loss``); psum's is the whole batch's."""
    key = f"moe2x2/{impl}"
    loss = _same_on_every_rank(train_run, f"{key}/loss_grad")
    one = train_run["one"]
    assert _rel(loss, one[f"{key}/loss_grad"]) <= LOSS1_TOL
    grads = {k[len(f"{key}/grad/"):]: v for k, v in
             train_run["ranks"][0].items() if k.startswith(f"{key}/grad/")}
    want = {k[len(f"{key}/grad/"):]: v for k, v in one.items()
            if k.startswith(f"{key}/grad/")}
    assert grads and sorted(grads) == sorted(want)
    for k, g in grads.items():
        scale = float(np.abs(want[k]).max())
        err = float(np.abs(g - want[k]).max())
        assert err <= DEFAULT_TOL * scale, f"{k}: {err} > {DEFAULT_TOL} x {scale}"
    losses = _same_on_every_rank(train_run, f"{key}/losses")
    assert _rel(losses, one[f"{key}/losses"]) <= DEFAULT_TOL
