"""The port's multi-device serving paths on a 4-rank ``gloo`` mesh, against
the reference's shard_map code on 4 fake XLA devices.

One module-scoped spawn of 4 ranks (``torch.distributed`` with ``gloo`` and
a ``file://`` store, no card) runs every port-side case and writes each
rank's outputs; one subprocess runs the reference's side (``XLA_FLAGS`` has
to pin the device count before jax starts, and the mesh is built with
``AxisType.Auto`` axes); the main process computes the one-device
counterparts.  The cases are separate tests:

* ``GridBackend.execute`` on 2x2 and 1x4 grids, one unit per rank, for
  tubGEMM, tuGEMM, bGEMM and uGEMM: bit-identical to the reference's
  ``as_grid(...).execute`` and to the flat unit;
* the grid serving engine's token streams on 4 ranks equal the one-process
  grid engine's and the flat engine's, and ``serve traffic --smoke --grid
  2,2`` passes its gates on every rank;
* the sequence-sharded GQA and MLA decodes (B 4, S 32, H 8, KVH 2, D 16,
  pos 19) within 1e-5 of the reference's shard_map functions and of
  ``naive_attention`` / ``_mla_absorbed_attend``;
* expert-parallel MoE: psum within 1e-4 of the reference's ``moe_fwd``
  under its mesh and of the local path, a2a within 1e-4 of psum at
  capacity factor 8;
* ``make_prefill_step`` / ``make_decode_step`` on a (data 1, model 4) mesh
  against the reference's ``model.prefill`` / ``decode_step`` at smoke width
  (llama3-8b, and deepseek-v3 for MLA with expert parallelism);
* a mesh whose size differs from the world size raises, and a decode step
  whose token ids differ across ranks raises.

The ranks import no jax: this module imports none at the top.
"""

from __future__ import annotations

import dataclasses
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
GRID_DESIGNS = ("tubgemm", "tugemm", "bgemm", "ugemm")
GRIDS = ((2, 2), (1, 4))
BITS = 4
B, S, H, KVH, D, POS = 4, 32, 8, 2, 16, 19
STEP_ARCHS = ("llama3-8b", "deepseek-v3-671b")
STEP_BATCH, STEP_PROMPT, STEP_MAX_LEN, STEP_DECODES = 2, 8, 32, 3
TRAFFIC = dict(num_requests=6, arrival_rate=1.0, seed=0)
ENGINE_KW = dict(max_batch=4, page_size=8, max_seq_len=64, bits=BITS,
                 backend="tubgemm")
RANK_TIMEOUT_S = 240


# ---------------------------------------------------------------------------
# inputs, shared by the ranks, the reference subprocess and this process
# ---------------------------------------------------------------------------

def _mla_cfg(cfg_mod):
    return cfg_mod.ModelConfig(
        d_model=32, num_heads=4, num_kv_heads=4, attention="mla",
        mla=cfg_mod.MLAConfig(q_lora_rank=16, kv_lora_rank=8,
                              rope_head_dim=4, nope_head_dim=8, v_head_dim=8))


def _moe_cfg(cfg_mod):
    return cfg_mod.ModelConfig(
        family="moe", d_model=32, d_ff=64, vocab_size=64,
        moe=cfg_mod.MoEConfig(num_experts=8, top_k=2, d_ff_expert=32,
                              capacity_factor=8.0))


def _step_cfg(arch: str):
    from repro_torch import configs
    return configs.get_smoke_config(arch).replace(compute_dtype="float32")


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


def _seeded_params(cfg, seed: int) -> dict:
    """A parameter tree of ``cfg``'s shapes with seeded normal values (std
    0.2; norms 1), so both packages run the same weights."""
    from repro_torch.models import model as model_lib
    from repro_torch.models.common import ParamDef
    rng = np.random.default_rng(seed)

    def draw(defs):
        if isinstance(defs, ParamDef):
            if defs.init == "ones":
                return np.ones(defs.shape, np.float32)
            return rng.normal(0, 0.2, defs.shape).astype(np.float32)
        return {k: draw(defs[k]) for k in sorted(defs)}

    return draw(model_lib.model_defs(cfg))


def _make_inputs(path: Path) -> dict:
    from repro_torch.models import config as cfg_mod
    rng = np.random.default_rng(25)
    x = {}
    for d in GRID_DESIGNS:
        x[f"grid/{d}/a"] = rng.integers(-7, 8, (5, 37)).astype(np.int8)
        x[f"grid/{d}/b"] = rng.integers(-7, 8, (37, 23)).astype(np.int8)
    x["gqa/q"] = rng.normal(0, 1, (B, 1, H, D)).astype(np.float32)
    x["gqa/kc"] = rng.normal(0, 1, (B, S, KVH, D)).astype(np.float32)
    x["gqa/vc"] = rng.normal(0, 1, (B, S, KVH, D)).astype(np.float32)
    m = _mla_cfg(cfg_mod).mla
    x["mla/w_uk"] = rng.normal(0, 0.3, (m.kv_lora_rank, 4,
                                        m.nope_head_dim)).astype(np.float32)
    x["mla/w_uv"] = rng.normal(0, 0.3, (m.kv_lora_rank, 4,
                                        m.v_head_dim)).astype(np.float32)
    x["mla/qn"] = rng.normal(0, 1, (B, 1, 4, m.nope_head_dim)).astype(np.float32)
    x["mla/qr"] = rng.normal(0, 1, (B, 1, 4, m.rope_head_dim)).astype(np.float32)
    x["mla/ckv"] = rng.normal(0, 1, (B, S, m.kv_lora_rank)).astype(np.float32)
    x["mla/kr"] = rng.normal(0, 1, (B, S, m.rope_head_dim)).astype(np.float32)
    mc = _moe_cfg(cfg_mod)
    e, dm, f = mc.moe.num_experts, mc.d_model, mc.moe.d_ff_expert
    x["moe/router"] = rng.normal(0, 0.3, (dm, e)).astype(np.float32)
    x["moe/w_gate"] = rng.normal(0, 0.2, (e, dm, f)).astype(np.float32)
    x["moe/w_up"] = rng.normal(0, 0.2, (e, dm, f)).astype(np.float32)
    x["moe/w_down"] = rng.normal(0, 0.2, (e, f, dm)).astype(np.float32)
    x["moe/x"] = rng.normal(0, 1, (2, 16, dm)).astype(np.float32)
    x["moe/xa"] = rng.normal(0, 1, (2, 16, dm)).astype(np.float32)
    for i, arch in enumerate(STEP_ARCHS):
        cfg = _step_cfg(arch)
        for k, v in _flatten(_seeded_params(cfg, 100 + i)).items():
            x[f"steps/{arch}/params/{k}"] = v
        x[f"steps/{arch}/prompt"] = rng.integers(
            0, cfg.vocab_size, (STEP_BATCH, STEP_PROMPT)).astype(np.int32)
        x[f"steps/{arch}/tokens"] = rng.integers(
            0, cfg.vocab_size, (STEP_DECODES, STEP_BATCH, 1)).astype(np.int32)
    np.savez(path, **x)
    return x


# ---------------------------------------------------------------------------
# the port's side, on every rank (no jax)
# ---------------------------------------------------------------------------

def _t(x, dtype=None):
    t = torch.from_numpy(np.array(x))
    return t if dtype is None else t.to(dtype)


def _rank_grid(x, out):
    from repro_torch import backends
    for d in GRID_DESIGNS:
        a, b = _t(x[f"grid/{d}/a"]), _t(x[f"grid/{d}/b"])
        for gx, gy in GRIDS:
            be = backends.as_grid(backends.resolve(d, bits=BITS), gx, gy)
            codes = be.shard_codes(b)
            assert codes.owner is not None and len(codes.shards) == 1
            out[f"grid/{d}/{gx}x{gy}"] = be.execute(a, codes).numpy()


def _rank_engine(x, out, mesh_lib):
    from repro_torch import configs
    from repro_torch.models import common
    from repro_torch.models import model as model_lib
    from repro_torch.serving import (ServingEngine, TrafficConfig,
                                     generate_trace)
    cfg = configs.get_smoke_config("llama3-8b")
    gen = torch.Generator(device="cpu")
    gen.manual_seed(0)
    params = model_lib.init_params(cfg, gen, device="cpu")
    eng = ServingEngine(cfg, params, attention="fused", device="cpu",
                        grid=(2, 2), **ENGINE_KW)
    assert eng.mesh is not None and eng.mesh.distributed
    with common.activation_scaling("per-row"):
        rep = eng.run(generate_trace(TrafficConfig(**TRAFFIC)), "continuous")
    for rid, toks in rep.request_tokens.items():
        out[f"engine/{rid}"] = np.asarray(toks, np.int64)
    # every cached code block is this rank's own shard
    owner = eng.mesh.rank_coord
    assert all(wq.values.owner == owner and list(wq.values.shards) == [owner]
               for _, wq in eng.weight_cache.values())
    # a decode step whose ids differ across ranks raises on every rank
    ids = torch.full((4,), mesh_lib.rank(), dtype=torch.int32)
    try:
        eng._check_same_tokens(ids, 7)
        out["diverged"] = np.array("no error")
    except RuntimeError as exc:
        out["diverged"] = np.array(str(exc))


def _rank_decodes(x, out, mesh):
    from repro_torch.models import attention as A
    from repro_torch.models import config as cfg_mod
    r, n = mesh.axis_index("model"), mesh.axis_size("model")
    sl = slice(r * S // n, (r + 1) * S // n)
    q, kc, vc = _t(x["gqa/q"]), _t(x["gqa/kc"]), _t(x["gqa/vc"])
    with mesh:
        out["gqa"] = A._sharded_decode_attention(
            q, kc[:, sl], vc[:, sl], H, q_offset=POS, kv_valid_len=POS + 1,
            mesh=mesh).numpy()
    cfg = _mla_cfg(cfg_mod)
    params = {"w_uk": _t(x["mla/w_uk"]), "w_uv": _t(x["mla/w_uv"])}
    ctx = A._mla_sharded_decode(
        params, _t(x["mla/qn"]), _t(x["mla/qr"]), _t(x["mla/ckv"])[:, sl],
        _t(x["mla/kr"])[:, sl], cfg, q_offset=POS, kv_valid_len=POS + 1,
        mesh=mesh)
    out["mla"] = torch.einsum("bqhr,rhv->bqhv", ctx, params["w_uv"]).numpy()


def _rank_moe(x, out, mesh):
    from repro_torch.models import config as cfg_mod
    from repro_torch.models import moe as M
    cfg = _moe_cfg(cfg_mod)
    whole = {k: _t(x[f"moe/{k}"]) for k in ("router", "w_gate", "w_up",
                                             "w_down")}
    e_local = cfg.moe.num_experts // WORLD
    r = mesh.axis_index("model")
    own = {**whole, **{k: whole[k][r * e_local:(r + 1) * e_local].clone()
                       for k in M.EXPERT_LEAVES}}
    a2a = cfg.replace(moe=dataclasses.replace(cfg.moe, ep_impl="a2a"))
    with mesh:
        assert M.ep_shards(cfg) == WORLD
        out["moe/psum"], out["moe/psum_aux"] = (
            t.numpy() for t in M.moe_fwd(whole, _t(x["moe/x"]), cfg))
        out["moe/psum_own"] = M.moe_fwd(own, _t(x["moe/x"]), cfg)[0].numpy()
        out["moe/a2a"], out["moe/a2a_aux"] = (
            t.numpy() for t in M.moe_fwd(own, _t(x["moe/xa"]), a2a))
        out["moe/psum_xa"] = M.moe_fwd(own, _t(x["moe/xa"]), cfg)[0].numpy()


def _rank_steps(x, out, mesh):
    from repro_torch.launch import steps as steps_lib
    from repro_torch.models import model as model_lib
    for arch in STEP_ARCHS:
        cfg = _step_cfg(arch)
        flat = {k: v for k, v in x.items()
                if k.startswith(f"steps/{arch}/params/")}
        params = model_lib.params_from_numpy(
            _unflatten(flat, f"steps/{arch}/params/"), "cpu")
        params = model_lib.rank_params(params, cfg, mesh)
        caches = model_lib.init_caches(cfg, STEP_BATCH, STEP_MAX_LEN,
                                       torch.float32, "cpu", mesh=mesh)
        prefill = steps_lib.make_prefill_step(cfg, mesh, STEP_BATCH,
                                              STEP_MAX_LEN, params)
        decode = steps_lib.make_decode_step(cfg, mesh, STEP_BATCH,
                                            STEP_MAX_LEN, params)
        logits, caches = prefill(params, {"tokens": _t(
            x[f"steps/{arch}/prompt"])}, caches)
        outs = [logits[:, -1:]]
        for i in range(STEP_DECODES):
            logits, caches = decode(params, _t(x[f"steps/{arch}/tokens"][i]),
                                    caches, STEP_PROMPT + i)
            outs.append(logits)
        out[f"steps/{arch}"] = torch.cat(outs, dim=1).numpy()


def _rank_refusals(out, mesh_lib):
    for name, fn in (("mesh", lambda: mesh_lib.make_mesh((2, 1),
                                                         ("data", "model"),
                                                         "cpu")),
                     ("grid", lambda: mesh_lib.make_grid_mesh(3, 1, "cpu"))):
        try:
            fn()
            out[f"refused/{name}"] = np.array("no error")
        except ValueError as exc:
            out[f"refused/{name}"] = np.array(str(exc))


def _rank_cli(out):
    """``serve traffic --smoke --device cpu --grid 2,2`` on this rank (the
    process group stays up: the CLI reuses it, and tears it down last)."""
    from repro_torch.launch import serve
    os.environ.update(RANK=str(torch.distributed.get_rank()),
                      WORLD_SIZE=str(WORLD))
    out["cli_rc"] = np.array(serve.main([
        "traffic", "--smoke", "--device", "cpu", "--grid", "2,2",
        "--execute-backend", "tubgemm", "--act-scale", "per-row",
        "--requests", "4"]))


def _rank_main(rank: int, init_file: str, work: str) -> None:
    import torch.distributed as dist
    from repro_torch.launch import mesh as mesh_lib
    torch.set_num_threads(1)
    mesh_lib.init_distributed("cpu", init_method=f"file://{init_file}",
                              rank_=rank, world=WORLD, timeout_s=120)
    x = dict(np.load(os.path.join(work, "inputs.npz")))
    out: dict = {}
    _rank_grid(x, out)
    _rank_engine(x, out, mesh_lib)
    mesh = mesh_lib.make_mesh((1, WORLD), ("data", "model"), "cpu")
    _rank_decodes(x, out, mesh)
    _rank_moe(x, out, mesh)
    _rank_steps(x, out, mesh)
    _rank_refusals(out, mesh_lib)
    _rank_cli(out)                     # last: it destroys the process group
    assert not dist.is_initialized()
    np.savez(os.path.join(work, f"rank{rank}.npz"), **out)


# ---------------------------------------------------------------------------
# the reference's side, in its own process (4 fake XLA devices)
# ---------------------------------------------------------------------------

REF_SCRIPT = r"""
import dataclasses, os, sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
work, = sys.argv[1:]
x = dict(np.load(os.path.join(work, "inputs.npz")))
auto = jax.sharding.AxisType.Auto
def mesh_of(shape, axes):
    return jax.make_mesh(shape, axes, axis_types=(auto,) * len(shape))
from repro import backends
from repro.backends import grid as ref_grid
ref_grid.grid_mesh = lambda gx, gy: mesh_of((gx, gy), ("gx", "gy"))
from repro.models import attention as A, moe as M, model as model_lib
from repro.models import config as cfg_mod
from repro import configs
out = {}
for d in %(designs)r:
    a, b = jnp.asarray(x[f"grid/{d}/a"]), jnp.asarray(x[f"grid/{d}/b"])
    for gx, gy in %(grids)r:
        be = backends.as_grid(backends.resolve(d, bits=%(bits)d), gx, gy)
        out[f"grid/{d}/{gx}x{gy}"] = np.asarray(be.execute(a, b))
mesh = mesh_of((1, 4), ("data", "model"))
H = %(h)d; POS = %(pos)d
with mesh:
    kc = jax.device_put(jnp.asarray(x["gqa/kc"]), NamedSharding(mesh, P(None, "model")))
    vc = jax.device_put(jnp.asarray(x["gqa/vc"]), NamedSharding(mesh, P(None, "model")))
    out["gqa"] = np.asarray(A._sharded_decode_attention(
        jnp.asarray(x["gqa/q"]), kc, vc, H, q_offset=POS,
        kv_valid_len=POS + 1, mesh=mesh))
mcfg = cfg_mod.ModelConfig(d_model=32, num_heads=4, num_kv_heads=4, attention="mla",
    mla=cfg_mod.MLAConfig(q_lora_rank=16, kv_lora_rank=8, rope_head_dim=4,
                          nope_head_dim=8, v_head_dim=8))
params = {"w_uk": jnp.asarray(x["mla/w_uk"]), "w_uv": jnp.asarray(x["mla/w_uv"])}
with mesh:
    ckv = jax.device_put(jnp.asarray(x["mla/ckv"]), NamedSharding(mesh, P(None, "model")))
    kr = jax.device_put(jnp.asarray(x["mla/kr"]), NamedSharding(mesh, P(None, "model")))
    ctx = A._mla_sharded_decode(params, jnp.asarray(x["mla/qn"]),
        jnp.asarray(x["mla/qr"]), ckv, kr, mcfg, q_offset=POS,
        kv_valid_len=POS + 1, mesh=mesh)
    out["mla"] = np.asarray(jnp.einsum("bqhr,rhv->bqhv", ctx, params["w_uv"]))
ecfg = cfg_mod.ModelConfig(family="moe", d_model=32, d_ff=64, vocab_size=64,
    moe=cfg_mod.MoEConfig(num_experts=8, top_k=2, d_ff_expert=32, capacity_factor=8.0))
mp = {k: jnp.asarray(x[f"moe/{k}"]) for k in ("router", "w_gate", "w_up", "w_down")}
a2a = ecfg.replace(moe=dataclasses.replace(ecfg.moe, ep_impl="a2a"))
with mesh:
    o, aux = M.moe_fwd(mp, jnp.asarray(x["moe/x"]), ecfg)
    out["moe/psum"], out["moe/psum_aux"] = np.asarray(o), np.asarray(aux)
    o, aux = M.moe_fwd(mp, jnp.asarray(x["moe/xa"]), a2a)
    out["moe/a2a"], out["moe/a2a_aux"] = np.asarray(o), np.asarray(aux)
def unflatten(prefix):
    tree = {}
    for key, val in x.items():
        if key.startswith(prefix):
            node = tree
            *path, leaf = key[len(prefix):].split("/")
            for k in path:
                node = node.setdefault(k, {})
            node[leaf] = jnp.asarray(val)
    return tree
for arch in %(archs)r:
    cfg = configs.get_smoke_config(arch).replace(compute_dtype="float32")
    params = unflatten(f"steps/{arch}/params/")
    caches = model_lib.init_caches(cfg, %(batch)d, %(max_len)d, dtype=jnp.float32)
    logits, caches = model_lib.prefill(params, cfg, jnp.asarray(x[f"steps/{arch}/prompt"]),
                                       caches=caches)
    outs = [logits[:, -1:]]
    for i in range(%(decodes)d):
        logits, caches = model_lib.decode_step(params, cfg,
            jnp.asarray(x[f"steps/{arch}/tokens"][i]), caches=caches,
            cache_pos=%(prompt)d + i)
        outs.append(logits)
    out[f"steps/{arch}"] = np.asarray(jnp.concatenate(outs, axis=1))
np.savez(os.path.join(work, "ref.npz"), **out)
print("REF_DONE")
""" % dict(designs=GRID_DESIGNS, grids=GRIDS, bits=BITS, h=H, pos=POS,
           archs=STEP_ARCHS, batch=STEP_BATCH, max_len=STEP_MAX_LEN,
           decodes=STEP_DECODES, prompt=STEP_PROMPT)


# ---------------------------------------------------------------------------
# the run: ranks and reference side by side, once per module
# ---------------------------------------------------------------------------

def _one_process(x) -> dict:
    """The one-device counterparts, in this process."""
    from repro_torch import backends, configs
    from repro_torch.models import attention as A
    from repro_torch.models import common
    from repro_torch.models import config as cfg_mod
    from repro_torch.models import model as model_lib
    from repro_torch.models import moe as M
    from repro_torch.serving import (ServingEngine, TrafficConfig,
                                     generate_trace)
    out = {}
    for d in GRID_DESIGNS:
        out[f"grid/{d}"] = backends.resolve(d, bits=BITS).execute(
            _t(x[f"grid/{d}/a"]), _t(x[f"grid/{d}/b"])).numpy()
    out["gqa"] = A.naive_attention(
        _t(x["gqa/q"]), A._repeat_kv(_t(x["gqa/kc"]), H),
        A._repeat_kv(_t(x["gqa/vc"]), H), causal=True, q_offset=POS,
        kv_valid_len=torch.full((B,), POS + 1)).numpy()
    out["mla"] = A._mla_absorbed_attend(
        {"w_uk": _t(x["mla/w_uk"]), "w_uv": _t(x["mla/w_uv"])},
        _t(x["mla/qn"]), _t(x["mla/qr"]), _t(x["mla/ckv"]), _t(x["mla/kr"]),
        _mla_cfg(cfg_mod), torch.full((B,), POS + 1), q_offset=POS).numpy()
    mp = {k: _t(x[f"moe/{k}"]) for k in ("router", "w_gate", "w_up", "w_down")}
    out["moe/local"] = M.moe_fwd(mp, _t(x["moe/x"]),
                                 _moe_cfg(cfg_mod))[0].numpy()
    cfg = configs.get_smoke_config("llama3-8b")
    gen = torch.Generator(device="cpu")
    gen.manual_seed(0)
    params = model_lib.init_params(cfg, gen, device="cpu")
    trace = generate_trace(TrafficConfig(**TRAFFIC))
    for grid in ((2, 2), None):
        eng = ServingEngine(cfg, params, attention="fused", device="cpu",
                            grid=grid, **ENGINE_KW)
        with common.activation_scaling("per-row"):
            rep = eng.run(trace, "continuous")
        out[f"engine/{grid}"] = rep.request_tokens
    return out


@pytest.fixture(scope="module")
def mesh_run():
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory() as work:
        x = _make_inputs(Path(work) / "inputs.npz")
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
            one = _one_process(x)
            stdout, stderr = ref.communicate(timeout=RANK_TIMEOUT_S)
        finally:
            if ref.poll() is None:
                ref.kill()
        assert ref.returncode == 0 and "REF_DONE" in stdout, stderr[-3000:]
        ranks = [dict(np.load(os.path.join(work, f"rank{r}.npz")))
                 for r in range(WORLD)]
        refs = dict(np.load(os.path.join(work, "ref.npz")))
        yield {"x": x, "ranks": ranks, "ref": refs, "one": one}


def _same_on_every_rank(run, key):
    first = run["ranks"][0][key]
    for r, out in enumerate(run["ranks"][1:], 1):
        assert np.array_equal(out[key], first), \
            f"rank {r} differs from rank 0 at {key}"
    return first


@pytest.mark.parametrize("grid", GRIDS, ids=lambda g: f"{g[0]}x{g[1]}")
@pytest.mark.parametrize("design", GRID_DESIGNS)
def test_grid_across_ranks_is_bit_identical(mesh_run, design, grid):
    key = f"grid/{design}/{grid[0]}x{grid[1]}"
    got = _same_on_every_rank(mesh_run, key)
    ref = mesh_run["ref"][key]
    flat = mesh_run["one"][f"grid/{design}"]
    assert got.shape == flat.shape == ref.shape
    assert np.array_equal(got, ref.astype(got.dtype))
    assert np.array_equal(got, flat)


def test_grid_engine_streams_equal_one_process_and_flat(mesh_run):
    keys = sorted(k for k in mesh_run["ranks"][0] if k.startswith("engine/"))
    streams = {int(k.split("/")[1]): tuple(_same_on_every_rank(mesh_run, k))
               for k in keys}
    assert len(streams) == TRAFFIC["num_requests"]
    assert streams == mesh_run["one"]["engine/(2, 2)"]
    assert streams == mesh_run["one"]["engine/None"]


def test_grid_traffic_cli_passes_on_every_rank(mesh_run):
    assert [int(r["cli_rc"]) for r in mesh_run["ranks"]] == [0] * WORLD


def test_diverged_decode_step_raises_on_every_rank(mesh_run):
    for r, out in enumerate(mesh_run["ranks"]):
        msg = str(out["diverged"])
        assert msg.startswith(f"rank {r}: decode step 7") and "diverged" in msg


@pytest.mark.parametrize("what", ("gqa", "mla"))
def test_sharded_decode_matches_reference_and_one_device(mesh_run, what):
    got = _same_on_every_rank(mesh_run, what)
    assert float(np.abs(got - mesh_run["ref"][what]).max()) <= 1e-5
    assert float(np.abs(got - mesh_run["one"][what]).max()) <= 1e-5


def test_ep_psum_matches_reference_and_local(mesh_run):
    got = _same_on_every_rank(mesh_run, "moe/psum")
    assert float(np.abs(got - mesh_run["ref"]["moe/psum"]).max()) <= 1e-4
    assert float(np.abs(got - mesh_run["one"]["moe/local"]).max()) <= 1e-4
    # the rank's own expert slice gives what slicing the whole stacks gives
    assert np.array_equal(_same_on_every_rank(mesh_run, "moe/psum_own"), got)
    assert float(np.abs(_same_on_every_rank(mesh_run, "moe/psum_aux")
                        - mesh_run["ref"]["moe/psum_aux"])) <= 1e-6


def test_ep_a2a_matches_psum_and_reference(mesh_run):
    got = _same_on_every_rank(mesh_run, "moe/a2a")
    psum = _same_on_every_rank(mesh_run, "moe/psum_xa")
    assert float(np.abs(got - psum).max()) <= 1e-4
    assert float(np.abs(got - mesh_run["ref"]["moe/a2a"]).max()) <= 1e-4
    assert float(np.abs(_same_on_every_rank(mesh_run, "moe/a2a_aux")
                        - mesh_run["ref"]["moe/a2a_aux"])) <= 1e-6


@pytest.mark.parametrize("arch", STEP_ARCHS)
def test_step_builders_on_a_model_mesh_match_reference(mesh_run, arch):
    got = _same_on_every_rank(mesh_run, f"steps/{arch}")
    ref = mesh_run["ref"][f"steps/{arch}"]
    assert got.shape == ref.shape == (STEP_BATCH, 1 + STEP_DECODES, 512)
    scale = float(np.abs(ref).max())
    assert float(np.abs(got - ref).max()) <= 1e-4 * scale


@pytest.mark.parametrize("what", ("mesh", "grid"))
def test_mesh_of_another_size_than_the_world_raises(mesh_run, what):
    for out in mesh_run["ranks"]:
        assert "positions but the process group has 4 ranks" in \
            str(out[f"refused/{what}"])


def test_multi_position_mesh_without_a_process_group_raises():
    from repro_torch.launch import mesh as mesh_lib
    assert not mesh_lib.distributed() and mesh_lib.grid_mesh(2, 2) is None
    with pytest.raises(RuntimeError, match="torchrun --nproc-per-node 4"):
        mesh_lib.make_mesh((1, 4), ("data", "model"), "cpu")
    with pytest.raises(NotImplementedError, match="256 positions"):
        mesh_lib.make_production_mesh()


def test_expert_offset_and_sigmoid_scoring_match_reference():
    """``_local_expert_pass``'s ``first_global_expert`` (a rank's experts
    4..7 of 8) and ``moe_fwd(scoring="sigmoid")``, on one device, against
    the reference's."""
    import jax.numpy as jnp
    from repro.models import config as ref_cfg_mod
    from repro.models import moe as ref_moe
    from repro_torch.models import config as cfg_mod
    from repro_torch.models import moe as M
    rng = np.random.default_rng(7)
    cfg, ref_cfg = _moe_cfg(cfg_mod), _moe_cfg(ref_cfg_mod)
    e, dm, f = cfg.moe.num_experts, cfg.d_model, cfg.moe.d_ff_expert
    p = {"router": rng.normal(0, 0.3, (dm, e)),
         "w_gate": rng.normal(0, 0.2, (e, dm, f)),
         "w_up": rng.normal(0, 0.2, (e, dm, f)),
         "w_down": rng.normal(0, 0.2, (e, f, dm))}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    x = rng.normal(0, 1, (2, 12, dm)).astype(np.float32)
    xf = x.reshape(-1, dm)
    idx, w, _ = M._routing(_t(p["router"]), _t(xf), cfg)
    got = M._local_expert_pass(_t(xf), idx, w, *(_t(p[k][4:]) for k in
                               M.EXPERT_LEAVES), cfg, 4)
    want = ref_moe._local_expert_pass(
        jnp.asarray(xf), jnp.asarray(idx.numpy()), jnp.asarray(w.numpy()),
        *(jnp.asarray(p[k][4:]) for k in M.EXPERT_LEAVES), ref_cfg, 4)
    assert float(np.abs(got.numpy() - np.asarray(want)).max()) <= 1e-5
    out, aux = M.moe_fwd({k: _t(v) for k, v in p.items()}, _t(x), cfg,
                         scoring="sigmoid")
    r_out, r_aux = ref_moe.moe_fwd({k: jnp.asarray(v) for k, v in p.items()},
                                   jnp.asarray(x), ref_cfg, scoring="sigmoid")
    assert float(np.abs(out.numpy() - np.asarray(r_out)).max()) <= 1e-5
    assert abs(float(aux) - float(r_aux)) <= 1e-5
