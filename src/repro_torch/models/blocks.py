"""Layer blocks and layer stacking for every architecture family.

Families:
  dense / moe / audio / vlm : pre-norm attention (GQA or MLA) +
                              (MLP | MoE) blocks
  ssm (cfg.ssm set)         : Mamba2 blocks
  ssm (cfg.rwkv set)        : RWKV6 blocks
  hybrid                    : Mamba2 backbone with a *shared* attention+MLP
                              block applied after every
                              ``hybrid_attn_every`` layers (Zamba2-style),
                              then the remaining tail layers

All per-layer parameters are stacked with a leading ``layers`` axis — the
reference's layout, so converting its parameter tree is a plain copy — and
consumed by a Python loop over that axis (the reference scans it).
``torch.utils.checkpoint`` wraps each layer when cfg.remat (training).
"""

from __future__ import annotations

import dataclasses

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.backends.runtime import site_scope
from repro_torch.core import packing
from repro_torch.models import attention as attn_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models import rwkv as rwkv_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.common import ParamDef, materialize, rmsnorm, tp_of
from repro_torch.models.config import ModelConfig
from repro_torch.models.mlp import mlp_defs, mlp_fwd

__all__ = ["layer_defs", "stacked_layer_defs", "shared_attn_defs",
           "stack_fwd", "init_layer_caches", "hybrid_counts", "layer_slice"]


def layer_defs(cfg: ModelConfig) -> dict:
    """ParamDefs for ONE layer of the given family."""
    if cfg.family == "hybrid" or (cfg.family == "ssm" and cfg.ssm is not None):
        return {"ln": ParamDef((cfg.d_model,), ("embed",), init="ones"),
                "ssm": ssm_lib.ssm_defs(cfg)}
    if cfg.family == "ssm" and cfg.rwkv is not None:
        return rwkv_lib.rwkv_defs(cfg)
    # attention transformer
    defs = {
        "ln1": ParamDef((cfg.d_model,), ("embed",), init="ones"),
        "attn": attn_lib.attention_defs(cfg),
        "ln2": ParamDef((cfg.d_model,), ("embed",), init="ones"),
    }
    if cfg.is_moe:
        defs["moe"] = moe_lib.moe_defs(cfg)
    else:
        defs["mlp"] = mlp_defs(cfg)
    return defs


def shared_attn_defs(cfg: ModelConfig) -> dict:
    """Zamba2 shared attention+MLP block (one copy, applied at many sites)."""
    return {
        "ln1": ParamDef((cfg.d_model,), ("embed",), init="ones"),
        "attn": attn_lib.gqa_defs(cfg),
        "ln2": ParamDef((cfg.d_model,), ("embed",), init="ones"),
        "mlp": mlp_defs(cfg),
    }


def hybrid_counts(cfg: ModelConfig) -> tuple[int, int, int]:
    """(n_groups, group_size, remainder) of the hybrid stack."""
    every = cfg.hybrid_attn_every
    return cfg.num_layers // every, every, cfg.num_layers % every


def _map_defs(fn, defs):
    if isinstance(defs, ParamDef):
        return fn(defs)
    return {k: _map_defs(fn, v) for k, v in defs.items()}


def _stack_def(d: ParamDef, n: int) -> ParamDef:
    return dataclasses.replace(
        d, shape=(n, *d.shape), logical=("layers", *d.axes),
        fan_in_axes=tuple(a + 1 for a in d.fan_in_axes))


def stacked_layer_defs(cfg: ModelConfig, n: int | None = None) -> dict:
    n = cfg.num_layers if n is None else n
    return _map_defs(lambda d: _stack_def(d, n), layer_defs(cfg))


def layer_slice(stacked, i: int):
    """Layer ``i``'s view of a stacked (L, ...) tree (no copy)."""
    if isinstance(stacked, dict):
        return {k: layer_slice(v, i) for k, v in stacked.items()}
    return stacked[i]


def _unstack(stacked, n: int) -> list:
    """Every layer's view of a stacked (L, ...) tree, cut by one ``unbind``
    per leaf (no copy).  Under autograd the stacked leaf then receives one
    stacked gradient, where ``n`` separate slices would each backpropagate
    a zero-filled full-size gradient to be summed."""
    if isinstance(stacked, dict):
        per_key = {k: _unstack(v, n) for k, v in stacked.items()}
        return [{k: per_key[k][i] for k in stacked} for i in range(n)]
    if packing.is_packed(stacked):      # a frozen store: no gradient
        return [stacked[i] for i in range(n)]
    return torch.unbind(stacked[:n], 0)


def _transformer_block(layer_params, x, cfg: ModelConfig, *, positions,
                       cache, cache_pos, kv_valid_len, sh=None, serving=None,
                       layer: int = 0):
    specs = None if sh is None else sh.layer_specs
    layer_params = materialize(layer_params, specs, sh,
                               cached=cache is not None)
    h = rmsnorm(layer_params["ln1"], x, cfg.rms_eps)
    with site_scope("attn"):
        attn_out, new_cache = attn_lib.attention_fwd(
            layer_params["attn"], h, cfg, positions=positions, cache=cache,
            cache_pos=cache_pos, kv_valid_len=kv_valid_len,
            tp=_tp(sh, specs, "attn"))
    x = x + attn_out
    h = rmsnorm(layer_params["ln2"], x, cfg.rms_eps)
    if cfg.is_moe and serving is not None:
        with site_scope("moe"):
            out = moe_lib.moe_serve(layer_params["moe"], h, cfg, serving,
                                    layer)
            aux = None
    elif cfg.is_moe:
        with site_scope("moe"):
            out, aux = moe_lib.moe_fwd(layer_params["moe"], h, cfg, sh=sh)
    else:
        with site_scope("mlp"):
            out = mlp_fwd(layer_params["mlp"], h, cfg,
                          tp=_tp(sh, specs, "mlp"))
            aux = None
    return x + out, new_cache, aux


def _tp(sh, specs, module: str):
    """``tp=`` of an attention or MLP ``module`` with pspecs
    ``specs[module]``: whether its heads (``wo``'s first dimension) or
    hidden units (``w_up``'s last) are split over ``model``."""
    if sh is None:
        return None
    if module == "attn":
        return tp_of(sh, specs["attn"]["wo"][0])
    return tp_of(sh, specs[module]["w_up"][-1])


def _mamba_block(layer_params, x, cfg: ModelConfig, *, cache):
    h = rmsnorm(layer_params["ln"], x, cfg.rms_eps)
    with site_scope("ssm"):
        out, new_cache = ssm_lib.ssm_fwd(layer_params["ssm"], h, cfg,
                                         cache=cache)
    return x + out, new_cache


def _recurrent_layer(block, lp, x, cfg: ModelConfig, caches, i: int,
                     remat: bool, sh=None):
    """Layer ``i`` of a recurrent stack (``block``: Mamba2 or RWKV6).

    With ``caches`` (the stacked recurrent caches) the layer reads its slice
    and writes the new state, conv tails / token-shift buffers back into it
    with ``copy_``; without, ``remat`` checkpoints it.
    """
    specs = None if sh is None else sh.layer_specs

    def run(lp, x):
        with site_scope("layers"):
            return block(materialize(lp, specs, sh), x, cfg, cache=None)[0]

    if caches is None:
        return (checkpoint(run, lp, x, use_reentrant=False) if remat
                else run(lp, x))
    lc = layer_slice(caches, i)
    with site_scope("layers"):
        x, new = block(materialize(lp, specs, sh, cached=True), x, cfg,
                       cache=lc)
    for key, val in new.items():
        lc[key].copy_(val)
    return x


def stack_fwd(params: dict, x: torch.Tensor, cfg: ModelConfig, *,
              positions, caches: dict | None = None, cache_pos=0,
              kv_valid_len=None, sh=None, serving=None):
    """Run the full layer stack.  Returns (x, new_caches, aux_loss).

    ``params`` holds "layers" (stacked) and, for the hybrid, "shared".
    ``caches`` is ``{"attn": {"k": (L,B,S,KVH,hd), "v": ...}}`` (MLA:
    ``{"ckv": (L,B,S,rank), "krope": (L,B,S,rd)}``; Mamba2 ``{"ssm":
    {"state", "conv_x", "conv_bc"}}``; RWKV6 ``{"rwkv": {"state",
    "tm_last", "cm_last"}}``; the hybrid ``{"ssm": ..., "attn": ...}`` with
    one KV slice per shared-block application); each layer writes its slice
    **in place**, so the returned caches are the tensors that were passed
    in.  ``aux_loss`` is the float32 sum over layers of the MoE
    load-balance loss (0 for every other family), added in layer order as
    the reference's scan carries it.  ``sh``: the rank's
    :class:`~repro_torch.models.common.Sharding` (``params`` its slices),
    or None.  ``serving``: a :class:`~repro_torch.models.moe.Serving` —
    an MoE stack's layers then run the serving expert layer
    (``moe.moe_serve``, the serving engine's prefill) in place of
    ``moe_fwd``; None elsewhere.
    """
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.family == "hybrid":
        x = _hybrid_fwd(params, x, cfg, positions=positions, caches=caches,
                        cache_pos=cache_pos, kv_valid_len=kv_valid_len, sh=sh)
        return x, caches, zero
    if cfg.family == "ssm":
        key, block = (("rwkv", rwkv_lib.rwkv_block_fwd) if cfg.rwkv is not None
                      else ("ssm", _mamba_block))
        lc = caches[key] if caches is not None else None
        remat = cfg.remat and lc is None and torch.is_grad_enabled()
        for i, lp in enumerate(_unstack(params["layers"], cfg.num_layers)):
            x = _recurrent_layer(block, lp, x, cfg, lc, i, remat, sh)
        return x, caches, zero

    # attention transformer (dense / moe / audio / vlm)
    lc = caches["attn"] if caches is not None else None

    def layer(lp, x, cache, i=0):
        with site_scope("layers"):
            out, _, aux = _transformer_block(
                lp, x, cfg, positions=positions, cache=cache,
                cache_pos=cache_pos, kv_valid_len=kv_valid_len, sh=sh,
                serving=serving, layer=i)
        return out, aux

    remat = cfg.remat and lc is None and torch.is_grad_enabled()
    aux = zero
    for i, lp in enumerate(_unstack(params["layers"], cfg.num_layers)):
        if remat:
            x, a = checkpoint(layer, lp, x, None, use_reentrant=False)
        else:
            x, a = layer(lp, x, None if lc is None else layer_slice(lc, i), i)
        if a is not None:
            aux = aux + a
    return x, caches, aux


def _hybrid_fwd(params, x, cfg: ModelConfig, *, positions, caches, cache_pos,
                kv_valid_len, sh=None):
    """[group_size Mamba2 layers + the shared block] x n_groups + tail.

    The shared block's one weight copy runs at every group's end, with the
    group's own KV-cache slice; only the Mamba2 layers are rematerialized
    (the reference checkpoints its Mamba2 scan body alone).
    """
    n_groups, gsize, _ = hybrid_counts(cfg)
    specs = None if sh is None else sh.specs["shared"]
    shared = materialize(params["shared"], specs, sh,
                         cached=caches is not None)
    ssm_c = caches["ssm"] if caches is not None else None
    attn_c = caches["attn"] if caches is not None else None
    remat = cfg.remat and caches is None and torch.is_grad_enabled()
    layers = _unstack(params["layers"], cfg.num_layers)
    for g in range(n_groups):
        for i in range(g * gsize, (g + 1) * gsize):
            x = _recurrent_layer(_mamba_block, layers[i], x, cfg, ssm_c, i,
                                 remat, sh)
        h = rmsnorm(shared["ln1"], x, cfg.rms_eps)
        with site_scope("shared"), site_scope("attn"):
            attn_out, _ = attn_lib.attention_fwd(
                shared["attn"], h, cfg, positions=positions,
                cache=None if attn_c is None else layer_slice(attn_c, g),
                cache_pos=cache_pos, kv_valid_len=kv_valid_len,
                tp=_tp(sh, specs, "attn"))
        x = x + attn_out
        h = rmsnorm(shared["ln2"], x, cfg.rms_eps)
        with site_scope("shared"), site_scope("mlp"):
            x = x + mlp_fwd(shared["mlp"], h, cfg, tp=_tp(sh, specs, "mlp"))
    for i in range(n_groups * gsize, cfg.num_layers):
        x = _recurrent_layer(_mamba_block, layers[i], x, cfg, ssm_c, i,
                             remat, sh)
    return x


def init_layer_caches(cfg: ModelConfig, batch: int, max_len: int,
                      dtype: torch.dtype = torch.bfloat16,
                      device="cuda") -> dict:
    """Stacked caches matching stack_fwd's expectations: one layer's cache
    (:func:`attention.init_kv_cache`, :func:`ssm.init_ssm_cache`,
    :func:`rwkv.init_rwkv_cache`) with a leading ``layers`` axis; the
    recurrent states stay float32 whatever ``dtype``."""
    def stack(one, n):
        return {k: torch.zeros((n, *v.shape), dtype=v.dtype, device=device)
                for k, v in one.items()}

    def kv():
        return attn_lib.init_kv_cache(cfg, batch, max_len, dtype, device="meta")

    def ssm():
        return ssm_lib.init_ssm_cache(cfg, batch, dtype, device="meta")

    if cfg.family == "hybrid":
        return {"ssm": stack(ssm(), cfg.num_layers),
                "attn": stack(kv(), hybrid_counts(cfg)[0])}
    if cfg.family == "ssm" and cfg.rwkv is not None:
        return {"rwkv": stack(rwkv_lib.init_rwkv_cache(cfg, batch, dtype,
                                                       device="meta"),
                              cfg.num_layers)}
    if cfg.family == "ssm":
        return {"ssm": stack(ssm(), cfg.num_layers)}
    return {"attn": stack(kv(), cfg.num_layers)}
