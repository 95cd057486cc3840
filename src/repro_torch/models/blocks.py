"""Layer blocks and layer stacking for the dense transformer family.

All per-layer parameters are stacked with a leading ``layers`` axis — the
reference's layout, so converting its parameter tree is a plain copy — and
consumed by a Python loop over that axis (the reference scans it).  MoE,
SSM, RWKV and hybrid stacks are not ported yet.
"""

from __future__ import annotations

import dataclasses

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.backends.runtime import site_scope
from repro_torch.core import packing
from repro_torch.models import attention as attn_lib
from repro_torch.models.common import ParamDef, rmsnorm
from repro_torch.models.config import ModelConfig
from repro_torch.models.mlp import mlp_defs, mlp_fwd

__all__ = ["layer_defs", "stacked_layer_defs", "stack_fwd",
           "init_layer_caches", "layer_slice"]


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in ("dense", "audio", "vlm") or cfg.is_moe \
            or cfg.ssm is not None or cfg.rwkv is not None:
        raise NotImplementedError(
            f"family={cfg.family!r} is not ported yet (dense GQA "
            f"transformers only)")


def layer_defs(cfg: ModelConfig) -> dict:
    """ParamDefs for ONE layer."""
    _check_family(cfg)
    return {
        "ln1": ParamDef((cfg.d_model,), init="ones"),
        "attn": attn_lib.attention_defs(cfg),
        "ln2": ParamDef((cfg.d_model,), init="ones"),
        "mlp": mlp_defs(cfg),
    }


def _map_defs(fn, defs):
    if isinstance(defs, ParamDef):
        return fn(defs)
    return {k: _map_defs(fn, v) for k, v in defs.items()}


def _stack_def(d: ParamDef, n: int) -> ParamDef:
    return dataclasses.replace(
        d, shape=(n, *d.shape),
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
                       cache, cache_pos, kv_valid_len):
    h = rmsnorm(layer_params["ln1"], x, cfg.rms_eps)
    with site_scope("attn"):
        attn_out, new_cache = attn_lib.attention_fwd(
            layer_params["attn"], h, cfg, positions=positions, cache=cache,
            cache_pos=cache_pos, kv_valid_len=kv_valid_len)
    x = x + attn_out
    h = rmsnorm(layer_params["ln2"], x, cfg.rms_eps)
    with site_scope("mlp"):
        out = mlp_fwd(layer_params["mlp"], h, cfg)
    return x + out, new_cache


def stack_fwd(params: dict, x: torch.Tensor, cfg: ModelConfig, *,
              positions, caches: dict | None = None, cache_pos=0,
              kv_valid_len=None):
    """Run the full layer stack.  Returns (x, new_caches, aux_loss).

    ``caches`` is ``{"attn": {"k": (L,B,S,KVH,hd), "v": ...}}``; each layer
    writes its slice **in place**, so the returned caches are the tensors
    that were passed in.
    """
    _check_family(cfg)
    lc = caches["attn"] if caches is not None else None

    def layer(lp, x, cache):
        with site_scope("layers"):
            return _transformer_block(
                lp, x, cfg, positions=positions, cache=cache,
                cache_pos=cache_pos, kv_valid_len=kv_valid_len)[0]

    remat = cfg.remat and lc is None and torch.is_grad_enabled()
    for i, lp in enumerate(_unstack(params["layers"], cfg.num_layers)):
        if remat:
            x = checkpoint(layer, lp, x, None, use_reentrant=False)
        else:
            x = layer(lp, x, None if lc is None else layer_slice(lc, i))
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x, caches, aux


def init_layer_caches(cfg: ModelConfig, batch: int, max_len: int,
                      dtype: torch.dtype = torch.bfloat16,
                      device="cuda") -> dict:
    """Stacked caches matching stack_fwd's expectations."""
    _check_family(cfg)
    kvh, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    shape = (cfg.num_layers, batch, max_len, kvh, hd)
    return {"attn": {"k": torch.zeros(shape, dtype=dtype, device=device),
                     "v": torch.zeros(shape, dtype=dtype, device=device)}}
