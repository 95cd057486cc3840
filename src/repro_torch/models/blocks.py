"""Layer blocks and layer stacking for the attention-transformer families.

Families: dense / moe / audio / vlm — pre-norm attention (GQA or MLA) +
(MLP | MoE) blocks.  All per-layer parameters are stacked with a leading
``layers`` axis — the reference's layout, so converting its parameter tree
is a plain copy — and consumed by a Python loop over that axis (the
reference scans it).  The recurrent families (SSM, RWKV and the hybrid
stack) are not ported yet (ROADMAP Queue 1 item 8b).
"""

from __future__ import annotations

import dataclasses

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.backends.runtime import site_scope
from repro_torch.core import packing
from repro_torch.models import attention as attn_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models.common import ParamDef, rmsnorm
from repro_torch.models.config import ModelConfig
from repro_torch.models.mlp import mlp_defs, mlp_fwd

__all__ = ["layer_defs", "stacked_layer_defs", "stack_fwd",
           "init_layer_caches", "layer_slice"]


def _check_family(cfg: ModelConfig) -> None:
    if cfg.ssm is not None or cfg.rwkv is not None or cfg.family == "hybrid":
        raise NotImplementedError(
            f"family={cfg.family!r} (recurrent state) is not ported yet: "
            f"ROADMAP Queue 1 item 8b")


def layer_defs(cfg: ModelConfig) -> dict:
    """ParamDefs for ONE layer."""
    _check_family(cfg)
    defs = {
        "ln1": ParamDef((cfg.d_model,), init="ones"),
        "attn": attn_lib.attention_defs(cfg),
        "ln2": ParamDef((cfg.d_model,), init="ones"),
    }
    if cfg.is_moe:
        defs["moe"] = moe_lib.moe_defs(cfg)
    else:
        defs["mlp"] = mlp_defs(cfg)
    return defs


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
    if cfg.is_moe:
        with site_scope("moe"):
            out, aux = moe_lib.moe_fwd(layer_params["moe"], h, cfg)
    else:
        with site_scope("mlp"):
            out, aux = mlp_fwd(layer_params["mlp"], h, cfg), None
    return x + out, new_cache, aux


def stack_fwd(params: dict, x: torch.Tensor, cfg: ModelConfig, *,
              positions, caches: dict | None = None, cache_pos=0,
              kv_valid_len=None):
    """Run the full layer stack.  Returns (x, new_caches, aux_loss).

    ``caches`` is ``{"attn": {"k": (L,B,S,KVH,hd), "v": ...}}`` (MLA:
    ``{"ckv": (L,B,S,rank), "krope": (L,B,S,rd)}``); each layer writes its
    slice **in place**, so the returned caches are the tensors that were
    passed in.  ``aux_loss`` is the float32 sum over layers of the MoE
    load-balance loss (0 for the dense family), added in layer order as the
    reference's scan carries it.
    """
    _check_family(cfg)
    lc = caches["attn"] if caches is not None else None

    def layer(lp, x, cache):
        with site_scope("layers"):
            out, _, aux = _transformer_block(
                lp, x, cfg, positions=positions, cache=cache,
                cache_pos=cache_pos, kv_valid_len=kv_valid_len)
        return out, aux

    remat = cfg.remat and lc is None and torch.is_grad_enabled()
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, lp in enumerate(_unstack(params["layers"], cfg.num_layers)):
        if remat:
            x, a = checkpoint(layer, lp, x, None, use_reentrant=False)
        else:
            x, a = layer(lp, x, None if lc is None else layer_slice(lc, i))
        if a is not None:
            aux = aux + a
    return x, caches, aux


def init_layer_caches(cfg: ModelConfig, batch: int, max_len: int,
                      dtype: torch.dtype = torch.bfloat16,
                      device="cuda") -> dict:
    """Stacked caches matching stack_fwd's expectations: one layer's
    :func:`attention.init_kv_cache` with a leading ``layers`` axis."""
    _check_family(cfg)
    one = attn_lib.init_kv_cache(cfg, batch, max_len, dtype, device="meta")
    return {"attn": {k: torch.zeros((cfg.num_layers, *v.shape), dtype=dtype,
                                    device=device) for k, v in one.items()}}
