"""GQA/MQA/MHA attention: full-sequence prefill and cached decode.

The contiguous KV cache is updated **in place** (the reference's functional
``dynamic_update_slice`` becomes an index write into the tensor it was
handed); callers that need the old cache must clone it first.  MLA and the
blockwise / flash prefill paths are not ported yet.
"""

from __future__ import annotations

import math

import torch

from repro_torch.models import rope as rope_lib
from repro_torch.models.common import ParamDef, dense
from repro_torch.models.config import ModelConfig

__all__ = ["gqa_defs", "attention_defs", "init_kv_cache", "attention_fwd",
           "naive_attention"]

_MASK = -1e30


def gqa_defs(cfg: ModelConfig) -> dict:
    d, h, kvh, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    return {
        "wq": ParamDef((d, h, hd)),
        "wk": ParamDef((d, kvh, hd)),
        "wv": ParamDef((d, kvh, hd)),
        "wo": ParamDef((h, hd, d), fan_in_axes=(0, 1)),
    }


def attention_defs(cfg: ModelConfig) -> dict:
    if cfg.attention != "gqa":
        raise NotImplementedError(
            f"attention={cfg.attention!r} is not ported yet (GQA only)")
    return gqa_defs(cfg)


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int,
                  dtype: torch.dtype = torch.bfloat16, device="cuda") -> dict:
    """Zeroed cache dict for one attention layer-instance."""
    kvh, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    return {
        "k": torch.zeros((batch, max_len, kvh, hd), dtype=dtype, device=device),
        "v": torch.zeros((batch, max_len, kvh, hd), dtype=dtype, device=device),
    }


def naive_attention(q, k, v, *, causal: bool, q_offset=0,
                    kv_valid_len=None) -> torch.Tensor:
    """q: (B,Sq,H,D), k/v: (B,Skv,H,D) -> (B,Sq,H,Dv).  f32 softmax.

    Scores are taken in the operands' dtype, cast to float32, divided by
    ``sqrt(D)``, masked with ``-1e30``; the softmax weights are cast to
    ``v.dtype`` before the V product.
    """
    d = q.shape[-1]
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).to(torch.float32)
    scores = scores / math.sqrt(d)
    sq, sk = q.shape[1], k.shape[1]
    dev = q.device
    mask = None
    if causal:
        qpos = torch.arange(sq, device=dev)[:, None] + q_offset
        kpos = torch.arange(sk, device=dev)[None, :]
        mask = qpos >= kpos
    if kv_valid_len is not None:
        valid_len = torch.as_tensor(kv_valid_len, device=dev).reshape(-1, 1)
        valid = torch.arange(sk, device=dev)[None, :] < valid_len
        valid = valid[:, None, None, :]  # (B,1,1,Sk)
        mask = valid if mask is None else (mask[None, None] & valid)
    elif mask is not None:
        mask = mask[None, None]
    if mask is not None:
        scores = torch.where(mask, scores,
                             torch.full((), _MASK, dtype=scores.dtype,
                                        device=dev))
    w = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", w.to(v.dtype), v)


def _repeat_kv(kv: torch.Tensor, h: int) -> torch.Tensor:
    kvh = kv.shape[2]
    if kvh == h:
        return kv
    return torch.repeat_interleave(kv, h // kvh, dim=2)


def _update_cache(cache_arr: torch.Tensor, new: torch.Tensor, pos) -> torch.Tensor:
    """Write ``new`` (B, S_new, ...) into the seq axis at ``pos`` — in place."""
    pos = int(pos)
    cache_arr[:, pos: pos + new.shape[1]] = new.to(cache_arr.dtype)
    return cache_arr


def attention_fwd(params: dict, x: torch.Tensor, cfg: ModelConfig, *,
                  positions: torch.Tensor, cache: dict | None = None,
                  cache_pos=0, kv_valid_len=None):
    """Returns (out (B,S,D), new_cache_or_None)."""
    if cfg.attention != "gqa":
        raise NotImplementedError(
            f"attention={cfg.attention!r} is not ported yet (GQA only)")
    return _gqa_fwd(params, x, cfg, positions=positions, cache=cache,
                    cache_pos=cache_pos, kv_valid_len=kv_valid_len)


def _gqa_fwd(params, x, cfg, *, positions, cache, cache_pos, kv_valid_len):
    h = cfg.num_heads
    q = dense(params["wq"], x, cfg, name="wq")         # (B,S,H,hd)
    k = dense(params["wk"], x, cfg, name="wk")         # (B,S,KVH,hd)
    v = dense(params["wv"], x, cfg, name="wv")
    q = rope_lib.apply_rope(q, positions, cfg.rope_theta)
    k = rope_lib.apply_rope(k, positions, cfg.rope_theta)

    new_cache = None
    if cache is not None:
        kc = _update_cache(cache["k"], k, cache_pos)
        vc = _update_cache(cache["v"], v, cache_pos)
        new_cache = {"k": kc, "v": vc}
        k_full = _repeat_kv(kc.to(q.dtype), h)
        v_full = _repeat_kv(vc.to(q.dtype), h)
        out = naive_attention(q, k_full, v_full, causal=True,
                              q_offset=cache_pos, kv_valid_len=kv_valid_len)
    else:
        out = naive_attention(q, _repeat_kv(k, h), _repeat_kv(v, h),
                              causal=True)
    return _out_proj(params, out, cfg), new_cache


def _out_proj(params, attn_out, cfg):
    """(B,S,H,hd) x (H,hd,D) -> (B,S,D).

    Under a backend scope the contraction is routed through ``dense`` as the
    flattened (H*hd, D) GEMM so the output projection is a site
    (``…/attn/wo``) and contracts on the scoped engine; the float path keeps
    the einsum.
    """
    wo = params["wo"]
    from repro_torch.backends import runtime as backend_runtime
    if backend_runtime.active_execution() is not None:
        h, hd, d = wo.shape
        x2 = attn_out.reshape(*attn_out.shape[:-2], h * hd)
        return dense(wo.reshape(h * hd, d), x2, cfg, name="wo")
    return torch.einsum("bshd,hde->bse", attn_out, wo.to(attn_out.dtype))
