"""Attention: GQA/MQA/MHA and MLA (DeepSeek), full-sequence and cached.

The contiguous KV cache is updated **in place** (the reference's functional
``dynamic_update_slice`` becomes an index write into the tensor it was
handed); callers that need the old cache must clone it first.  The no-cache
path dispatches like the reference's ``_mixed_attention``: on the card the
hand-written flash kernels (:mod:`repro_torch.kernels.flash_attention`), on
the CPU blockwise attention above ``BLOCKWISE_THRESHOLD`` and naive below.

MLA keeps the compressed latent (``ckv``, ``krope``) as its cache and
attends in the absorbed form (``W_uk`` folded into the query, ``W_uv``
applied to the latent context) at every cached call, prefill and decode
alike, so no per-head K/V is materialized there.  Without a cache it
materializes per-head K (q/k head dim ``nope + rope``) and V (``v_head_dim``)
and runs the flash kernels.  ``w_uk`` / ``w_uv`` are dense sites on the
no-cache path and plain einsums in the absorbed form, as in the reference.

**Sequence-sharded caches.**  Under a distributed mesh
(``launch.mesh``, ``with mesh:``) with a ``model`` axis above 1 and
``cfg.dp_over_model`` off, each ``model`` rank holds the slice
``[r * s_local, (r + 1) * s_local)`` of every cache's sequence axis
(:func:`seq_shards`; ``models.model.init_caches`` builds it).  A one-token
decode then runs flash-decoding across the ranks
(:func:`_sharded_decode_attention`, :func:`_mla_sharded_decode`): shard-local
``(max, sum, context)`` combined with an ``all_reduce(MAX)`` and one
``all_reduce(SUM)``, as the reference's shard_map does with ``pmax`` /
``psum``.  :func:`_update_cache` writes only the positions the rank owns.
A multi-token cached call (prefill) must start at position 0 and attends
over the prompt's own K/V, everything the cache holds at that point.

**Head-parallel weights** (a rank's ``model`` slice of ``wq`` / ``w_uq`` /
``w_uk`` / ``w_uv`` / ``wo``; ``tp=`` a mesh, Megatron style).  Without a
cache the rank attends with its own heads only: its query heads ``[r H/n,
(r+1) H/n)`` and the replicated KV heads they read (``wk`` /
``wv`` sliced to those, their gradient summed over ``model``), through the
flash kernels at the per-rank head count; ``wo`` is row-parallel with one
``all_reduce``.  With a cache (serving) the rank's query heads are gathered
to all of them, the cached paths above run as on one device, and ``wo``
takes the rank's heads of their output.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist

from repro_torch.launch import collectives as coll
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import rope as rope_lib
from repro_torch.models.common import ParamDef, dense, rmsnorm
from repro_torch.models.config import ModelConfig

__all__ = ["gqa_defs", "mla_defs", "attention_defs", "init_kv_cache",
           "attention_fwd", "naive_attention", "blockwise_attention",
           "BLOCKWISE_THRESHOLD", "seq_shards"]

_MASK = -1e30
BLOCKWISE_THRESHOLD = 8192   # chunked attention above this sequence length
Q_CHUNK = 2048
KV_CHUNK = 2048


def gqa_defs(cfg: ModelConfig) -> dict:
    d, h, kvh, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    return {
        "wq": ParamDef((d, h, hd), ("embed", "heads", "head_dim")),
        "wk": ParamDef((d, kvh, hd), ("embed", "kv_heads", "head_dim")),
        "wv": ParamDef((d, kvh, hd), ("embed", "kv_heads", "head_dim")),
        "wo": ParamDef((h, hd, d), ("heads", "head_dim", "embed"),
                       fan_in_axes=(0, 1)),
    }


def mla_defs(cfg: ModelConfig) -> dict:
    assert cfg.mla is not None
    m = cfg.mla
    d, h = cfg.d_model, cfg.num_heads
    qk = m.nope_head_dim + m.rope_head_dim
    return {
        "w_dq": ParamDef((d, m.q_lora_rank), ("embed", "lora")),
        "q_norm": ParamDef((m.q_lora_rank,), ("lora",), init="ones"),
        "w_uq": ParamDef((m.q_lora_rank, h, qk), ("lora", "heads", "head_dim")),
        "w_dkv": ParamDef((d, m.kv_lora_rank), ("embed", "lora")),
        "kv_norm": ParamDef((m.kv_lora_rank,), ("lora",), init="ones"),
        "w_kr": ParamDef((d, m.rope_head_dim), ("embed", "head_dim")),
        "w_uk": ParamDef((m.kv_lora_rank, h, m.nope_head_dim),
                         ("lora", "heads", "head_dim")),
        "w_uv": ParamDef((m.kv_lora_rank, h, m.v_head_dim),
                         ("lora", "heads", "head_dim")),
        "wo": ParamDef((h, m.v_head_dim, d), ("heads", "head_dim", "embed"),
                       fan_in_axes=(0, 1)),
    }


def attention_defs(cfg: ModelConfig) -> dict:
    return mla_defs(cfg) if cfg.attention == "mla" else gqa_defs(cfg)


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int,
                  dtype: torch.dtype = torch.bfloat16, device="cuda") -> dict:
    """Zeroed cache dict for one attention layer-instance (MLA: the latent
    ``ckv`` (B, S, kv_lora_rank) and ``krope`` (B, S, rope_head_dim))."""
    if cfg.attention == "mla":
        m = cfg.mla
        return {
            "ckv": torch.zeros((batch, max_len, m.kv_lora_rank), dtype=dtype,
                               device=device),
            "krope": torch.zeros((batch, max_len, m.rope_head_dim),
                                 dtype=dtype, device=device),
        }
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


def blockwise_attention(q, k, v, *, causal: bool, q_chunk: int = Q_CHUNK,
                        kv_chunk: int = KV_CHUNK) -> torch.Tensor:
    """Flash-style online-softmax attention; never materializes (Sq, Skv).

    Scores are taken in the operands' dtype and cast to float32, the running
    state starts at ``-inf``, and masked scores are ``-1e30``; V is read as
    float32 and the output cast to ``v.dtype`` -- the reference's order.
    """
    b, sq, h, d = q.shape
    skv = k.shape[1]
    dv = v.shape[-1]
    q_chunk = min(q_chunk, sq)
    kv_chunk = min(kv_chunk, skv)
    if sq % q_chunk or skv % kv_chunk:
        raise ValueError(f"seq lens ({sq},{skv}) must divide chunks "
                         f"({q_chunk},{kv_chunk})")
    dev = q.device
    scale = 1.0 / torch.sqrt(torch.tensor(d, dtype=torch.float32, device=dev))
    outs = []
    for q0 in range(0, sq, q_chunk):
        qblk = q[:, q0:q0 + q_chunk]
        m = torch.full((b, h, q_chunk), -math.inf, dtype=torch.float32, device=dev)
        l = torch.zeros((b, h, q_chunk), dtype=torch.float32, device=dev)
        acc = torch.zeros((b, h, q_chunk, dv), dtype=torch.float32, device=dev)
        for k0 in range(0, skv, kv_chunk):
            kblk, vblk = k[:, k0:k0 + kv_chunk], v[:, k0:k0 + kv_chunk]
            s = torch.einsum("bqhd,bkhd->bhqk", qblk, kblk).to(torch.float32)
            s = s * scale
            if causal:
                qpos = q0 + torch.arange(q_chunk, device=dev)[:, None]
                kpos = k0 + torch.arange(kv_chunk, device=dev)[None, :]
                s = s.masked_fill(~(qpos >= kpos)[None, None], _MASK)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bhqk,bkhd->bhqd", p, vblk.to(torch.float32))
            m = m_new
        out = acc / torch.clamp(l[..., None], min=1e-30)
        outs.append(out.permute(0, 2, 1, 3))                 # (B, qc, H, Dv)
    return torch.cat(outs, dim=1).to(v.dtype)


def _mixed_attention(q, k, v, *, causal: bool) -> torch.Tensor:
    """Dispatch for full-sequence (no-cache) attention.

    A CUDA tensor takes the flash kernels (score tiles stay on chip, the
    backward is the two hand-written kernels), and so does a ``meta`` tensor,
    so that a trace on ``meta`` follows the card's path; elsewhere blockwise
    above ``BLOCKWISE_THRESHOLD`` and naive below, as the reference does off
    TPU.
    """
    if q.device.type in ("cuda", "meta"):
        from repro_torch.kernels.flash_attention import flash_attention
        return flash_attention(q, k, v, causal=causal)
    if q.shape[1] > BLOCKWISE_THRESHOLD:
        return blockwise_attention(q, k, v, causal=causal)
    return naive_attention(q, k, v, causal=causal)


def _repeat_kv(kv: torch.Tensor, h: int) -> torch.Tensor:
    kvh = kv.shape[2]
    if kvh == h:
        return kv
    return torch.repeat_interleave(kv, h // kvh, dim=2)


def seq_shards(cfg: ModelConfig, mesh=None) -> int:
    """How many ``model`` ranks share each cache's sequence axis under
    ``mesh`` (default: the current one): the ``model`` size of a distributed
    mesh unless ``cfg.dp_over_model``, else 1 (every rank holds the whole
    cache)."""
    mesh = mesh_lib.current_mesh() if mesh is None else mesh
    if (mesh is None or not mesh.distributed or "model" not in mesh.axes
            or cfg.dp_over_model):
        return 1
    return mesh.axis_size("model")


def _update_cache(cache_arr: torch.Tensor, new: torch.Tensor, pos,
                  mesh=None) -> torch.Tensor:
    """Write ``new`` (B, S_new, ...) into the seq axis at ``pos`` — in place.

    With ``mesh`` (a sequence-sharded cache, :func:`seq_shards`) the cache
    is this ``model`` rank's slice and only the positions it owns are
    written.
    """
    pos = int(pos)
    if mesh is None:
        cache_arr[:, pos: pos + new.shape[1]] = new.to(cache_arr.dtype)
        return cache_arr
    s_local = cache_arr.shape[1]
    first = mesh.axis_index("model") * s_local
    lo, hi = max(pos, first), min(pos + new.shape[1], first + s_local)
    if lo < hi:
        cache_arr[:, lo - first: hi - first] = \
            new[:, lo - pos: hi - pos].to(cache_arr.dtype)
    return cache_arr


def _prompt_only(cache_pos) -> None:
    """A multi-token call on a sequence-sharded cache must start at position
    0: it then attends over the prompt's own K/V, all the cache holds."""
    if int(cache_pos) != 0:
        raise ValueError(f"a multi-token call at position {int(cache_pos)} on "
                         f"a sequence-sharded cache (only prefill from 0 and "
                         f"one-token decode are served on a model mesh)")


def _lse_combine(m, l, ctx, mesh) -> torch.Tensor:
    """Combine shard-local softmax partials across ``model``.

    m, l: (B, H, Sq) float32 max and sum of ``exp(s - m)``; ctx: (B, H, Sq,
    d).  ``all_reduce(MAX)`` on m, then ``all_reduce(SUM)`` of ``l * alpha``
    and ``ctx * alpha`` (one packed buffer when ctx is float32).  Returns
    (B, Sq, H, d) in ctx's dtype.
    """
    group = mesh.axis_group("model")
    m_g = m.clone()
    coll.all_reduce_(m_g, group, dist.ReduceOp.MAX)
    alpha = torch.exp(m - m_g)
    l_a = l * alpha
    ctx_a = ctx * alpha[..., None].to(ctx.dtype)
    if ctx_a.dtype == torch.float32:
        packed = torch.cat([l_a.reshape(-1), ctx_a.reshape(-1)])
        coll.all_reduce_(packed, group)
        l_g = packed[: l_a.numel()].reshape(l_a.shape)
        ctx_g = packed[l_a.numel():].reshape(ctx_a.shape)
    else:
        l_g, ctx_g = l_a.contiguous(), ctx_a.contiguous()
        coll.all_reduce_(l_g, group)
        coll.all_reduce_(ctx_g, group)
    out = ctx_g / torch.clamp(l_g[..., None], min=1e-30).to(ctx_g.dtype)
    return out.permute(0, 2, 1, 3)


def _shard_partials(s: torch.Tensor, q_offset, kv_valid_len, mesh):
    """Mask one rank's (B, H, Sq, S_local) float32 scores as the reference
    does (``qpos >= kpos``, ``kpos < valid``, ``-1e30``) and take the
    shard-local max, ``exp(s - max)`` and its sum."""
    dev = s.device
    sq, s_local = s.shape[2], s.shape[3]
    qpos = torch.arange(sq, device=dev)[:, None] + int(q_offset)
    kpos = mesh.axis_index("model") * s_local + torch.arange(s_local,
                                                             device=dev)
    valid = torch.as_tensor(kv_valid_len, device=dev).reshape(-1, 1)
    mask = ((qpos >= kpos[None, :])[None, None]
            & (kpos[None, :] < valid)[:, None, None, :])
    s = torch.where(mask, s, torch.full((), _MASK, dtype=s.dtype, device=dev))
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    return m, p, p.sum(dim=-1)


def _sharded_decode_attention(q, kc, vc, h: int, *, q_offset, kv_valid_len,
                              mesh) -> torch.Tensor:
    """Flash-decoding over the sequence-sharded KV cache.

    q: (B, Sq, H, hd), the same on every ``model`` rank; kc / vc: this
    rank's (B, S_local, KVH, hd) slice.  Each rank scores its own keys and
    the ``(max, sum, context)`` partials combine across ``model``
    (:func:`_lse_combine`): the only traffic is (B, H, Sq)-sized statistics
    and the (B, H, Sq, hd) partial context.
    """
    kb = _repeat_kv(kc.to(q.dtype), h)
    vb = _repeat_kv(vc.to(q.dtype), h)
    d = q.shape[-1]
    s = torch.einsum("bqhd,bkhd->bhqk", q, kb).to(torch.float32)
    s = s / math.sqrt(d)
    m, p, l = _shard_partials(s, q_offset, kv_valid_len, mesh)
    ctx = torch.einsum("bhqk,bkhd->bhqd", p.to(vb.dtype), vb)
    return _lse_combine(m, l, ctx, mesh)


def attention_fwd(params: dict, x: torch.Tensor, cfg: ModelConfig, *,
                  positions: torch.Tensor, cache: dict | None = None,
                  cache_pos=0, kv_valid_len=None, tp=None):
    """Returns (out (B,S,D), new_cache_or_None).  ``tp``: the mesh whose
    ``model`` ranks each hold a slice of the heads (``common.tp_of``), or
    None (whole weights)."""
    if cfg.attention == "mla":
        return _mla_fwd(params, x, cfg, positions=positions, cache=cache,
                        cache_pos=cache_pos, kv_valid_len=kv_valid_len, tp=tp)
    return _gqa_fwd(params, x, cfg, positions=positions, cache=cache,
                    cache_pos=cache_pos, kv_valid_len=kv_valid_len, tp=tp)


def _kv_span(r: int, h_local: int, h: int, kvh: int) -> tuple[int, int]:
    """The KV heads ``[k0, k1)`` a rank's query heads ``[r h_local, (r+1)
    h_local)`` read, so that ``_repeat_kv`` of them to ``h_local`` heads
    pairs every query head with its own KV head."""
    g = h // kvh
    first, last = r * h_local, (r + 1) * h_local - 1
    k0, k1 = first // g, last // g + 1
    if h_local % (k1 - k0):
        raise ValueError(f"{h_local} query heads a rank over {k1 - k0} KV "
                         f"heads ({h} heads, {kvh} KV heads)")
    return k0, k1


def _gqa_tp_fwd(params, x, cfg, *, positions, tp):
    """No-cache GQA on the rank's query heads (see the module docstring)."""
    mesh, r = tp, tp.axis_index("model")
    h_local = params["wq"].shape[1]
    k0, k1 = _kv_span(r, h_local, cfg.num_heads, cfg.num_kv_heads)
    xf = coll.copy_to(x, mesh)
    q = dense(params["wq"], xf, cfg, name="wq")        # (B,S,H/n,hd)
    k = dense(coll.copy_to(params["wk"], mesh)[:, k0:k1], xf, cfg, name="wk")
    v = dense(coll.copy_to(params["wv"], mesh)[:, k0:k1], xf, cfg, name="wv")
    q = rope_lib.apply_rope(q, positions, cfg.rope_theta)
    k = rope_lib.apply_rope(k, positions, cfg.rope_theta)
    out = _mixed_attention(q, _repeat_kv(k, h_local), _repeat_kv(v, h_local),
                           causal=True)
    return _out_proj(params, out, cfg, tp)


def _gqa_fwd(params, x, cfg, *, positions, cache, cache_pos, kv_valid_len,
             tp=None):
    h = cfg.num_heads
    if tp is not None and cache is None:
        return _gqa_tp_fwd(params, x, cfg, positions=positions, tp=tp), None
    q = dense(params["wq"], x, cfg, name="wq")         # (B,S,H,hd)
    if tp is not None:
        q = coll.gather(q, tp, "model", 2, reduce_grad=False)
    k = dense(params["wk"], x, cfg, name="wk")         # (B,S,KVH,hd)
    v = dense(params["wv"], x, cfg, name="wv")
    q = rope_lib.apply_rope(q, positions, cfg.rope_theta)
    k = rope_lib.apply_rope(k, positions, cfg.rope_theta)

    new_cache = None
    if cache is not None:
        mesh = mesh_lib.current_mesh() if seq_shards(cfg) > 1 else None
        kc = _update_cache(cache["k"], k, cache_pos, mesh)
        vc = _update_cache(cache["v"], v, cache_pos, mesh)
        new_cache = {"k": kc, "v": vc}
        if mesh is not None and x.shape[1] == 1:
            out = _sharded_decode_attention(
                q, kc, vc, h, q_offset=cache_pos,
                kv_valid_len=kv_valid_len if kv_valid_len is not None
                else int(cache_pos) + 1, mesh=mesh)
        else:
            if mesh is not None:
                # the prompt's own K/V, rounded as the cache rounds them
                _prompt_only(cache_pos)
                kc, vc = k.to(kc.dtype), v.to(vc.dtype)
            k_full = _repeat_kv(kc.to(q.dtype), h)
            v_full = _repeat_kv(vc.to(q.dtype), h)
            out = naive_attention(q, k_full, v_full, causal=True,
                                  q_offset=cache_pos, kv_valid_len=kv_valid_len)
    else:
        out = _mixed_attention(q, _repeat_kv(k, h), _repeat_kv(v, h),
                               causal=True)
    return _out_proj(params, _rank_heads(out, tp), cfg, tp), new_cache


def _rank_heads(attn_out, tp):
    """This ``model`` rank's heads of an output over all of them (the
    cached paths attend with every query head), for its slice of ``wo``."""
    if tp is None:
        return attn_out
    h_local = attn_out.shape[2] // tp.axis_size("model")
    r = tp.axis_index("model")
    return attn_out[:, :, r * h_local:(r + 1) * h_local]


def _out_proj(params, attn_out, cfg, tp=None):
    """(B,S,H,hd) x (H,hd,D) -> (B,S,D).

    Under a backend scope the contraction is routed through ``dense`` as the
    flattened (H*hd, D) GEMM so the output projection is a site
    (``…/attn/wo``) and contracts on the scoped engine; the float path keeps
    the einsum.  With ``tp`` (the rank's heads of ``wo`` and of
    ``attn_out``) the product is row-parallel: one ``all_reduce``.
    """
    wo = params["wo"]
    from repro_torch.backends import runtime as backend_runtime
    if backend_runtime.active_execution() is not None:
        h, hd, d = wo.shape
        x2 = attn_out.reshape(*attn_out.shape[:-2], h * hd)
        out = dense(wo.reshape(h * hd, d), x2, cfg, name="wo")
    else:
        out = torch.einsum("bshd,hde->bse", attn_out, wo.to(attn_out.dtype))
    return out if tp is None else coll.reduce_from(out, tp)


def _mla_fwd(params, x, cfg, *, positions, cache, cache_pos, kv_valid_len,
             tp=None):
    m = cfg.mla
    h = cfg.num_heads
    # the rank's heads of the up-projections (a cached call has them whole:
    # common.CACHED_GATHERED)
    tp_up = tp if cache is None else None
    # query path: low-rank down -> norm -> up, split nope/rope
    cq = rmsnorm(params["q_norm"], dense(params["w_dq"], x, cfg, name="w_dq"),
                 cfg.rms_eps)
    if tp_up is not None:
        cq = coll.copy_to(cq, tp_up)
        h = params["w_uq"].shape[1]
    q = dense(params["w_uq"], cq, cfg, name="w_uq")    # (B,S,H,nope+rope)
    q_nope, q_rope = torch.split(
        q, [m.nope_head_dim, q.shape[-1] - m.nope_head_dim], dim=-1)
    q_rope = rope_lib.apply_rope(q_rope, positions, cfg.rope_theta)

    # KV latent path
    ckv = rmsnorm(params["kv_norm"],
                  dense(params["w_dkv"], x, cfg, name="w_dkv"), cfg.rms_eps)
    krope = dense(params["w_kr"], x, cfg, name="w_kr")[:, :, None, :]  # (B,S,1,rd)
    krope = rope_lib.apply_rope(krope, positions, cfg.rope_theta)[:, :, 0]

    if cache is not None:
        mesh = mesh_lib.current_mesh() if seq_shards(cfg) > 1 else None
        ckv_c = _update_cache(cache["ckv"], ckv, cache_pos, mesh)
        krope_c = _update_cache(cache["krope"], krope, cache_pos, mesh)
        new_cache = {"ckv": ckv_c, "krope": krope_c}
        if mesh is not None and x.shape[1] == 1:
            ctx_lat = _mla_sharded_decode(
                params, q_nope, q_rope, ckv_c.to(q.dtype),
                krope_c.to(q.dtype), cfg, q_offset=cache_pos,
                kv_valid_len=kv_valid_len if kv_valid_len is not None
                else int(cache_pos) + 1, mesh=mesh)
            out = torch.einsum("bqhr,rhv->bqhv", ctx_lat,
                               params["w_uv"].to(ctx_lat.dtype))
        else:
            if mesh is not None:
                _prompt_only(cache_pos)
                ckv_c, krope_c = ckv.to(ckv_c.dtype), krope.to(krope_c.dtype)
            out = _mla_absorbed_attend(params, q_nope, q_rope,
                                       ckv_c.to(q.dtype), krope_c.to(q.dtype),
                                       cfg, kv_valid_len, q_offset=cache_pos)
        out = _rank_heads(out, tp)
    else:
        new_cache = None
        if tp_up is not None:
            ckv = coll.copy_to(ckv, tp_up)
            krope = coll.copy_to(krope, tp_up)
        # train / no-cache: materialize per-head K/V from the latent
        k_nope = dense(params["w_uk"], ckv, cfg, name="w_uk")  # (B,S,H,nope)
        vfull = dense(params["w_uv"], ckv, cfg, name="w_uv")   # (B,S,H,vd)
        kr = krope[:, :, None, :].expand(*krope.shape[:2], h, m.rope_head_dim)
        k = torch.cat([k_nope, kr], dim=-1)
        q_all = torch.cat([q_nope, q_rope], dim=-1)
        out = _mixed_attention(q_all, k, vfull, causal=True)
    return _out_proj(params, out, cfg, tp), new_cache


def _mla_sharded_decode(params, q_nope, q_rope, ckv, krope, cfg, *,
                        q_offset, kv_valid_len, mesh):
    """Flash-decoding for MLA: absorbed scoring against this ``model``
    rank's slice of the latent cache, combined across ``model`` as in
    :func:`_sharded_decode_attention`.

    Returns the combined latent context (B, Sq, H, rank); the caller applies
    ``W_uv``.
    """
    m = cfg.mla
    d_qk = m.nope_head_dim + m.rope_head_dim
    # absorb W_uk into the query once
    q_lat = torch.einsum("bqhn,rhn->bqhr", q_nope,
                         params["w_uk"].to(q_nope.dtype))
    s_lat = torch.einsum("bqhr,bkr->bhqk", q_lat, ckv)
    s_rope = torch.einsum("bqhd,bkd->bhqk", q_rope, krope)
    s = (s_lat + s_rope).to(torch.float32) / math.sqrt(d_qk)
    mx, p, l = _shard_partials(s, q_offset, kv_valid_len, mesh)
    ctx = torch.einsum("bhqk,bkr->bhqr", p.to(ckv.dtype), ckv)
    return _lse_combine(mx, l, ctx, mesh)


def _mla_absorbed_attend(params, q_nope, q_rope, ckv, krope, cfg, kv_valid_len,
                         q_offset=0):
    """Absorbed MLA: score and read directly in the latent space.

    scores = (q_nope @ W_uk) . ckv + q_rope . krope ;  out_h = (attn @ ckv) @ W_uv
    The cache stays (B, S, rank + rd): no per-head K/V.
    """
    m = cfg.mla
    d_qk = m.nope_head_dim + m.rope_head_dim
    dev = q_nope.device
    # (B,Sq,H,nope) x (rank,H,nope) -> (B,Sq,H,rank)
    q_lat = torch.einsum("bqhn,rhn->bqhr", q_nope,
                         params["w_uk"].to(q_nope.dtype))
    s_lat = torch.einsum("bqhr,bkr->bhqk", q_lat, ckv)
    s_rope = torch.einsum("bqhd,bkd->bhqk", q_rope, krope)
    scores = (s_lat + s_rope).to(torch.float32) / math.sqrt(d_qk)
    sq, sk = q_nope.shape[1], ckv.shape[1]
    qpos = torch.arange(sq, device=dev)[:, None] + int(q_offset)
    kpos = torch.arange(sk, device=dev)[None, :]
    scores = scores.masked_fill(~(qpos >= kpos)[None, None], _MASK)
    if kv_valid_len is not None:
        valid_len = torch.as_tensor(kv_valid_len, device=dev).reshape(-1, 1)
        valid = torch.arange(sk, device=dev)[None, :] < valid_len
        scores = scores.masked_fill(~valid[:, None, None, :], _MASK)
    w = torch.softmax(scores, dim=-1).to(ckv.dtype)
    ctx_lat = torch.einsum("bhqk,bkr->bqhr", w, ckv)       # (B,Sq,H,rank)
    return torch.einsum("bqhr,rhv->bqhv", ctx_lat,
                        params["w_uv"].to(ctx_lat.dtype))
