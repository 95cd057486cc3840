"""Mamba2 (SSD — state-space duality) blocks, chunked into matmuls.

The selective state-space recurrence

    h_t = exp(dt_t * A) * h_{t-1} + dt_t * (B_t ⊗ x_t)
    y_t = C_t · h_t + D * x_t

is evaluated with the chunked SSD algorithm: the sequence is split into
chunks of length Q; intra-chunk terms become (Q, Q)-masked matmuls,
inter-chunk terms reduce to a short loop over chunk states (B, H, N, P).
Decode keeps the (B, H, N, P) state plus a depthwise-conv tail buffer and
costs O(1) per token.

Layout follows Mamba2: in_proj -> [z | x | B | C | dt], depthwise causal
conv over the (x, B, C) channels, SSD core, gated RMSNorm, out_proj.  The
algorithm and its summation order are the reference's
(``repro.models.ssm``), with one deliberate difference: the intra-chunk
decay masks the segment sums to ``-inf`` *before* ``exp`` (see
:func:`_intra_decay`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.common import ParamDef, dense, rmsnorm
from repro_torch.models.config import ModelConfig

__all__ = ["ssm_defs", "ssm_fwd", "init_ssm_cache", "ssd_chunked",
           "ssd_recurrent_ref"]


def _dims(cfg: ModelConfig):
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    n_heads = d_inner // s.head_dim
    return s, d_inner, n_heads


def ssm_defs(cfg: ModelConfig) -> dict:
    """Separate projections per component (not one fused in_proj), as the
    reference declares them: each is its own dense site."""
    s, d_inner, n_heads = _dims(cfg)
    gn = s.n_groups * s.state_dim
    return {
        "w_z": ParamDef((cfg.d_model, d_inner), ("embed", "mlp")),
        "w_x": ParamDef((cfg.d_model, d_inner), ("embed", "mlp")),
        "w_b": ParamDef((cfg.d_model, gn), ("embed", None)),
        "w_c": ParamDef((cfg.d_model, gn), ("embed", None)),
        "w_dt": ParamDef((cfg.d_model, n_heads), ("embed", "heads")),
        "conv_x_w": ParamDef((s.conv_kernel, d_inner), ("conv", "mlp")),
        "conv_x_b": ParamDef((d_inner,), ("mlp",), init="zeros"),
        "conv_bc_w": ParamDef((s.conv_kernel, 2 * gn), ("conv", None)),
        "conv_bc_b": ParamDef((2 * gn,), (None,), init="zeros"),
        "a_log": ParamDef((n_heads,), ("heads",), init="ssm_a"),
        "dt_bias": ParamDef((n_heads,), ("heads",), init="ssm_dt"),
        "d_skip": ParamDef((n_heads,), ("heads",), init="ones"),
        "norm": ParamDef((d_inner,), ("mlp",), init="ones"),
        "out_proj": ParamDef((d_inner, cfg.d_model), ("mlp", "embed")),
    }


def init_ssm_cache(cfg: ModelConfig, batch: int,
                   dtype: torch.dtype = torch.float32, device="cuda") -> dict:
    """One layer's zeroed cache: the float32 SSD state and the conv tails."""
    s, d_inner, n_heads = _dims(cfg)
    gn = s.n_groups * s.state_dim
    return {
        "state": torch.zeros((batch, n_heads, s.state_dim, s.head_dim),
                             dtype=torch.float32, device=device),
        "conv_x": torch.zeros((batch, s.conv_kernel - 1, d_inner), dtype=dtype,
                              device=device),
        "conv_bc": torch.zeros((batch, s.conv_kernel - 1, 2 * gn), dtype=dtype,
                               device=device),
    }


# ---------------------------------------------------------------------------
# SSD core
# ---------------------------------------------------------------------------

def _ssd_step(state, xt, dtt, a, bt, ct):
    """One recurrence step on float32 (B,H,N,P) state; returns (state, y)."""
    da = torch.exp(dtt * a)                                       # (B,H)
    state = (state * da[..., None, None]
             + torch.einsum("bhn,bhp->bhnp", bt, xt * dtt[..., None]))
    return state, torch.einsum("bhn,bhnp->bhp", ct, state)


def ssd_recurrent_ref(x, dt, a, b, c, init_state=None):
    """Step-by-step oracle.  x:(B,S,H,P) dt:(B,S,H) a:(H,) b,c:(B,S,G,N)."""
    bs, s, h, p = x.shape
    rep = h // b.shape[2]
    state = (torch.zeros((bs, h, b.shape[-1], p), dtype=torch.float32,
                         device=x.device)
             if init_state is None else init_state)
    ys = []
    for t in range(s):
        bt = torch.repeat_interleave(b[:, t], rep, dim=1).to(torch.float32)
        ct = torch.repeat_interleave(c[:, t], rep, dim=1).to(torch.float32)
        state, y = _ssd_step(state, x[:, t].to(torch.float32), dt[:, t], a,
                             bt, ct)
        ys.append(y)
    return torch.stack(ys, dim=1).to(x.dtype), state


def _intra_decay(seg, causal):
    """``exp`` of the segment sums ``cum_i - cum_j``, masked to ``-inf``
    above the diagonal *before* ``exp``.

    The reference takes ``where(causal, exp(seg), 0)``.  Above the diagonal
    ``seg`` is a positive sum of ``-dt·A`` over up to ``chunk - 1`` steps:
    at zamba2's chunk of 64 with ``A`` down to -16 and ``dt`` up to 0.1 it
    reaches ~100, ``exp`` overflows to ``inf`` and the backward multiplies
    it by a zero cotangent (NaN).  ``exp(-inf)`` is exactly 0, so the
    forward is unchanged bit for bit and the gradient stays finite.
    """
    return torch.exp(seg.masked_fill(~causal, -torch.inf))


def ssd_chunked(x, dt, a, b, c, chunk: int, init_state=None):
    """Chunked SSD.  Same signature/semantics as the oracle, O(S·Q) matmuls
    (the intra-chunk decay: :func:`_intra_decay`)."""
    bs, s, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    rep = h // g
    if s % chunk:
        pad = chunk - s % chunk
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        b = F.pad(b, (0, 0, 0, 0, 0, pad))
        c = F.pad(c, (0, 0, 0, 0, 0, pad))
    sp = x.shape[1]
    nc = sp // chunk

    f32 = torch.float32
    dev = x.device
    xc = x.reshape(bs, nc, chunk, h, p).to(f32)
    dtc = dt.reshape(bs, nc, chunk, h).to(f32)
    bc = torch.repeat_interleave(b.reshape(bs, nc, chunk, g, n), rep, dim=3).to(f32)
    cc = torch.repeat_interleave(c.reshape(bs, nc, chunk, g, n), rep, dim=3).to(f32)

    la = dtc * a                                   # (B,C,Q,H) log-decay per step
    # inclusive cumsum as a triangular matmul (the reference's summation)
    tril = torch.tril(torch.ones((chunk, chunk), dtype=f32, device=dev))
    cum = torch.einsum("qt,bcth->bcqh", tril, la)
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]      # (B,C,Qi,Qj,H)
    idx = torch.arange(chunk, device=dev)
    causal = (idx[:, None] >= idx[None, :])[None, None, :, :, None]
    decay = _intra_decay(seg, causal)

    xdt = xc * dtc[..., None]                      # dt-weighted input
    # intra-chunk: y[i] = sum_{j<=i} (C_i.B_j) * exp(cum_i - cum_j) * xdt_j
    cb = torch.einsum("bcihn,bcjhn->bcijh", cc, bc)
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", cb * decay, xdt)

    # chunk summary state: sum_j exp(cum_last - cum_j) * B_j ⊗ xdt_j
    tail = torch.exp(cum[:, :, -1:, :] - cum)      # (B,C,Q,H)
    chunk_state = torch.einsum("bcjhn,bcjhp->bchnp", bc * tail[..., None], xdt)
    chunk_decay = torch.exp(torch.sum(la, dim=2))  # (B,C,H)

    # inter-chunk loop over chunk states
    state = (torch.zeros((bs, h, n, p), dtype=f32, device=dev)
             if init_state is None else init_state.to(f32))
    prev = []
    for ci in range(nc):
        prev.append(state)
        state = state * chunk_decay[:, ci, :, None, None] + chunk_state[:, ci]
    prev_states = torch.stack(prev, dim=1)         # (B,C,H,N,P)

    # inter-chunk contribution: C_i · (exp(cum_i) * state_entering_chunk)
    y_inter = torch.einsum("bcihn,bchnp->bcihp",
                           cc * torch.exp(cum)[..., None], prev_states)

    y = (y_intra + y_inter).reshape(bs, sp, h, p)[:, :s]
    return y.to(x.dtype), state


# ---------------------------------------------------------------------------
# Full Mamba2 block
# ---------------------------------------------------------------------------

def _causal_conv(seq, conv_w, conv_b, tail=None):
    """Depthwise causal conv along seq.  seq: (B,S,C); tail: (B,K-1,C).

    A loop over the taps (the reference's order), not ``F.conv1d``: cuDNN
    would round the products to TF32 wherever ``allow_tf32`` is on.
    """
    k = conv_w.shape[0]
    if tail is None:
        tail = torch.zeros((seq.shape[0], k - 1, seq.shape[2]),
                           dtype=seq.dtype, device=seq.device)
    full = torch.cat([tail.to(seq.dtype), seq], dim=1)
    out = torch.zeros_like(seq)
    for i in range(k):
        out = out + full[:, i:i + seq.shape[1]] * conv_w[i].to(seq.dtype)
    out = out + conv_b.to(seq.dtype)
    new_tail = full[:, full.shape[1] - (k - 1):]
    return F.silu(out), new_tail


def ssm_fwd(params: dict, x: torch.Tensor, cfg: ModelConfig, *,
            cache: dict | None = None):
    """x: (B, S, D) -> (out, new_cache_or_None).

    ``new_cache`` holds new tensors (the caller writes them into its cache);
    a one-token call with a cache takes the O(1) recurrence step.
    """
    s, d_inner, n_heads = _dims(cfg)
    gn = s.n_groups * s.state_dim
    z = dense(params["w_z"], x, cfg, name="w_z")
    xin = dense(params["w_x"], x, cfg, name="w_x")
    bc = torch.cat([dense(params["w_b"], x, cfg, name="w_b"),
                    dense(params["w_c"], x, cfg, name="w_c")], dim=-1)
    dt = dense(params["w_dt"], x, cfg, name="w_dt")

    tail_x = cache["conv_x"] if cache is not None else None
    tail_bc = cache["conv_bc"] if cache is not None else None
    xin, new_tail_x = _causal_conv(xin, params["conv_x_w"], params["conv_x_b"],
                                   tail_x)
    bc, new_tail_bc = _causal_conv(bc, params["conv_bc_w"], params["conv_bc_b"],
                                   tail_bc)
    bb, cc = bc[..., :gn], bc[..., gn:]

    bsz, slen = x.shape[0], x.shape[1]
    xh = xin.reshape(bsz, slen, n_heads, s.head_dim)
    bh = bb.reshape(bsz, slen, s.n_groups, s.state_dim)
    ch = cc.reshape(bsz, slen, s.n_groups, s.state_dim)
    a = -torch.exp(params["a_log"].to(torch.float32))
    dt_full = F.softplus(dt.to(torch.float32)
                         + params["dt_bias"].to(torch.float32))

    init_state = cache["state"] if cache is not None else None
    if slen == 1 and cache is not None:
        # O(1) decode step
        rep = n_heads // s.n_groups
        bt = torch.repeat_interleave(bh[:, 0], rep, dim=1).to(torch.float32)
        ct = torch.repeat_interleave(ch[:, 0], rep, dim=1).to(torch.float32)
        final_state, yt = _ssd_step(init_state, xh[:, 0].to(torch.float32),
                                    dt_full[:, 0], a, bt, ct)
        yh = yt[:, None]
    else:
        yh, final_state = ssd_chunked(xh, dt_full, a, bh, ch, s.chunk,
                                      init_state=init_state)
    yh = yh + (params["d_skip"].to(yh.dtype)[None, None, :, None]
               * xh.to(yh.dtype))
    y = yh.reshape(bsz, slen, d_inner).to(x.dtype)

    y = rmsnorm(params["norm"], y * F.silu(z), cfg.rms_eps)
    out = dense(params["out_proj"], y, cfg, name="out_proj")
    new_cache = None
    if cache is not None:
        new_cache = {"state": final_state, "conv_x": new_tail_x,
                     "conv_bc": new_tail_bc}
    return out, new_cache
