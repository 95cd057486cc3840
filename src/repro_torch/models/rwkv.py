"""RWKV6 ("Finch") blocks: data-dependent decay WKV, chunked into matmuls.

Time-mix recurrence per head (K = V = head_dim):

    y_t = r_t · (S_{t-1} + diag(u) k_t v_tᵀ)
    S_t = diag(w_t) S_{t-1} + k_t v_tᵀ,   w_t = exp(-exp(w0 + LoRA(x_t)))

evaluated chunkwise: within a chunk the pairwise weights
``exp(Lc_{t-1} - Lc_j)`` (cumulative log-decay differences, always ≤ 0)
factor into query/key exponentials, giving (Q, Q) score matmuls; across
chunks a short loop carries the (B, H, K, V) state.  Exponents are clamped
to ±``EXP_CLAMP`` exactly where the reference clamps them.

Decode is O(1): state + one-token shift buffers.

The reference's simplifications vs. the released checkpoints hold here too:
token-shift mixing coefficients are static (the decay LoRA is
data-dependent); LayerNorm in both sub-blocks.  ``w_o`` and the decay LoRA
are plain einsums, not dense sites, as in the reference.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.backends.runtime import site_scope
from repro_torch.models.common import ParamDef, dense
from repro_torch.models.config import ModelConfig

__all__ = ["rwkv_defs", "rwkv_block_fwd", "init_rwkv_cache",
           "wkv_chunked", "wkv_recurrent_ref"]

EXP_CLAMP = 20.0
CHUNK = 32


def _dims(cfg: ModelConfig):
    k = cfg.rwkv.head_dim
    h = cfg.d_model // k
    return h, k


def rwkv_defs(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    h, k = _dims(cfg)
    r = cfg.rwkv.decay_lora
    return {
        "ln1_s": ParamDef((d,), ("embed",), init="ones"),
        "ln1_b": ParamDef((d,), ("embed",), init="zeros"),
        "ln2_s": ParamDef((d,), ("embed",), init="ones"),
        "ln2_b": ParamDef((d,), ("embed",), init="zeros"),
        "tm": {
            "mu_r": ParamDef((d,), ("embed",), init="zeros"),
            "mu_k": ParamDef((d,), ("embed",), init="zeros"),
            "mu_v": ParamDef((d,), ("embed",), init="zeros"),
            "mu_w": ParamDef((d,), ("embed",), init="zeros"),
            "mu_g": ParamDef((d,), ("embed",), init="zeros"),
            "w_r": ParamDef((d, h, k), ("embed", "heads", "head_dim")),
            "w_k": ParamDef((d, h, k), ("embed", "heads", "head_dim")),
            "w_v": ParamDef((d, h, k), ("embed", "heads", "head_dim")),
            "w_g": ParamDef((d, h, k), ("embed", "heads", "head_dim")),
            "w0": ParamDef((h, k), ("heads", "head_dim"), init="ssm_dt"),
            "wa": ParamDef((d, r), ("embed", "lora")),
            "wb": ParamDef((r, h, k), ("lora", "heads", "head_dim"), init="zeros"),
            "u": ParamDef((h, k), ("heads", "head_dim"), init="zeros"),
            "gn_s": ParamDef((d,), ("embed",), init="ones"),
            "gn_b": ParamDef((d,), ("embed",), init="zeros"),
            "w_o": ParamDef((h, k, d), ("heads", "head_dim", "embed"),
                            fan_in_axes=(0, 1)),
        },
        "cm": {
            "mu_k": ParamDef((d,), ("embed",), init="zeros"),
            "mu_r": ParamDef((d,), ("embed",), init="zeros"),
            "w_k": ParamDef((d, cfg.d_ff), ("embed", "mlp")),
            "w_v": ParamDef((cfg.d_ff, d), ("mlp", "embed")),
            "w_r": ParamDef((d, d), ("embed", "embed")),
        },
    }


def init_rwkv_cache(cfg: ModelConfig, batch: int,
                    dtype: torch.dtype = torch.float32, device="cuda") -> dict:
    """One layer's zeroed cache: the float32 WKV state and the two
    token-shift buffers."""
    h, k = _dims(cfg)
    return {
        "state": torch.zeros((batch, h, k, k), dtype=torch.float32,
                             device=device),
        "tm_last": torch.zeros((batch, cfg.d_model), dtype=dtype, device=device),
        "cm_last": torch.zeros((batch, cfg.d_model), dtype=dtype, device=device),
    }


def _layernorm(x, s, b, eps=1e-5):
    x32 = x.to(torch.float32)
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.var(x32, dim=-1, keepdim=True, unbiased=False)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * s.to(torch.float32) + b.to(torch.float32)).to(x.dtype)


def _group_norm(x, s, b, n_heads, eps=1e-5):
    """Per-head normalization of (B, S, H*K)."""
    bsz, slen, d = x.shape
    xh = x.reshape(bsz, slen, n_heads, d // n_heads).to(torch.float32)
    mu = torch.mean(xh, dim=-1, keepdim=True)
    var = torch.var(xh, dim=-1, keepdim=True, unbiased=False)
    y = ((xh - mu) * torch.rsqrt(var + eps)).reshape(bsz, slen, d)
    return (y * s.to(torch.float32) + b.to(torch.float32)).to(x.dtype)


def _token_shift(x, mu, last=None):
    """mix x_t with x_{t-1}: x + mu * (x_{t-1} - x_t).  last: (B, D)."""
    if last is None:
        prev = F.pad(x[:, :-1], (0, 0, 1, 0))
    else:
        prev = torch.cat([last[:, None].to(x.dtype), x[:, :-1]], dim=1)
    return x + mu.to(x.dtype) * (prev - x)


# ---------------------------------------------------------------------------
# WKV core
# ---------------------------------------------------------------------------

def wkv_recurrent_ref(r, k, v, logw, u, init_state=None):
    """Oracle.  r/k/v: (B,S,H,K); logw: (B,S,H,K) (≤0); u: (H,K)."""
    b, s, h, kk = r.shape
    state = (torch.zeros((b, h, kk, kk), dtype=torch.float32, device=r.device)
             if init_state is None else init_state)
    ys = []
    for t in range(s):
        rt = r[:, t].to(torch.float32)
        kt = k[:, t].to(torch.float32)
        vt = v[:, t].to(torch.float32)
        wt = torch.exp(logw[:, t].to(torch.float32))
        kv = torch.einsum("bhk,bhv->bhkv", kt, vt)
        ys.append(torch.einsum("bhk,bhkv->bhv", rt,
                               state + u[None, :, :, None] * kv))
        state = state * wt[..., None] + kv
    return torch.stack(ys, dim=1).to(r.dtype), state


def wkv_chunked(r, k, v, logw, u, chunk: int = CHUNK, init_state=None):
    """Chunked WKV; same semantics as the oracle."""
    b, s, h, kk = r.shape
    if s % chunk:
        pad = (0, 0, 0, 0, 0, chunk - s % chunk)
        r, k, v = (F.pad(t, pad) for t in (r, k, v))
        logw = F.pad(logw, pad)   # log w = 0 -> w = 1 for padding (harmless)
    sp = r.shape[1]
    nc = sp // chunk
    f32 = torch.float32
    dev = r.device
    rc = r.reshape(b, nc, chunk, h, kk).to(f32)
    kc = k.reshape(b, nc, chunk, h, kk).to(f32)
    vc = v.reshape(b, nc, chunk, h, kk).to(f32)
    lw = logw.reshape(b, nc, chunk, h, kk).to(f32)

    # inclusive cumsum as a triangular matmul (the reference's summation)
    tril = torch.tril(torch.ones((chunk, chunk), dtype=f32, device=dev))
    lc = torch.einsum("qt,bcthk->bcqhk", tril, lw)   # inclusive (B,C,Q,H,K)
    lc_prev = lc - lw                                 # Lc_{t-1} (exclusive)
    total = lc[:, :, -1]                              # (B,C,H,K)

    def clamp(e):
        return torch.clamp(e, -EXP_CLAMP, EXP_CLAMP)

    r_tilde = rc * torch.exp(clamp(lc_prev))          # query side
    k_tilde = kc * torch.exp(clamp(-lc))              # key side
    k_carry = kc * torch.exp(clamp(total[:, :, None] - lc))  # decay to chunk end

    idx = torch.arange(chunk, device=dev)
    strict = (idx[:, None] > idx[None, :])[None, None, None]  # (1,1,1,Q,Q) t>j

    scores = torch.einsum("bcthk,bcjhk->bchtj", r_tilde, k_tilde)
    scores = torch.where(strict, scores, torch.zeros((), dtype=f32, device=dev))
    y_intra = torch.einsum("bchtj,bcjhv->bcthv", scores, vc)

    diag = torch.einsum("bcthk,hk,bcthk->bcth", rc, u.to(f32), kc)
    y_intra = y_intra + diag[..., None] * vc

    chunk_state = torch.einsum("bcjhk,bcjhv->bchkv", k_carry, vc)
    chunk_decay = torch.exp(total)                    # (B,C,H,K)

    state = (torch.zeros((b, h, kk, kk), dtype=f32, device=dev)
             if init_state is None else init_state.to(f32))
    prev = []
    for ci in range(nc):
        prev.append(state)
        state = state * chunk_decay[:, ci, ..., None] + chunk_state[:, ci]
    prev_states = torch.stack(prev, dim=1)            # (B,C,H,K,V)

    y_inter = torch.einsum("bcthk,bchkv->bcthv", r_tilde, prev_states)
    y = (y_intra + y_inter).reshape(b, sp, h, kk)[:, :s]
    return y.to(r.dtype), state


# ---------------------------------------------------------------------------
# Full block
# ---------------------------------------------------------------------------

def rwkv_block_fwd(params: dict, x: torch.Tensor, cfg: ModelConfig, *,
                   cache: dict | None = None):
    """Full RWKV6 block (time-mix + channel-mix).  x: (B, S, D).

    Returns ``(x, new_cache_or_None)``; ``new_cache`` holds new tensors (the
    caller writes them into its cache).  A one-token call with a cache takes
    the recurrence step.
    """
    h, kdim = _dims(cfg)
    tm, cm = params["tm"], params["cm"]

    # ---- time mix -----------------------------------------------------
    xn = _layernorm(x, params["ln1_s"], params["ln1_b"])
    last = cache["tm_last"] if cache is not None else None
    xr = _token_shift(xn, tm["mu_r"], last)
    xk = _token_shift(xn, tm["mu_k"], last)
    xv = _token_shift(xn, tm["mu_v"], last)
    xw = _token_shift(xn, tm["mu_w"], last)
    xg = _token_shift(xn, tm["mu_g"], last)

    with site_scope("tm"):
        r = dense(tm["w_r"], xr, cfg, name="w_r")      # (B,S,H,K)
        k = dense(tm["w_k"], xk, cfg, name="w_k")
        v = dense(tm["w_v"], xv, cfg, name="w_v")
        g = F.silu(dense(tm["w_g"], xg, cfg, name="w_g"))

    # data-dependent decay (the Finch LoRA)
    lora = torch.einsum("bsd,dr->bsr", torch.tanh(xw.to(torch.float32)),
                        tm["wa"].to(torch.float32))
    ddd = torch.einsum("bsr,rhk->bshk", lora, tm["wb"].to(torch.float32))
    logw = -torch.exp(torch.clamp(tm["w0"].to(torch.float32)[None, None] + ddd,
                                  -8.0, 8.0))       # per-step log decay ≤ 0

    state0 = cache["state"] if cache is not None else None
    if x.shape[1] == 1 and cache is not None:
        y, state = wkv_recurrent_ref(r, k, v, logw, tm["u"], init_state=state0)
    else:
        y, state = wkv_chunked(r, k, v, logw, tm["u"], init_state=state0)
    y = y.reshape(x.shape[0], x.shape[1], -1)
    y = _group_norm(y, tm["gn_s"], tm["gn_b"], h)
    y = y * g.reshape(y.shape)
    att = torch.einsum("bshk,hkd->bsd", y.reshape(*x.shape[:2], h, kdim),
                       tm["w_o"].to(y.dtype))
    x = x + att

    # ---- channel mix ----------------------------------------------------
    xn2 = _layernorm(x, params["ln2_s"], params["ln2_b"])
    last2 = cache["cm_last"] if cache is not None else None
    xk2 = _token_shift(xn2, cm["mu_k"], last2)
    xr2 = _token_shift(xn2, cm["mu_r"], last2)
    with site_scope("cm"):
        kk = torch.square(F.relu(dense(cm["w_k"], xk2, cfg, name="w_k")))
        vv = dense(cm["w_v"], kk, cfg, name="w_v")
        rr = torch.sigmoid(dense(cm["w_r"], xr2, cfg, name="w_r"))
    x = x + rr * vv

    new_cache = None
    if cache is not None:
        new_cache = {"state": state, "tm_last": xn[:, -1], "cm_last": xn2[:, -1]}
    return x, new_cache
