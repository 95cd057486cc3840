"""Mixture-of-Experts on one device: routing, capacity-bounded experts, aux.

Routing: softmax scoring (Switch/Mixtral; every registered MoE arch, as in
the reference; ``_routing`` also takes DeepSeek-V3's sigmoid), top-k with
renormalization, optional shared (always-on) experts, and a
Switch-style load-balance auxiliary loss.  Each expert takes the ``cap``
tokens of largest weight for it (:func:`_capacity`); a token routed to a
full expert is dropped there, and tokens not routed to it ride along with
weight 0.

The router and the routed experts' matmuls are float and are not dense
sites, even under a backend or plan scope; only the shared expert's
``w_gate`` / ``w_up`` / ``w_down`` are sites (``…/moe/shared/w_up``).

The reference's expert-parallel paths (a ``psum`` over the ``model`` mesh
axis, and the all-to-all dispatch) need more than one device: ROADMAP
Queue 1 item 6.  On one device the reference never takes them.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.backends.runtime import site_scope
from repro_torch.models.common import ParamDef
from repro_torch.models.config import ModelConfig
from repro_torch.models.mlp import mlp_defs, mlp_fwd

__all__ = ["moe_defs", "moe_fwd"]


def moe_defs(cfg: ModelConfig) -> dict:
    assert cfg.moe is not None
    m, d = cfg.moe, cfg.d_model
    ffe = m.d_ff_expert
    defs = {
        "router": ParamDef((d, m.num_experts)),
        "w_gate": ParamDef((m.num_experts, d, ffe), fan_in_axes=(1,)),
        "w_up": ParamDef((m.num_experts, d, ffe), fan_in_axes=(1,)),
        "w_down": ParamDef((m.num_experts, ffe, d), fan_in_axes=(1,)),
    }
    if m.num_shared_experts:
        defs["shared"] = mlp_defs(cfg, d_ff=m.num_shared_experts * ffe)
    return defs


def _top_k(x: torch.Tensor, k: int):
    """``lax.top_k`` over the last axis: descending, ties to the lower index.

    ``torch.topk`` promises no order among equal values, so a stable
    descending sort stands in for it.
    """
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _routing(router_w, x_flat, cfg: ModelConfig, scoring: str = "softmax"):
    """-> (topk_idx (T,K), topk_w (T,K), probs (T,E))."""
    m = cfg.moe
    logits = torch.matmul(x_flat.to(torch.float32),
                          router_w.to(torch.float32))          # (T, E)
    if scoring == "sigmoid":
        probs = torch.sigmoid(logits)
    else:
        probs = torch.softmax(logits, dim=-1)
    topk_w, topk_idx = _top_k(probs, m.top_k)
    topk_w = topk_w / torch.clamp(topk_w.sum(dim=-1, keepdim=True), min=1e-9)
    return topk_idx, topk_w, probs


def _capacity(t_local: int, cfg: ModelConfig) -> int:
    m = cfg.moe
    c = math.ceil(t_local * m.top_k / m.num_experts * m.capacity_factor)
    return min(t_local, max(4, c))


def _local_expert_pass(x_flat, topk_idx, topk_w, wg, wu, wd, cfg: ModelConfig):
    """Capacity-gather each expert's tokens, FFN, weighted scatter-add.

    x_flat: (T, D); wg/wu/wd: (E, ...) expert stacks.  Experts add
    into the accumulator one after another in expert order; within an
    expert the selected rows are distinct, so ``index_add`` is exact.
    Returns the summed contribution (T, D).
    """
    t_local = x_flat.shape[0]
    cap = _capacity(t_local, cfg)
    acc = torch.zeros_like(x_flat)
    for e in range(wg.shape[0]):
        # per-token weight for this expert (0 if not routed here)
        hit = topk_idx == e                                             # (T, K)
        w_tok = torch.where(hit, topk_w, torch.zeros_like(topk_w)).sum(dim=-1)
        sel_w, sel_idx = _top_k(w_tok, cap)                            # capacity
        xs = x_flat[sel_idx]                                            # (C, D)
        h = F.silu(torch.matmul(xs, wg[e].to(xs.dtype))) * torch.matmul(
            xs, wu[e].to(xs.dtype))
        y = torch.matmul(h, wd[e].to(xs.dtype))                         # (C, D)
        y = y * sel_w[:, None].to(y.dtype)          # weight (0 for non-routed)
        acc = acc.index_add(0, sel_idx, y)
    return acc


def _aux_loss(probs, topk_idx, cfg: ModelConfig):
    """Switch-style load-balance loss: E * sum_e f_e * p_e."""
    e = cfg.moe.num_experts
    hits = F.one_hot(topk_idx[..., 0], e).to(torch.float32)     # primary expert
    f = hits.mean(dim=0)
    p = probs.mean(dim=0)
    return e * torch.sum(f * p)


def moe_fwd(params: dict, x: torch.Tensor, cfg: ModelConfig):
    """x: (B, S, D) -> (out (B, S, D), aux_loss scalar)."""
    b, s, d = x.shape
    x_flat = x.reshape(-1, d)
    topk_idx, topk_w, probs = _routing(params["router"], x_flat, cfg)
    out_flat = _local_expert_pass(x_flat, topk_idx, topk_w, params["w_gate"],
                                  params["w_up"], params["w_down"], cfg)
    aux = _aux_loss(probs, topk_idx, cfg)
    out = out_flat.reshape(b, s, d)
    if cfg.moe.num_shared_experts:
        # site path matches the param tree ("…/moe/shared/w_up"); the
        # routed experts above are not dense sites and stay float
        with site_scope("shared"):
            out = out + mlp_fwd(params["shared"], x, cfg)
    return out, aux
