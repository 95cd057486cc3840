"""Mixture-of-Experts: routing, capacity-bounded experts, aux, and expert
parallelism over the ``model`` axis of a distributed mesh.

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

Expert parallelism (``launch.mesh``, ``with mesh:``; a distributed mesh
whose ``model`` axis is above 1 and divides the expert count, as the
reference selects): each ``model`` rank holds ``E / n`` experts — the
``w_gate`` / ``w_up`` / ``w_down`` stacks either sliced on the expert axis
already (the rank's own tree) or whole, then sliced here.  ``psum``
(:func:`_moe_ep_psum`): every rank routes all its tokens with the
replicated router, runs its own experts and an ``all_reduce(SUM)`` adds the
contributions.  ``a2a`` (:func:`_moe_ep_a2a`, ``cfg.moe.ep_impl == "a2a"``
and T divisible by n with T >= n²): each rank routes its T / n token slice,
sends each expert's capacity rows to the expert's owner with
``all_to_all_single``, runs its experts and sends the results back; an
``all_reduce(SUM)`` reassembles the tokens.  The a2a capacity comes from the
slice, so at published capacity factors the two drop different tokens, as
in the reference.

In training (``sh=``, a ``models.common.Sharding``) the collectives are
autograd ones (``launch.collectives``): the tokens and routing weights enter
the rank's experts through ``copy_to`` and the combine is ``reduce_from``,
so the router's gradient is whole on every ``model`` rank.  Capacity comes from the
rank's own tokens (its ``data`` block), as in the reference's shard_map.
The aux loss is taken from load fractions summed over the batch axes first:
the local and psum paths' is the whole batch's, the a2a path's the mean
over the ``model`` ranks of each token slice's, that slice taken on every
batch rank together.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.backends.runtime import site_scope
from repro_torch.launch import collectives as coll
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models.common import ParamDef, tp_of
from repro_torch.models.config import ModelConfig
from repro_torch.models.mlp import mlp_defs, mlp_fwd

__all__ = ["moe_defs", "moe_fwd", "ep_shards", "EXPERT_LEAVES"]

#: the expert stacks expert parallelism slices on their expert axis
EXPERT_LEAVES = ("w_gate", "w_up", "w_down")


def moe_defs(cfg: ModelConfig) -> dict:
    assert cfg.moe is not None
    m, d = cfg.moe, cfg.d_model
    ffe = m.d_ff_expert
    defs = {
        "router": ParamDef((d, m.num_experts), ("embed", "experts")),
        "w_gate": ParamDef((m.num_experts, d, ffe),
                           ("experts", "embed", "expert_mlp"), fan_in_axes=(1,)),
        "w_up": ParamDef((m.num_experts, d, ffe),
                         ("experts", "embed", "expert_mlp"), fan_in_axes=(1,)),
        "w_down": ParamDef((m.num_experts, ffe, d),
                           ("experts", "expert_mlp", "embed"), fan_in_axes=(1,)),
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


def _local_expert_pass(x_flat, topk_idx, topk_w, wg, wu, wd, cfg: ModelConfig,
                       first_global_expert: int = 0):
    """Capacity-gather each local expert's tokens, FFN, weighted scatter-add.

    x_flat: (T, D); wg/wu/wd: (E_local, ...) local expert stacks, the
    experts ``first_global_expert`` onwards.  Experts add into the
    accumulator one after another in expert order; within an expert the
    selected rows are distinct, so ``index_add`` is exact.  Returns the
    summed contribution (T, D) of the local experts.
    """
    t_local = x_flat.shape[0]
    cap = _capacity(t_local, cfg)
    acc = torch.zeros_like(x_flat)
    for e in range(wg.shape[0]):
        # per-token weight for this expert (0 if not routed here)
        hit = topk_idx == first_global_expert + e                       # (T, K)
        w_tok = torch.where(hit, topk_w, torch.zeros_like(topk_w)).sum(dim=-1)
        sel_w, sel_idx = _top_k(w_tok, cap)                            # capacity
        xs = x_flat[sel_idx]                                            # (C, D)
        y = _expert_ffn(xs, wg[e], wu[e], wd[e])                        # (C, D)
        y = y * sel_w[:, None].to(y.dtype)          # weight (0 for non-routed)
        acc = acc.index_add(0, sel_idx, y)
    return acc


def _expert_ffn(xs, w_g, w_u, w_d):
    h = F.silu(torch.matmul(xs, w_g.to(xs.dtype))) * torch.matmul(
        xs, w_u.to(xs.dtype))
    return torch.matmul(h, w_d.to(xs.dtype))


def _aux_loss(probs, topk_idx, cfg: ModelConfig, sh=None):
    """Switch-style load-balance loss: E * sum_e f_e * p_e.

    Under a sharding ``sh`` whose batch splits over several ranks, the
    fractions are summed over the batch axes before the product
    (``reduce_from``: each rank's gradient is its own tokens'), so the loss
    is that of every rank's tokens together.
    """
    e = cfg.moe.num_experts
    hits = F.one_hot(topk_idx[..., 0], e).to(torch.float32)     # primary expert
    if sh is None or sh.batch_shards == 1:
        f = hits.mean(dim=0)
        p = probs.mean(dim=0)
        return e * torch.sum(f * p)
    t = probs.shape[0] * sh.batch_shards
    f, p = hits.sum(dim=0), probs.sum(dim=0)
    for axis in sh.batch_axes:
        f = coll.reduce_from(f, sh.mesh, axis)
        p = coll.reduce_from(p, sh.mesh, axis)
    return e * torch.sum((f / t) * (p / t))


def ep_shards(cfg: ModelConfig, mesh=None) -> int:
    """The expert-parallel degree under ``mesh`` (default: the current one):
    the ``model`` size of a distributed mesh when it is above 1 and divides
    the expert count, else 1 (the single-device path)."""
    mesh = mesh_lib.current_mesh() if mesh is None else mesh
    if mesh is None or not mesh.distributed or "model" not in mesh.axes:
        return 1
    n = mesh.axis_size("model")
    return n if n > 1 and cfg.moe.num_experts % n == 0 else 1


def moe_fwd(params: dict, x: torch.Tensor, cfg: ModelConfig,
            scoring: str = "softmax", sh=None):
    """x: (B, S, D) -> (out (B, S, D), aux_loss scalar).  ``sh``: the
    training sharding (``models.common.Sharding``; the layer's pspecs are
    ``sh.layer_specs["moe"]``), or None."""
    m = cfg.moe
    b, s, d = x.shape
    x_flat = x.reshape(-1, d)
    n = ep_shards(cfg)
    if n > 1:
        mesh = mesh_lib.current_mesh()
        t = x_flat.shape[0]
        if m.ep_impl == "a2a" and t % n == 0 and t >= n * n:
            out_flat, aux = _moe_ep_a2a(params, x_flat, cfg, mesh, scoring,
                                        sh)
        else:
            out_flat, aux = _moe_ep_psum(params, x_flat, cfg, mesh, scoring,
                                         sh)
    else:
        if params["w_gate"].shape[0] != m.num_experts:
            raise ValueError(f"expert stacks hold {params['w_gate'].shape[0]} "
                             f"of {m.num_experts} experts outside an "
                             f"expert-parallel mesh")
        topk_idx, topk_w, probs = _routing(params["router"], x_flat, cfg,
                                           scoring)
        out_flat = _local_expert_pass(x_flat, topk_idx, topk_w,
                                      params["w_gate"], params["w_up"],
                                      params["w_down"], cfg, 0)
        aux = _aux_loss(probs, topk_idx, cfg, sh)
    out = out_flat.reshape(b, s, d)
    if m.num_shared_experts:
        # site path matches the param tree ("…/moe/shared/w_up"); the
        # routed experts above are not dense sites and stay float
        with site_scope("shared"):
            tp = None if sh is None else tp_of(
                sh, sh.layer_specs["moe"]["shared"]["w_up"][-1])
            out = out + mlp_fwd(params["shared"], x, cfg, tp=tp)
    return out, aux


def _local_experts(params, cfg: ModelConfig, mesh):
    """This ``model`` rank's (E_local, ...) expert stacks and its first
    global expert: the stacks as given when they hold E / n experts, else
    sliced from the whole stacks."""
    n, r = mesh.axis_size("model"), mesh.axis_index("model")
    e = cfg.moe.num_experts
    e_local = e // n
    stacks = []
    for name in EXPERT_LEAVES:
        w = params[name]
        if w.shape[0] == e:
            w = w[r * e_local:(r + 1) * e_local]
        elif w.shape[0] != e_local:
            raise ValueError(f"{name} holds {w.shape[0]} experts; an "
                             f"expert-parallel rank of {n} wants {e_local} "
                             f"(or all {e})")
        stacks.append(w)
    return (*stacks, r * e_local)


def _moe_ep_psum(params, x_flat, cfg: ModelConfig, mesh, scoring="softmax",
                 sh=None):
    """Every rank routes all tokens, runs its own experts, and one
    ``all_reduce(SUM)`` over ``model`` combines; aux is the same on every
    rank."""
    wg, wu, wd, first = _local_experts(params, cfg, mesh)
    topk_idx, topk_w, probs = _routing(params["router"], x_flat, cfg, scoring)
    out = _local_expert_pass(coll.copy_to(x_flat, mesh), topk_idx,
                             coll.copy_to(topk_w, mesh), wg, wu, wd, cfg, first)
    return coll.reduce_from(out, mesh), _aux_loss(probs, topk_idx, cfg, sh)


def _moe_ep_a2a(params, x_flat, cfg: ModelConfig, mesh, scoring="softmax",
                sh=None):
    """All-to-all dispatch: route this rank's T / n token slice, build the
    (E, C, D) send buffer (capacity from the slice), exchange (n, E_local,
    C, D) blocks with the expert owners, run the local experts on
    (E_local, n·C, D), exchange back, weighted scatter-add, then
    ``all_reduce(SUM)`` of the reassembled (T, D) block.  aux is the mean
    over the ``model`` ranks of each slice's loss, as in the reference;
    under a sharding ``sh`` a slice's fractions are those of the same slice
    of every batch rank together (:func:`_aux_loss`)."""
    n, r = mesh.axis_size("model"), mesh.axis_index("model")
    wg, wu, wd, _ = _local_experts(params, cfg, mesh)
    t, d = x_flat.shape
    e = cfg.moe.num_experts
    e_local = e // n
    t_slice = t // n
    # the rank routes its own token slice: the router's and the tokens'
    # gradients are partial on each rank, so they enter through copy_to
    x_my = coll.copy_to(x_flat, mesh)[r * t_slice:(r + 1) * t_slice]
    topk_idx, topk_w, probs = _routing(coll.copy_to(params["router"], mesh),
                                       x_my, cfg, scoring)
    cap = _capacity(t_slice, cfg)
    w_tok = torch.zeros((t_slice, e), dtype=x_flat.dtype, device=x_flat.device)
    w_tok = w_tok.scatter_add(1, topk_idx, topk_w.to(x_flat.dtype))  # (T_s, E)
    sel_w, sel_idx = _top_k(w_tok.transpose(0, 1), cap)           # (E, C)
    send = x_my[sel_idx.reshape(-1)].reshape(n, e_local, cap, d)
    recv = coll.all_to_all(send, mesh)                  # (n, E_local, C, D)
    recv = recv.transpose(0, 1).reshape(e_local, n * cap, d)
    ys = torch.stack([_expert_ffn(recv[i], wg[i], wu[i], wd[i])
                      for i in range(e_local)])         # (E_local, n*C, D)
    ys = ys.reshape(e_local, n, cap, d).transpose(0, 1).contiguous()
    back = coll.all_to_all(ys, mesh)                    # (n, E_local, C, D)
    back = back.reshape(e, cap, d)
    out_my = torch.zeros((t_slice, d), dtype=x_flat.dtype,
                         device=x_flat.device)
    out_my = out_my.index_add(
        0, sel_idx.reshape(-1),
        (back * sel_w[..., None].to(back.dtype)).reshape(-1, d))
    out = torch.cat([torch.zeros((r * t_slice, d), dtype=x_flat.dtype,
                                 device=x_flat.device), out_my,
                     torch.zeros((t - (r + 1) * t_slice, d),
                                 dtype=x_flat.dtype, device=x_flat.device)])
    aux = coll.reduce_from(_aux_loss(probs, topk_idx, cfg, sh), mesh)
    return coll.reduce_from(out, mesh), aux / n
