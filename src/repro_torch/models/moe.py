"""Mixture-of-Experts: routing, capacity-bounded experts, aux, and expert
parallelism over the ``model`` axis of a distributed mesh.

Routing: softmax scoring (Switch/Mixtral; every registered MoE arch, as in
the reference; ``_routing`` also takes DeepSeek-V3's sigmoid), top-k with
renormalization, optional shared (always-on) experts, and a
Switch-style load-balance auxiliary loss.  Each expert takes the ``cap``
tokens of largest weight for it (:func:`_capacity`); a token routed to a
full expert is dropped there, and tokens not routed to it ride along with
weight 0.

In :func:`moe_fwd` (the forward, training and one-shot serve paths) the
router and the routed experts' matmuls are float and are not dense sites,
even under a backend or plan scope; only the shared expert's ``w_gate`` /
``w_up`` / ``w_down`` are sites (``…/moe/shared/w_up``).

Serving (:func:`moe_serve`, which ``ServingEngine``'s prefill and decode
step run) is dropless: every (row, expert) pair routed to an expert this
rank holds is computed, and rows no request holds (idle decode slots, a
prefill group's padding) reach no expert.  Routing is softmax top-k
renormalized, or under a ``SparseMixerMoEConfig`` Phi-3.5-MoE's top-2
(:func:`sparsemixer`); the router stays a float matmul, its float32 logits
accumulated in float64 so that a row's routing does not depend on the rows
that share its call.  Each local expert's ``w_gate`` / ``w_up`` /
``w_down`` are dense sites (``layers/moe/w_up``), so a backend scope
contracts them on its unit.
The prefill gathers each expert's routed rows, their count read to the
host once a layer; the decode step hands every local expert the step's
whole block of slots, unrouted rows zeroed, and reads nothing on the host.
Under an expert-parallel mesh the ranks' partial outputs are added by one
``all_reduce(SUM)`` a layer (the psum layout).  Spans (``runtime.spans``):
``moe`` (the layer), ``moe.route`` (router and routing), ``moe.dispatch``
(the rows each local expert takes), ``moe.experts`` (the experts' sites),
``moe.combine`` (weighting and scatter-add), ``moe.exchange`` (the
``all_reduce``).

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

import dataclasses
import math

import torch
import torch.nn.functional as F

from repro_torch.backends.runtime import site_scope
from repro_torch.launch import collectives as coll
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models.common import ParamDef, dense, tp_of
from repro_torch.models.config import ModelConfig, SparseMixerMoEConfig
from repro_torch.models.mlp import mlp_defs, mlp_fwd
from repro_torch.runtime import spans

__all__ = ["moe_defs", "moe_fwd", "ep_shards", "EXPERT_LEAVES", "Serving",
           "moe_serve", "sparsemixer"]

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


# ---------------------------------------------------------------------------
# The serving expert layer (ServingEngine's prefill and decode step)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Serving:
    """What :func:`moe_serve` is told of one call.

    ``live`` — (B, S) bool: the rows a request holds; the others (idle
    decode slots, a prefill group's padding) reach no expert.
    ``counts`` — an (L, E_local, 2) int64 tensor on the device, to which a
    layer adds, by local expert, its routed rows and 1 if it had any
    (None: nothing counted).
    ``mesh`` — the expert-parallel mesh (axis ``model``, one share of the
    experts a rank), None on one device.
    ``gather`` — True: each local expert contracts exactly its routed rows,
    their counts read to the host once a layer (prefill); False: each
    contracts the call's whole block of rows with the unrouted ones zeroed,
    and nothing is read on the host (the decode step).
    """
    live: torch.Tensor
    counts: torch.Tensor | None = None
    mesh: object = None
    gather: bool = True


def sparsemixer(logits: torch.Tensor, eps: float):
    """Phi-3.5-MoE's top-2 routing at inference (``modeling_phimoe.py``'s
    ``sparsemixer`` without training's jitter): (idx (T, 2), w (T, 2)).

    The first expert is the best logit ``m1``; its weight is the softmax,
    at it, of the logits with every ``j`` masked where ``(m1 - s_j) /
    max(|s_j|, m1) > 2 eps``.  The second is the best of the rest, weighted
    the same way over the rest.  The weights are not renormalized; ties go
    to the lower index.
    """
    idx, w = [], []
    scores = logits
    for _ in range(2):
        top, at = torch.max(scores, dim=-1, keepdim=True)
        band = (top - logits) / torch.maximum(logits.abs(), top)
        masked = scores.masked_fill(band > 2 * eps, float("-inf"))
        w.append(torch.softmax(masked, dim=-1).gather(-1, at))
        idx.append(at)
        scores = scores.scatter(-1, at, float("-inf"))
    return torch.cat(idx, dim=-1), torch.cat(w, dim=-1)


def _serve_routing(router_w, x_flat, cfg: ModelConfig):
    """(idx (T, K), w (T, K)): softmax top-k renormalized, or sparsemixer
    under a :class:`~repro_torch.models.config.SparseMixerMoEConfig`.  The
    float32 logits are accumulated in float64 and rounded once: a float32
    GEMM's summation order follows its shape, so its logits for a row would
    depend on how many rows share the call, and with them the experts a
    request is routed to."""
    m = cfg.moe
    sparse = isinstance(m, SparseMixerMoEConfig)
    if sparse and m.top_k != 2:
        raise ValueError(f"sparsemixer routes top-2, not top-{m.top_k}")
    logits = torch.matmul(x_flat.to(torch.float64),
                          router_w.to(torch.float64)).to(torch.float32)
    if sparse:
        return sparsemixer(logits, m.router_noise)
    w, idx = _top_k(torch.softmax(logits, dim=-1), m.top_k)
    return idx, w / torch.clamp(w.sum(dim=-1, keepdim=True), min=1e-9)


def _serve_experts(params, cfg: ModelConfig, mesh):
    """The local expert stacks and the first global expert: all of them on
    one device, the rank's share under an expert-parallel mesh."""
    if mesh is None:
        if params["w_gate"].shape[0] != cfg.moe.num_experts:
            raise ValueError(f"expert stacks hold {params['w_gate'].shape[0]} "
                             f"of {cfg.moe.num_experts} experts outside an "
                             f"expert-parallel mesh")
        return params["w_gate"], params["w_up"], params["w_down"], 0
    return _local_experts(params, cfg, mesh)


def _serve_ffn(xs, w_g, w_u, w_d, cfg: ModelConfig):
    """One expert's SwiGLU on its rows, each matmul a dense site."""
    h = F.silu(dense(w_g, xs, cfg, name="w_gate")) * dense(w_u, xs, cfg,
                                                           name="w_up")
    return dense(w_d, h, cfg, name="w_down")


def _exchange(out: torch.Tensor, mesh) -> torch.Tensor:
    """The ranks' partial outputs added: one ``all_reduce(SUM)`` over
    ``model`` (in place); nothing on one device."""
    group = coll.axis_group(mesh, "model")
    return out if group is None else coll.all_reduce_(out, group)


@torch.no_grad()
def moe_serve(params: dict, x: torch.Tensor, cfg: ModelConfig,
              serving: Serving, layer: int = 0) -> torch.Tensor:
    """The routed experts' output for ``x`` (B, S, D), dropless (see the
    module doc and :class:`Serving`); ``layer`` indexes ``serving.counts``.
    Each rank weights its experts' rows by their routing weights, adds them
    to their token rows in expert order, and the ranks' parts are summed."""
    if cfg.moe.num_shared_experts:
        raise ValueError("the serving expert layer has no shared experts")
    d = x.shape[-1]
    x_flat = x.reshape(-1, d)
    t = x_flat.shape[0]
    live = serving.live.reshape(-1)
    with spans.span("moe"):
        with spans.span("moe.route"):
            idx, w = _serve_routing(params["router"], x_flat, cfg)
        wg, wu, wd, first = _serve_experts(params, cfg, serving.mesh)
        n = wg.shape[0]
        with spans.span("moe.dispatch"):
            experts = torch.arange(n, device=x.device)
            # (T, K, E_local): pair k of row t goes to local expert e
            mine = ((idx - first)[..., None] == experts) & live[:, None, None]
            routed = mine.any(dim=1)                              # (T, E_local)
            weight = (mine * w[..., None]).sum(dim=1).to(x.dtype)
            rows_per = routed.sum(dim=0)
            if serving.counts is not None:
                serving.counts[layer] += torch.stack(
                    [rows_per, (rows_per > 0).to(rows_per.dtype)], dim=-1)
            if serving.gather:
                # each expert's routed rows, in expert then row order
                key = torch.where(routed.t(), experts[:, None], n).reshape(-1)
                rows = torch.sort(key, stable=True).indices % t
                sizes = rows_per.tolist()
                starts = [sum(sizes[:e]) for e in range(n)]
                picked = [rows[a: a + c] for a, c in zip(starts, sizes)]
                inputs = [x_flat[r] for r in picked]
            else:
                picked = [None] * n
                inputs = [torch.where(routed[:, e:e + 1], x_flat, 0.0)
                          for e in range(n)]
        with spans.span("moe.experts"):
            outs = [_serve_ffn(xs, wg[e], wu[e], wd[e], cfg)
                    if xs.shape[0] else None for e, xs in enumerate(inputs)]
        with spans.span("moe.combine"):
            acc = torch.zeros_like(x_flat)
            for e, (y, r) in enumerate(zip(outs, picked)):
                if y is None:
                    continue
                if r is None:
                    acc += y * weight[:, e:e + 1]
                else:
                    acc.index_add_(0, r, y * weight[r, e:e + 1])
        with spans.span("moe.exchange"):
            acc = _exchange(acc, serving.mesh)
    return acc.reshape(x.shape)
