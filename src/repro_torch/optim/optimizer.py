"""AdamW + schedules + clipping (no optimizer library).

Parameters, moments and gradients are nested dicts of tensors in the
parameter tree's layout.  Unlike the reference, which returns new trees,
:func:`adamw_update` updates the parameters and moments **in place** (and
scales float32 gradients in place while clipping): at llama3-8b width every
full-size temporary costs gigabytes.  Step counters, learning rates and bias
corrections are 0-dim float32 tensors on the host, used as scalars.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

__all__ = [
    "AdamWConfig", "OptState", "adamw_init", "adamw_update",
    "clip_by_global_norm", "global_norm",
    "cosine_schedule", "linear_schedule", "constant_schedule",
]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float | None = 1.0
    state_dtype: str = "float32"        # "bfloat16" halves m/v memory
    # int8 gradient compression with error feedback (optim.compression)
    compress_grads: bool = False


@dataclasses.dataclass
class OptState:
    step: torch.Tensor                  # 0-dim int32, on the host
    m: dict
    v: dict
    ef: dict | None = None              # error-feedback residuals


def _map(fn, tree, *rest):
    if isinstance(tree, dict):
        return {k: _map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    return fn(tree, *rest)


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


def _state_dtype(cfg: AdamWConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.state_dtype == "bfloat16" else torch.float32


def adamw_init(params: dict, cfg: AdamWConfig) -> OptState:
    dt = _state_dtype(cfg)

    def zeros(p, dtype=dt):
        return torch.zeros(p.shape, dtype=dtype, device=p.device)

    ef = _map(lambda p: zeros(p, torch.float32), params) if cfg.compress_grads else None
    return OptState(step=torch.zeros((), dtype=torch.int32),
                    m=_map(zeros, params), v=_map(zeros, params), ef=ef)


def _sliced_axes(specs) -> list:
    """Per leaf (in ``_leaves`` order), the mesh axes it is sliced over."""
    return [tuple(sorted({a for a in spec if a is not None}))
            for spec in _leaves(specs)] if specs is not None else None


def global_norm(tree, sharded=None) -> torch.Tensor:
    """The L2 norm of every leaf together.  ``sharded`` = ``(mesh, specs)``:
    the leaves are a rank's slices by the pspec tree ``specs``; each leaf's
    sum of squares is summed over the axes it is sliced on, so a replicated
    leaf counts once."""
    sq = [torch.sum(torch.square(x.to(torch.float32))) for x in _leaves(tree)]
    if sharded is None:
        return torch.sqrt(sum(sq))
    from repro_torch.launch import collectives as coll
    mesh, specs = sharded
    groups: dict = {}
    for axes, s in zip(_sliced_axes(specs), sq):
        groups[axes] = groups.get(axes, 0.0) + s
    total = 0.0
    for axes, s in sorted(groups.items()):
        s = s.clone()
        for axis in axes:
            group = coll.axis_group(mesh, axis)
            if group is not None:
                coll.all_reduce_(s, group)
        total = total + s
    return torch.sqrt(total)


def clip_by_global_norm(grads: dict, max_norm: float, sharded=None):
    """Scale ``grads`` to a global norm of at most ``max_norm``.

    Returns (float32 grads, norm); float32 leaves are scaled in place.
    """
    norm = global_norm(grads, sharded)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return _map(lambda g: g.to(torch.float32).mul_(scale), grads), norm


def adamw_update(grads: dict, state: OptState, params: dict, cfg: AdamWConfig,
                 lr: torch.Tensor | float, sharded=None):
    """One AdamW step, in place.  Returns (params, new_state, metrics).

    Clip by global norm, bias-corrected moments, decoupled weight decay on
    matrices (``ndim >= 2``) only -- the reference's update, term for term.
    ``params`` and the moment trees are the caller's, updated in place.
    ``sharded`` = ``(mesh, specs)``: every tree holds a rank's slices by the
    pspec tree ``specs`` and the gradients are whole-batch; the norm and the
    compression scales are then the whole leaves', the update slice-wise.
    """
    metrics = {}
    if cfg.compress_grads and state.ef is not None:
        from repro_torch.optim.compression import compress_with_error_feedback
        grads, new_ef = compress_with_error_feedback(grads, state.ef, sharded)
    else:
        new_ef = state.ef

    if cfg.clip_norm is not None:
        grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm, sharded)
    else:
        grads = _map(lambda g: g.to(torch.float32), grads)
        gnorm = global_norm(grads, sharded)
    metrics["grad_norm"] = gnorm

    step = state.step + 1
    f32 = torch.float32
    c1 = 1.0 - torch.pow(torch.tensor(cfg.b1, dtype=f32), step.to(f32))
    c2 = 1.0 - torch.pow(torch.tensor(cfg.b2, dtype=f32), step.to(f32))
    lr = torch.as_tensor(lr, dtype=f32)

    @torch.no_grad()
    def upd(p, g, m, v):
        m32, v32 = m.to(f32), v.to(f32)
        m32.mul_(cfg.b1).add_(g, alpha=1 - cfg.b1)
        v32.mul_(cfg.b2).addcmul_(g, g, value=1 - cfg.b2)
        delta = torch.div(v32, c2).sqrt_().add_(cfg.eps)
        delta = torch.div(m32, c1).div_(delta)
        p32 = p.to(f32)
        if p.ndim >= 2:  # decoupled weight decay on matrices only
            delta.add_(p32, alpha=cfg.weight_decay)
        p32.sub_(delta.mul_(lr))
        for dst, src in ((p, p32), (m, m32), (v, v32)):
            if dst is not src:
                dst.copy_(src)
        return p

    _map(upd, params, grads, state.m, state.v)
    return params, OptState(step=step, m=state.m, v=state.v, ef=new_ef), metrics


# ---------------------------------------------------------------------------
# Schedules: step (int or 0-dim tensor) -> 0-dim float32 tensor
# ---------------------------------------------------------------------------

def cosine_schedule(base_lr: float, warmup: int, total: int,
                    min_frac: float = 0.1) -> Callable:
    def f(step):
        step = torch.as_tensor(step).to(torch.float32)
        warm = base_lr * step / max(warmup, 1)
        prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = base_lr * (min_frac + (1 - min_frac) * 0.5
                         * (1 + torch.cos(math.pi * prog)))
        return torch.where(step < warmup, warm, cos)
    return f


def linear_schedule(base_lr: float, warmup: int, total: int) -> Callable:
    def f(step):
        step = torch.as_tensor(step).to(torch.float32)
        warm = base_lr * step / max(warmup, 1)
        prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        return torch.where(step < warmup, warm, base_lr * (1 - prog))
    return f


def constant_schedule(base_lr: float) -> Callable:
    return lambda step: torch.full((), base_lr, dtype=torch.float32)
