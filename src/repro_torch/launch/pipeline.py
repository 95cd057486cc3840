"""GPipe-style layer pipeline over the ``pod`` axis.

Layers are split into ``P`` contiguous stages (:func:`split_stages`) and
``M`` microbatches stream through them on the reference's schedule: at
tick ``t`` stage 0 ingests microbatch ``t``, every other stage takes what
the stage before it produced at tick ``t - 1``, and the last stage emits
microbatch ``t - (P - 1)``; ``T = M + P - 1`` ticks in all.  Gradients come
from autograd through the same schedule.  Two executors, picked by the
mesh (``launch.mesh.make_pipeline_mesh``):

* **Distributed** (a ``torch.distributed`` mesh with a ``pod`` axis, one
  rank a stage): the reference's ``shard_map`` body on every rank.  The
  rank takes its own stage's parameters, steps every tick in lockstep with
  the other ranks, and hands its activation to the next stage with
  ``collectives.shift`` (the reference's ``lax.ppermute``, whose backward
  is the reverse permute).  At an idle tick (fill and drain) it computes
  on zeros, as the reference does, so every rank's autograd graph is one
  chain over the ticks and the backward meets the hand-offs in the same
  reverse order on every rank.  The emits are summed over ``pod``
  (``reduce_from``, the reference's ``psum``), so every rank holds the
  whole output; ``x`` enters through ``copy_to``, so every rank holds
  ``dL/dx``.  Other axes of the mesh (``data``) each run their own
  pipeline on their own ``x``.
* **Local** (no process group, every stage on one device): the stages are
  handed over on that device, and a stage that holds no microbatch at a
  tick runs nothing, so a call makes ``P * M`` stage calls; the idle ticks
  of the reference compute on zeros whose results never reach an emitted
  microbatch, so the outputs are the same.  A local mesh whose stages sit
  on several devices raises: run one rank a stage under ``torchrun``.

:func:`bubble_fraction` is the share of the schedule the idle ticks take,
``(P - 1) / (M + P - 1)``.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch.utils import _pytree as pytree

from repro_torch.launch import collectives as coll

__all__ = ["pipeline_apply", "split_stages", "bubble_fraction"]


def split_stages(stacked_params, n_stages: int):
    """Reshape stacked (L, ...) layer params into (n_stages, L/n_stages, ...)."""
    def rs(a):
        l = a.shape[0]
        if l % n_stages:
            raise ValueError(f"{l} layers not divisible by {n_stages} stages")
        return a.reshape(n_stages, l // n_stages, *a.shape[1:])
    return pytree.tree_map(rs, stacked_params)


def bubble_fraction(n_stages: int, n_micro: int) -> float:
    """Idle share of the reference's GPipe schedule: ``(P-1)/(M+P-1)``."""
    return (n_stages - 1) / (n_micro + n_stages - 1)


def pipeline_apply(stage_fn: Callable, staged_params, x, mesh,
                   axis: str = "pod"):
    """Run ``x``'s microbatches through the layer pipeline.

    stage_fn(stage_params, h) -> h : applies ONE stage's layers.
    staged_params: tree with leading (n_stages, ...) axis (see split_stages);
      on a distributed mesh a leaf may instead have a leading axis of 1 and
      hold only this rank's stage, as ``shard_map`` hands a pod its slice.
    x: (n_micro, mb, ...) microbatched activations (the same on every rank
      of ``axis``).
    Returns (n_micro, mb, ...) outputs (on every rank of ``axis``).
    """
    if mesh.distributed:
        return _pipeline_on_mesh(stage_fn, staged_params, x, mesh, axis)
    n_stages = mesh.axis_size(axis)
    if len(set(mesh.devices)) > 1:
        raise RuntimeError(
            f"a pipeline with stages on {len(set(mesh.devices))} devices runs "
            f"one rank a stage: start {n_stages} processes under torchrun "
            f"(or call launch.mesh.init_distributed in each) and build the "
            f"mesh with make_pipeline_mesh({n_stages})")
    n_micro = x.shape[0]
    stages = [pytree.tree_map(lambda a, p=p: a[p], staged_params)
              for p in range(n_stages)]
    held: list[torch.Tensor | None] = [None] * n_stages
    outs: list[torch.Tensor | None] = [None] * n_micro
    for t in range(n_micro + n_stages - 1):
        # hand-off: each stage takes what the stage before it produced
        held = [x[t] if t < n_micro else None] + held[:-1]
        held = [None if h is None else stage_fn(stages[p], h)
                for p, h in enumerate(held)]
        out_idx = t - (n_stages - 1)
        if 0 <= out_idx < n_micro:
            outs[out_idx] = held[-1]
    return torch.stack(outs)


def _pipeline_on_mesh(stage_fn, staged_params, x, mesh, axis):
    """The reference's ``shard_map`` body on this rank (see the module
    docstring).  Every tensor a rank receives stays in its graph (a
    ``torch.where`` on its position, never a Python branch), so that each
    rank runs every hand-off's backward and the sends meet their
    receives."""
    n_stages = mesh.axis_size(axis)
    p = mesh.axis_index(axis)

    def own(a):
        if a.shape[0] == n_stages:
            return a[p]
        if a.shape[0] == 1:
            return a[0]
        raise ValueError(f"a staged leaf of leading dimension {a.shape[0]} on "
                         f"a {n_stages}-stage mesh: want {n_stages} (every "
                         f"stage) or 1 (this rank's)")

    params = pytree.tree_map(own, staged_params)
    group = coll.axis_group(mesh, axis)
    if group is not None and x.device.type == "cuda":
        # NCCL wants every rank of a group in the first call on it, which a
        # point-to-point call need not have; a barrier first is collective
        torch.distributed.barrier(group=group)
    x = coll.copy_to(x, mesh, axis)
    n_micro = x.shape[0]
    ticks = n_micro + n_stages - 1
    first = torch.tensor(p == 0, device=x.device)
    last = torch.tensor(p == n_stages - 1, device=x.device)
    zeros = x.new_zeros(x.shape[1:])
    buf = zeros
    outs = []
    for t in range(ticks):
        # stage 0 ingests microbatch t (zeros once the stream dries up)
        buf = torch.where(first, x[t] if t < n_micro else zeros, buf)
        buf = stage_fn(params, buf)
        # the last stage emits microbatch t - (P - 1)
        if t >= n_stages - 1:
            outs.append(torch.where(last, buf, zeros))
        if t < ticks - 1:       # what the last tick would hand on is unused
            buf = coll.shift(buf, mesh, axis)
    # the emits live on the last stage only: sum-replicate across stages
    return coll.reduce_from(torch.stack(outs), mesh, axis)
