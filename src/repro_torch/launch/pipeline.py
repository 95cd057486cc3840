"""GPipe-style layer pipeline over the ``pod`` axis, on one device.

Layers are split into ``P`` contiguous stages (:func:`split_stages`) and
``M`` microbatches stream through them on the reference's schedule: at
tick ``t`` stage 0 ingests microbatch ``t``, every other stage takes what
the stage before it produced at tick ``t - 1``, and the last stage emits
microbatch ``t - (P - 1)``.  Where the reference's ``shard_map`` passes
the activation to the next pod with a ``lax.ppermute``, the port hands the
tensor over on the one device; gradients come from autograd through the
same schedule.

A stage that holds no microbatch at a tick (the pipeline's fill and drain)
runs nothing, so a call makes ``P * M`` stage calls; in the reference those
idle ticks compute on zeros whose results never reach an emitted
microbatch, so the outputs are the same.  :func:`bubble_fraction` reports
the share of the reference schedule those ticks take, ``(P - 1) / (M + P -
1)``; nothing here executes it.

The mesh comes from ``launch.mesh.make_pipeline_mesh``: every stage on one
device.  A mesh whose stages sit on several devices raises
``NotImplementedError`` (ROADMAP Queue 1 item 6, multi-device meshes).
"""

from __future__ import annotations

from typing import Callable

import torch
from torch.utils import _pytree as pytree

from repro_torch.launch.mesh import _MULTI_DEVICE_MSG

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
    staged_params: tree with leading (n_stages, ...) axis (see split_stages).
    x: (n_micro, mb, ...) microbatched activations.
    Returns (n_micro, mb, ...) outputs.
    """
    n_stages = mesh.shape[mesh.axes.index(axis)]
    if len(set(mesh.devices)) > 1:
        raise NotImplementedError(
            f"a pipeline with stages on {len(set(mesh.devices))} devices "
            f"{_MULTI_DEVICE_MSG}")
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
