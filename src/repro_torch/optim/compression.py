"""Gradient compression: per-tensor int8 quantization with error feedback,
and an int8 all-reduce over a mesh axis.

Error feedback (Seide et al. / EF-SGD): the quantization residual is carried
into the next step, so the compression bias vanishes over steps.  Two
integration points, as in the reference:

* ``compress_with_error_feedback`` — the numerics-only hook inside the
  optimizer (``--compress-grads``); on a mesh each rank compresses its own
  slice with the whole leaf's scale.
* ``int8_psum`` — an all-reduce of int8-quantized gradients over one axis of
  a distributed mesh (a quarter of float32's payload, as int32 sums), a
  library function that no train step calls.
"""

from __future__ import annotations

import torch

from repro_torch.launch import collectives as coll

__all__ = ["quantize_int8", "dequantize_int8", "compress_with_error_feedback",
           "int8_psum"]


def quantize_int8(g: torch.Tensor, amax: torch.Tensor | None = None):
    """Per-tensor symmetric int8.  Returns (codes, scale); ``amax`` overrides
    ``max|g|`` (a sliced leaf's whole-leaf maximum)."""
    if amax is None:
        amax = torch.amax(torch.abs(g))
    scale = torch.clamp(amax, min=1e-12) / 127.0
    codes = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return codes, scale


def dequantize_int8(codes: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return codes.to(torch.float32) * scale


def compress_with_error_feedback(grads: dict, ef: dict, sharded=None):
    """Quantize each grad tensor to int8, carrying the residual in ``ef``.

    ``grads`` and ``ef`` are nested dicts of one shape; returns new
    ``(grads, ef)`` trees of float32 tensors.  ``sharded`` = ``(mesh,
    specs)``: the leaves are a rank's slices by the pspec tree ``specs``,
    and each takes its scale from the whole leaf's maximum.
    """
    if isinstance(grads, dict):
        pairs = {k: compress_with_error_feedback(
                     grads[k], ef[k],
                     None if sharded is None else (sharded[0], sharded[1][k]))
                 for k in grads}
        return ({k: p[0] for k, p in pairs.items()},
                {k: p[1] for k, p in pairs.items()})
    g32 = grads.to(torch.float32) + ef
    amax = None
    if sharded is not None:
        mesh, spec = sharded
        amax = coll.max_over(torch.amax(torch.abs(g32)), mesh,
                             [a for a in spec if a is not None])
    deq = dequantize_int8(*quantize_int8(g32, amax))
    return deq, g32 - deq


def int8_psum(grads, mesh, axis: str = "data"):
    """All-reduce a gradient tree over ``axis`` of a distributed ``mesh``
    with int8 payloads: a shared scale from the ``max`` of every rank's
    ``max|g|``, the int8 codes summed exactly as int32, then dequantized.
    A sum, not a mean; every rank of the axis must call it."""
    if isinstance(grads, dict):
        return {k: int8_psum(v, mesh, axis) for k, v in grads.items()}
    g32 = grads.to(torch.float32)
    amax = coll.max_over(torch.amax(torch.abs(g32)), mesh, axis)
    scale = torch.clamp(amax, min=1e-12) / 127.0
    codes = torch.clamp(torch.round(g32 / scale), -127, 127).to(torch.int32)
    group = coll.axis_group(mesh, axis)
    if group is not None:
        coll.all_reduce_(codes, group)
    return codes.to(torch.float32) * scale
