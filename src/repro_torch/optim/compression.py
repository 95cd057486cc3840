"""Gradient compression: per-tensor int8 quantization with error feedback.

Error feedback (Seide et al. / EF-SGD): the quantization residual is carried
into the next step, so the compression bias vanishes over steps.  This is
the numerics-only hook inside the optimizer (``--compress-grads``).  The
reference's ``int8_psum`` (an int8 all-reduce over a mesh's ``data`` axis)
belongs to training on a mesh, which is not ported yet: the port's meshes
(``launch.mesh``) serve only so far (ROADMAP Queue 1 item 6, its training
part).
"""

from __future__ import annotations

import torch

__all__ = ["quantize_int8", "dequantize_int8", "compress_with_error_feedback"]


def quantize_int8(g: torch.Tensor):
    """Per-tensor symmetric int8.  Returns (codes, scale)."""
    amax = torch.amax(torch.abs(g))
    scale = torch.clamp(amax, min=1e-12) / 127.0
    codes = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return codes, scale


def dequantize_int8(codes: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return codes.to(torch.float32) * scale


def compress_with_error_feedback(grads: dict, ef: dict):
    """Quantize each grad tensor to int8, carrying the residual in ``ef``.

    ``grads`` and ``ef`` are nested dicts of one shape; returns new
    ``(grads, ef)`` trees of float32 tensors.
    """
    if isinstance(grads, dict):
        pairs = {k: compress_with_error_feedback(grads[k], ef[k]) for k in grads}
        return ({k: p[0] for k, p in pairs.items()},
                {k: p[1] for k, p in pairs.items()})
    g32 = grads.to(torch.float32) + ef
    deq = dequantize_int8(*quantize_int8(g32))
    return deq, g32 - deq
