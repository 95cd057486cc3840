"""Rotary position embeddings (half-split layout, computed in float32)."""

from __future__ import annotations

import torch

__all__ = ["rope_freqs", "apply_rope"]


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """Inverse frequencies for the even half of the head dimension."""
    half = head_dim // 2
    exponent = torch.arange(0, half, dtype=torch.float32, device=device) / half
    return 1.0 / (theta ** exponent)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """x: (..., S, H, D) rotated by ``positions`` (..., S) or (S,).

    The two halves of the head dimension are rotated against each other
    (``[x1, x2] -> [x1 cos - x2 sin, x1 sin + x2 cos]``), not interleaved
    pairs; the rotation runs in float32 and is cast back to ``x.dtype``.
    """
    d = x.shape[-1]
    inv = rope_freqs(d, theta, device=x.device)        # (d/2,)
    pos = positions.to(device=x.device, dtype=torch.float32)
    angles = pos[..., None] * inv                      # (..., S, d/2)
    angles = angles[..., None, :]                      # heads axis
    sin, cos = torch.sin(angles), torch.cos(angles)
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)
