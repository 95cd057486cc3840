"""INT2/4/8 symmetric quantization used by every unary/binary GEMM backend.

The paper evaluates integer GEMM units at w ∈ {2, 4, 8} bits.  We use symmetric
(zero-point-free) quantization so that the temporal-unary encodings — which
represent signed magnitudes as runs of 1s — map directly onto quantized values:

    q = clip(round(x / s), -Vmax, Vmax),   Vmax = 2^(w-1) - 1

Weights are quantized per output channel (axis=-1 of the (in, out) matrix),
activations per tensor (or per row), matching common INT-inference practice.

Bit-exactness with the reference quantizer rests on three choices kept here:
the scale is ``max(amax, finfo.tiny) * fl32(1 / Vmax)`` — the reference
writes ``amax / Vmax``, and XLA compiles a division by that constant as a
multiply by its float32 reciprocal, which differs from a true division in
the last ulp for Vmax in {3, 7, 127}; the codes come from a *true division*
``x / scale`` (there a reciprocal-multiply would flip codes at ties); and
``torch.round`` rounds half to even like ``jnp.round``.

Stochastic rounding takes its noise from an explicit ``torch.Generator``
(the reference draws it with ``jax.random.uniform``, whose bits torch does
not reproduce); given the same uniform draw, :func:`_stochastic_codes`
rounds exactly as the reference does.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = [
    "Quantized",
    "vmax",
    "quantize",
    "dequantize",
    "quantize_per_channel",
    "quantize_per_tensor",
    "quantize_per_row",
    "fake_quant",
]


def vmax(bits: int) -> int:
    """Largest representable magnitude for a signed w-bit integer (symmetric)."""
    if bits < 2:
        raise ValueError(f"bits must be >= 2, got {bits}")
    return 2 ** (bits - 1) - 1


@dataclasses.dataclass
class Quantized:
    """A quantized tensor: integer values + float scale(s).

    ``values`` has an integer dtype (int8 container for all of w∈{2,4,8});
    ``scale`` broadcasts against ``values`` so ``values * scale ≈ original``.
    """

    values: torch.Tensor
    scale: torch.Tensor
    bits: int

    def dequantize(self) -> torch.Tensor:
        return self.values.to(self.scale.dtype) * self.scale

    @property
    def shape(self):
        return tuple(self.values.shape)


def _inv_vmax(bits: int) -> float:
    """``1 / Vmax`` rounded to float32 (see the module docstring)."""
    return float(np.float32(1.0) / np.float32(vmax(bits)))


def _scale_from_amax(amax: torch.Tensor, bits: int) -> torch.Tensor:
    # All-zero channels: the reference clamps amax to finfo.tiny, and the
    # product tiny * (1/Vmax) is subnormal for Vmax > 1, which XLA flushes to
    # zero.  The flush is written out here so the scale is the same on every
    # device; _codes never divides by such a scale.
    tiny = torch.finfo(amax.dtype).tiny
    scale = torch.clamp(amax, min=tiny) * _inv_vmax(bits)
    return torch.where(scale < tiny, torch.zeros_like(scale), scale)


def _absmax_scale(x: torch.Tensor, bits: int, axes: tuple[int, ...]) -> torch.Tensor:
    if axes:
        amax = torch.amax(torch.abs(x), dim=axes, keepdim=True)
    else:  # 0-d input: nothing to reduce
        amax = torch.abs(x)
    return _scale_from_amax(amax, bits)


def _codes(x: torch.Tensor, scale: torch.Tensor, bits: int) -> torch.Tensor:
    v = vmax(bits)
    # a flushed (zero) scale marks an all-zero channel: its codes are zero
    safe = torch.where(scale == 0, torch.ones_like(scale), scale)
    return torch.clamp(torch.round(x / safe), -v, v).to(torch.int8)


def _stochastic_codes(x: torch.Tensor, scale: torch.Tensor, bits: int,
                      u: torch.Tensor) -> torch.Tensor:
    """Stochastic rounding of ``x / scale`` given a uniform draw ``u`` in
    [0, 1) of ``x``'s shape and dtype: ``floor(y + 0.5 + (u - 0.5))``,
    evaluated in the reference's order, then clipped like :func:`_codes`."""
    v = vmax(bits)
    safe = torch.where(scale == 0, torch.ones_like(scale), scale)
    y = x / safe
    q = torch.floor((y + 0.5) + (u.to(x.dtype) - 0.5))
    return torch.clamp(q, -v, v).to(torch.int8)


def quantize(x: torch.Tensor, bits: int = 8, per_channel: bool = True,
             stochastic_rounding: bool = False,
             generator: torch.Generator | None = None) -> Quantized:
    """Symmetric absmax quantization to w-bit signed integers (int8 container).

    ``per_channel`` reduces the scale over all-but-last axis (one scale per
    output channel of an ``(in, out)`` weight); otherwise one scale for the
    whole tensor.  ``stochastic_rounding`` rounds ``x / scale`` up with
    probability equal to its fractional part, drawing the uniform noise from
    ``generator`` (required; a ``torch.Generator`` on ``x``'s device).
    """
    if per_channel and x.ndim >= 2:
        axes = tuple(range(x.ndim - 1))
    else:
        axes = tuple(range(x.ndim))
    scale = _absmax_scale(x, bits, axes)
    if stochastic_rounding:
        if generator is None:
            raise ValueError("stochastic_rounding requires generator")
        u = torch.rand(x.shape, generator=generator, dtype=x.dtype,
                       device=x.device)
        values = _stochastic_codes(x, scale, bits, u)
    else:
        values = _codes(x, scale, bits)
    return Quantized(values=values, scale=scale.to(torch.float32), bits=bits)


def quantize_per_channel(x: torch.Tensor, bits: int = 8) -> Quantized:
    return quantize(x, bits=bits, per_channel=True)


def quantize_per_tensor(x: torch.Tensor, bits: int = 8) -> Quantized:
    return quantize(x, bits=bits, per_channel=False)


def quantize_per_row(x: torch.Tensor, bits: int = 8) -> Quantized:
    """Symmetric absmax quantization with one scale per *row* (axis=-1
    reduced).

    For a ``(rows, k)`` activation batch each row gets its own scale, so
    one row's outlier magnitude cannot coarsen another row's grid — the
    per-row option ``models/common.dense`` uses to make co-batched serve
    traffic rows independent.  At a single row this is exactly per-tensor
    quantization.
    """
    scale = _absmax_scale(x, bits, axes=(x.ndim - 1,))
    return Quantized(values=_codes(x, scale, bits),
                     scale=scale.to(torch.float32), bits=bits)


def dequantize(q: Quantized) -> torch.Tensor:
    return q.dequantize()


def fake_quant(x: torch.Tensor, bits: int = 8,
               per_channel: bool = True) -> torch.Tensor:
    """Quantize-dequantize in the original dtype (QAT forward / error studies)."""
    return quantize(x, bits=bits, per_channel=per_channel).dequantize().to(x.dtype)
