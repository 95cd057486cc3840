"""Public wrappers around the kernels (the names the modeling layer and the
backend mirrors bind).

``quantized_matmul`` is the end-to-end float -> float op the
``cfg.quant_kernel`` path of ``models/common.dense`` calls: quantize
activations per tensor, pack the weight codes, run the packed integer
kernel with the folded dequant scales fused in.
"""

from __future__ import annotations

import torch

from repro_torch.core.quantization import Quantized, quantize
from repro_torch.kernels import bitsparsity as _bs
from repro_torch.kernels import quant_gemm as _qg
from repro_torch.kernels import unary_gemm as _ug
from repro_torch.kernels.ref import sparsity_from_sums

__all__ = ["pack_values", "int_matmul", "quantized_matmul", "tub_matmul",
           "tu_matmul", "bit_sparsity_stats"]


def pack_values(values: torch.Tensor, bits: int, axis: int = 0) -> torch.Tensor:
    """Pack w-bit signed codes (int8 container) ``8 // bits`` a byte along
    ``axis``, low nibble / crumb first."""
    if bits == 8:
        return values.to(torch.int8)
    pack = 8 // bits
    if values.shape[axis] % pack:
        raise ValueError(f"axis {axis} (len {values.shape[axis]}) not "
                         f"divisible by {pack}")
    v = torch.movedim(values.to(torch.int32), axis, 0)
    v = v.reshape(v.shape[0] // pack, pack, *v.shape[1:])
    mask = (1 << bits) - 1
    byte = torch.zeros(v.shape[:1] + v.shape[2:], dtype=torch.int32,
                       device=v.device)
    for i in range(pack):
        byte = byte | ((v[:, i] & mask) << (i * bits))
    # int8 container: bytes >= 128 wrap to negative, as in the reference
    byte = ((byte + 128) % 256 - 128).to(torch.int8)
    return torch.movedim(byte, 0, axis)


def int_matmul(x_q: torch.Tensor, w_packed: torch.Tensor, *,
               bits: int = 8) -> torch.Tensor:
    """Raw integer GEMM on the kernel (int8 x packed w -> int32)."""
    return _qg.quant_gemm(x_q, w_packed, None, bits=bits, fuse_dequant=False)


def quantized_matmul(x: torch.Tensor, w_q: Quantized, *, bits: int | None = None,
                     act_bits: int = 8) -> torch.Tensor:
    """float x (quantized weight) -> float via the packed integer kernel.

    ``w_q.values`` is (K, N) int8 codes with per-channel ``scale`` (1, N);
    activations are quantized per tensor to ``act_bits``.  The weight and
    activation scales are folded into one float32 product before the
    kernel, as the reference does; the output is cast back to ``x.dtype``.
    """
    bits = w_q.bits if bits is None else bits
    orig_shape = x.shape
    x2 = x.reshape(-1, orig_shape[-1])
    xq = quantize(x2, bits=act_bits, per_channel=False)
    w_packed = pack_values(w_q.values, bits, axis=0)
    scales = (w_q.scale.reshape(1, -1) * xq.scale.reshape(1, 1)).to(torch.float32)
    out = _qg.quant_gemm(xq.values, w_packed, scales, bits=bits,
                         fuse_dequant=True)
    return out.reshape(*orig_shape[:-1], out.shape[-1]).to(x.dtype)


def tub_matmul(a_q: torch.Tensor, b_q: torch.Tensor, *, bits: int = 8):
    """tubGEMM slot-loop GEMM.  ``a_q`` (M, K) w-bit codes, ``b_q`` (K, N)
    int8; returns ``((M, N) int32, wc_cycles)`` — bit-identical to binary
    GEMM, scheduled as the paper's 2-unary unit."""
    return _ug.tub_gemm(a_q, b_q, bits=bits)


def tu_matmul(a_q: torch.Tensor, b_q: torch.Tensor, *, bits: int = 8):
    """tuGEMM temporal slot-loop GEMM; returns ``((M, N) int32, wc_cycles)``
    with ``K * (2^(w-1))^2`` cycles."""
    return _ug.tu_gemm(a_q, b_q, bits=bits)


def bit_sparsity_stats(q: torch.Tensor, *, bits: int,
                       tile: int = 32) -> tuple[float, float]:
    """(word sparsity, block-max bit sparsity) of an int8 code matrix from
    the tile-statistics kernel, which also sums its two statistics on the
    tensor's device: one read of two integers reaches the host."""
    if q.ndim != 2:
        q = q.reshape(-1, q.shape[-1])
    _, _, sums = _bs.block_stats_with_sums(q, tile=tile)
    max_sum, zero_sum = sums.tolist()
    return sparsity_from_sums(max_sum, zero_sum, q.shape[0], q.shape[1],
                              bits, tile)
