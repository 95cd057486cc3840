"""Plain PyTorch versions of the kernels (the correctness contract): each
mirrors one kernel's semantics — the slot-loop GEMMs slot by slot, the
packed GEMMs as unpack-then-contract, the tile statistics as a padded
reshape.

Slot contractions run per slot through :func:`_contractor`, which is an
integer matmul on the CPU and an exact K-chunked fp32 product on CUDA (CUDA
has no int32 matmul); either way every slot's pulse operand is formed and
accumulated on its own, as in the kernels.  The packed GEMMs contract in
float64, exact for int8 x int8 sums below 2^53 on either device.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import packing
from repro_torch.core.sparsity import _f32_mean

__all__ = ["tub_gemm_ref", "tu_gemm_ref", "unpack_values_ref",
           "quant_gemm_ref", "packed_gemm_ref", "block_stats_ref",
           "sparsity_from_sums", "sparsity_from_block_stats",
           "bit_sparsity_stats_ref"]

#: |pulse| <= 3 and |b| <= 128: 4096 * 3 * 128 < 2^24, so an fp32 product over
#: a K-chunk of 4096 is exact in any summation order.
_FP32_EXACT_CHUNK = 4096


def _contractor(b: torch.Tensor):
    """``contract(pulses)``: (M,K) small-int pulses @ ``b`` -> (M,N) int32,
    exactly; ``b`` is converted once for all the slots."""
    if b.device.type != "cuda":
        b32 = b.to(torch.int32)
        return lambda pulses: torch.matmul(pulses, b32)
    chunks = [(lo, b[lo: lo + _FP32_EXACT_CHUNK].to(torch.float32))
              for lo in range(0, b.shape[0], _FP32_EXACT_CHUNK)]

    def contract(pulses: torch.Tensor) -> torch.Tensor:
        out = torch.zeros((pulses.shape[0], b.shape[1]), dtype=torch.int32,
                          device=b.device)
        pf = pulses.to(torch.float32)
        for lo, bf in chunks:
            out += torch.matmul(pf[:, lo: lo + _FP32_EXACT_CHUNK],
                                bf).to(torch.int32)
        return out

    return contract


def tub_gemm_ref(a: torch.Tensor, b: torch.Tensor, *, bits: int = 8) -> torch.Tensor:
    """Slot-by-slot mirror of the tubGEMM kernel's 2-unary schedule.

    ``|a| = 2*v1 + v0``; slot ``t`` of ``max(1, 2^(bits-2))`` adds
    ``((2*[t < v1] + [t == 0]*v0) * sign(a)) @ b``.  Equal to int32 GEMM by
    the paper's equivalence argument.
    """
    a32 = a.to(torch.int32)
    mag, sgn = torch.abs(a32), torch.sign(a32)
    v1, v0 = mag // 2, mag % 2
    out = torch.zeros((a.shape[0], b.shape[1]), dtype=torch.int32,
                      device=a.device)
    contract = _contractor(b)
    for t in range(max(1, 2 ** (bits - 2))):
        gate = 2 * (t < v1).to(torch.int32)          # weight-2 slots
        if t == 0:
            gate = gate + v0                          # odd bit rides slot 0
        out += contract(gate * sgn)
    return out


def tu_gemm_ref(a: torch.Tensor, b: torch.Tensor, *, bits: int = 8) -> torch.Tensor:
    """Slot-by-slot mirror of the tuGEMM kernel's temporal schedule.

    Slot ``i`` of ``2^(bits-1)`` adds ``([i < |a|] * sign(a)) @ b`` — B's
    replayed temporal stream summed by the adder tree.  Equal to int32 GEMM.
    """
    a32 = a.to(torch.int32)
    mag, sgn = torch.abs(a32), torch.sign(a32)
    out = torch.zeros((a.shape[0], b.shape[1]), dtype=torch.int32,
                      device=a.device)
    contract = _contractor(b)
    for i in range(2 ** (bits - 1)):
        out += contract((i < mag).to(torch.int32) * sgn)
    return out


def unpack_values_ref(packed: torch.Tensor, bits: int, axis: int = 0) -> torch.Tensor:
    """Sign-extend ``8 // bits`` values per int8 byte along ``axis``, low
    nibble / crumb first (the layout ``ops.pack_values`` writes)."""
    if bits == 8:
        return packed
    if bits not in (2, 4):
        raise ValueError(f"unsupported bits={bits}")
    pack = 8 // bits
    ax = axis % packed.ndim
    v = torch.movedim(packed, ax, -1).to(torch.int64) & 0xFF
    vals = packing.unpack_fields(v, bits, pack).to(torch.int8)
    vals = vals.reshape(*v.shape[:-1], v.shape[-1] * pack)
    return torch.movedim(vals, -1, ax)


def _int8_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Exact ``(M,K) @ (K,N)`` of int8-range codes -> int32 (float64 sums
    of products below 2^14 are exact for any K below 2^39)."""
    return torch.matmul(x.to(torch.float64), w.to(torch.float64)).to(torch.int32)


def _epilogue(acc: torch.Tensor, scales, fuse_dequant: bool) -> torch.Tensor:
    if not fuse_dequant:
        return acc
    s = (torch.ones((1, acc.shape[1]), dtype=torch.float32, device=acc.device)
         if scales is None else scales.to(torch.float32))
    return acc.to(torch.float32) * s.reshape(1, -1)


def quant_gemm_ref(x: torch.Tensor, w_packed: torch.Tensor,
                   scales: torch.Tensor | None = None, *, bits: int = 8,
                   fuse_dequant: bool = False) -> torch.Tensor:
    """``x:(M,K) int8 @ unpack(w_packed):(K,N)`` -> int32, or with
    ``fuse_dequant`` ``float32(acc) * scales`` (one rounding)."""
    w = unpack_values_ref(w_packed, bits, axis=0)
    return _epilogue(_int8_matmul(x, w), scales, fuse_dequant)


def packed_gemm_ref(x: torch.Tensor, words: torch.Tensor,
                    scales: torch.Tensor | None = None, *, bits: int, k: int,
                    fuse_dequant: bool = False) -> torch.Tensor:
    """Materialising reference of the word-store GEMM: ``unpack_codes``
    the whole ``(ceil(K/cpw), N)`` store, then the integer GEMM."""
    w = packing.unpack_codes(words, bits, k, axis=0)
    return _epilogue(_int8_matmul(x, w), scales, fuse_dequant)


def block_stats_ref(q: torch.Tensor, tile: int = 32):
    """``(ceil(M/tile), ceil(N/tile))`` int32 tile max|q| and zero counts;
    the zero padding of ragged edge tiles counts as zeros."""
    if q.ndim != 2:
        q = q.reshape(-1, q.shape[-1])
    m, n = q.shape
    qp = torch.nn.functional.pad(q.to(torch.int32), (0, (-n) % tile, 0, (-m) % tile))
    r, c = qp.shape[0] // tile, qp.shape[1] // tile
    maxes = torch.amax(torch.abs(qp).reshape(r, tile, c, tile), dim=(1, 3))
    zeros = torch.sum((qp == 0).to(torch.int32).reshape(r, tile, c, tile),
                      dim=(1, 3), dtype=torch.int32)
    return maxes, zeros


def sparsity_from_sums(max_sum: int, zero_sum: int, m: int, n: int, bits: int,
                       tile: int) -> tuple[float, float]:
    """(word sparsity, block-max bit sparsity) of an ``(m, n)`` code matrix
    from the sums of its tile statistics (max|q| and zero counts over every
    tile): the pad cells of the edge tiles, counted as zeros there, are
    subtracted; the means round as the reference's do."""
    rows, cols = -(-m // tile), -(-n // tile)
    total_pad = rows * tile * cols * tile - m * n
    word = _f32_mean(zero_sum - total_pad, m * n)
    blk = _f32_mean(max_sum, rows * cols)
    return float(word), float(np.float32(1.0) - blk / np.float32(2 ** (bits - 1)))


def sparsity_from_block_stats(maxes: torch.Tensor, zeros: torch.Tensor,
                              m: int, n: int, bits: int,
                              tile: int) -> tuple[float, float]:
    """:func:`sparsity_from_sums` of the tile statistics themselves."""
    return sparsity_from_sums(int(maxes.sum(dtype=torch.int64)),
                              int(zeros.sum(dtype=torch.int64)), m, n, bits, tile)


def bit_sparsity_stats_ref(q: torch.Tensor, bits: int, tile: int = 32):
    """(word_sparsity, bit_sparsity_blockmax) — equals ``core.sparsity``."""
    if q.ndim != 2:
        q = q.reshape(-1, q.shape[-1])
    maxes, zeros = block_stats_ref(q, tile)
    return sparsity_from_block_stats(maxes, zeros, q.shape[0], q.shape[1],
                                     bits, tile)
