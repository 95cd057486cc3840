"""Weight/activation sparsity profiling (paper §III-B, Table V, Eq. 1).

Two statistics, exactly as the paper defines them:

* **word sparsity** — fraction of quantized values that are exactly zero.
* **bit sparsity**  — fraction of 0 slots in the temporal-unary bitstream.
  Because the paper's outer-product GEMM unit finishes a step only when the
  *largest* magnitude in the tile has streamed out, the latency-relevant bit
  sparsity tracks the **maximum value per PE-array block**:

      b_spa = 1 - mean_over_blocks( max|q|_block ) / L,   L = 2^(w-1)

Profiling runs on the device the tensor lives on.  :func:`profile_tensor`
walks a large weight in row chunks (whole block rows), so a stacked
multi-gigabyte leaf is profiled without a full-size temporary; sums are
taken as exact integers and only the final mean is rounded to float32 (as
``sum * fl32(1 / count)``, the way XLA compiles the reference's mean), which
reproduces the reference's statistics bit for bit while the sums stay below
2^24 (every tier-1 size) and is the more accurate value above it.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.quantization import _codes, _scale_from_amax

__all__ = [
    "SparsityStats",
    "word_sparsity",
    "bit_sparsity_elementwise",
    "bit_sparsity_blockmax",
    "profile_tensor",
    "combine_stats",
]

#: elements per chunk of :func:`profile_tensor`'s walk
_PROFILE_CHUNK_ELEMS = 1 << 26


@dataclasses.dataclass(frozen=True)
class SparsityStats:
    """Profiled sparsity for one tensor (or an aggregate)."""

    bits: int
    word: float          # fraction of zero words
    bit_elem: float      # element-wise bit sparsity (upper bound on savings)
    bit_blockmax: float  # block-max bit sparsity (Eq. 1 input)
    numel: int

    def dynamic_fraction(self) -> float:
        """Multiplier on worst-case latency (Eq. 1): 1 - b_spa."""
        return 1.0 - self.bit_blockmax


def _as_rows(q: torch.Tensor) -> torch.Tensor:
    return q[None, :] if q.ndim == 1 else q.reshape(-1, q.shape[-1])


def _row_chunk(x: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    """Rows ``[lo, hi)`` of ``x``'s 2-D row view (all leading axes folded
    into rows).  A 3-D strided view — a stack of column bands, a grid
    shard's slice of every layer — is not reshaped as a whole (that would
    copy it): only the chunk's rows are gathered."""
    if x.ndim <= 2:
        return _as_rows(x)[lo:hi]
    stack = x.reshape(-1, x.shape[-2], x.shape[-1])
    r = stack.shape[1]
    hi = min(hi, stack.shape[0] * r)
    pieces = [stack[i, max(lo - i * r, 0): min(hi - i * r, r)]
              for i in range(lo // r, (hi - 1) // r + 1)]
    return pieces[0] if len(pieces) == 1 else torch.cat(pieces)


def _block_max_sum(rows: torch.Tensor, block: int) -> tuple[int, int]:
    """(sum of per-block max|q|, number of blocks) of a 2-D code matrix."""
    x = torch.abs(rows.to(torch.int32))
    r, c = x.shape
    pr, pc = (-r) % block, (-c) % block
    x = torch.nn.functional.pad(x, (0, pc, 0, pr))
    x = x.reshape(x.shape[0] // block, block, x.shape[1] // block, block)
    blk_max = torch.amax(x, dim=(1, 3))
    return int(blk_max.sum(dtype=torch.int64)), blk_max.numel()


def _f32_mean(total: int, count: int) -> np.float32:
    # XLA lowers the reference's float32 mean to sum * fl32(1 / count)
    return np.float32(total) * (np.float32(1.0) / np.float32(count))


def word_sparsity(q: torch.Tensor) -> float:
    """Fraction of exactly-zero quantized words (float32-rounded mean)."""
    return float(_f32_mean(int((q == 0).sum(dtype=torch.int64)), q.numel()))


def bit_sparsity_elementwise(q: torch.Tensor, bits: int) -> float:
    """Element-level bit sparsity: ``1 - mean|q| / L`` with ``L = 2^(w-1)``."""
    total = int(torch.abs(q.to(torch.int32)).sum(dtype=torch.int64))
    return float(np.float32(1.0) - _f32_mean(total, q.numel())
                 / np.float32(2 ** (bits - 1)))


def bit_sparsity_blockmax(q: torch.Tensor, bits: int, block: int = 32) -> float:
    """1 - mean(max|q| per block x block tile) / L  (paper's LLM method).

    ``q`` is flattened to 2-D over the trailing axis; ragged edges are
    padded with zeros inside their (still counted) edge blocks, all-padding
    blocks never exist.  This is the **Eq. 1 input**.
    """
    total, count = _block_max_sum(_as_rows(q), block)
    return float(np.float32(1.0) - _f32_mean(total, count)
                 / np.float32(2 ** (bits - 1)))


def profile_tensor(x: torch.Tensor, bits: int, block: int = 32,
                   pre_quantized: bool = False) -> SparsityStats:
    """Quantize (unless already integer codes) and profile one tensor.

    Per-tensor quantization, as the paper profiles (block maxima are measured
    against the tensor-global Vmax; per-channel scales would renormalize
    every channel to its own max and hide bit sparsity).  The tensor is
    walked in chunks of whole block rows on its own device (a strided 3-D
    view one chunk at a time, never copied whole); only scalars reach the
    host.
    """
    n_cols = x.shape[-1] if x.ndim else 1
    n_rows = x.numel() // max(n_cols, 1)
    step = max(block, (_PROFILE_CHUNK_ELEMS // max(n_cols, 1)) // block * block)
    scale = None
    if not pre_quantized:
        # the tensor-global absmax, one chunk at a time (max is exact)
        amax = torch.stack([torch.amax(torch.abs(_row_chunk(x, lo, lo + step)))
                            for lo in range(0, n_rows, step)]).amax()
        scale = _scale_from_amax(amax, bits)
    zeros = mag_sum = blk_sum = blk_count = 0
    for lo in range(0, n_rows, step):
        part = _row_chunk(x, lo, lo + step)
        q = part.to(torch.int32) if pre_quantized else _codes(part, scale, bits)
        zeros += int((q == 0).sum(dtype=torch.int64))
        mag_sum += int(torch.abs(q.to(torch.int32)).sum(dtype=torch.int64))
        s, c = _block_max_sum(q, block)
        blk_sum += s
        blk_count += c
    numel = n_rows * n_cols
    slots = np.float32(2 ** (bits - 1))
    return SparsityStats(
        bits=bits,
        word=float(_f32_mean(zeros, numel)),
        bit_elem=float(np.float32(1.0) - _f32_mean(mag_sum, numel) / slots),
        bit_blockmax=float(np.float32(1.0) - _f32_mean(blk_sum, blk_count)
                           / slots),
        numel=int(numel),
    )


def combine_stats(stats: list[SparsityStats]) -> SparsityStats:
    """Size-weighted aggregate across tensors (a model's layers).

    Args: ``stats`` — per-tensor stats at one shared ``bits``.
    Returns: one :class:`SparsityStats` whose fractions are
    ``numel``-weighted means (Table V's per-model numbers).
    """
    if not stats:
        raise ValueError("no stats to combine")
    bits = stats[0].bits
    total = sum(s.numel for s in stats)
    w = lambda f: sum(getattr(s, f) * s.numel for s in stats) / total
    return SparsityStats(bits=bits, word=w("word"), bit_elem=w("bit_elem"),
                         bit_blockmax=w("bit_blockmax"), numel=total)
