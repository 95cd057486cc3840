"""Per-tile bit-sparsity statistics (paper Eq. 1 input): CUDA kernel
wrapper + plain version.

Replaces the TPU kernel ``repro/kernels/bitsparsity.py:bitsparsity_kernel``
with ``csrc/bitsparsity.cu``.  For an (M, N) int8 code matrix, per 32x32
tile (the paper's PE-array block): ``max|q|`` (what gates temporal-unary
latency) and the count of zero codes (word sparsity).  Cells of a ragged
edge tile past M or N count as zeros; ``ops.bit_sparsity_stats`` subtracts
them, as the reference does.

Bound on an H100: the M*N code bytes, read once (memory).  A CPU tensor runs
:func:`repro_torch.kernels.ref.block_stats_ref` (any tile); a CUDA tensor
launches the kernel (tile 32) or raises.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import block_stats_ref

__all__ = ["block_stats", "LAUNCHES", "reset_launches"]

#: kernel launches since the last :func:`reset_launches`
LAUNCHES = {"block_stats": 0}

_KERNEL_TILE = 32            # csrc/bitsparsity.cu
_MAX_TILE_ROWS = 65535       # the kernel's grid.y


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def block_stats(q: torch.Tensor, *, tile: int = 32):
    """(M, N) int8 codes -> (ceil(M/tile), ceil(N/tile)) int32 block max|q|
    and zero counts (ragged-edge padding counted as zeros).  Inputs of more
    than two dims are flattened over their trailing axis."""
    if q.dtype != torch.int8:
        raise TypeError(f"block_stats wants int8 codes, got {q.dtype}")
    if q.ndim != 2:
        q = q.reshape(-1, q.shape[-1])
    if q.device.type != "cuda":
        return block_stats_ref(q, tile)
    if tile != _KERNEL_TILE:
        raise ValueError(f"the block_stats kernel is built for tile "
                         f"{_KERNEL_TILE}, got {tile}")
    m, n = q.shape
    rows, cols = -(-m // tile), -(-n // tile)
    if rows > _MAX_TILE_ROWS:
        raise ValueError(f"block_stats kernel takes at most "
                         f"{_MAX_TILE_ROWS * tile} rows, got {m}")
    q = q.contiguous()
    maxes = torch.empty((rows, cols), dtype=torch.int32, device=q.device)
    zeros = torch.empty((rows, cols), dtype=torch.int32, device=q.device)
    if m == 0 or n == 0:
        return maxes, zeros
    lib = _build.load_library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.block_stats_launch(q.data_ptr(), maxes.data_ptr(),
                                      zeros.data_ptr(), m, n, stream)
    _build.check_launch(code, "block_stats")
    LAUNCHES["block_stats"] += 1
    return maxes, zeros
