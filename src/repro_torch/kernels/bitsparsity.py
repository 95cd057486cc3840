"""Per-tile bit-sparsity statistics (paper Eq. 1 input): CUDA kernel
wrapper + plain version.

Replaces the TPU kernel ``repro/kernels/bitsparsity.py:bitsparsity_kernel``
with ``csrc/bitsparsity.cu``.  For an (M, N) int8 code matrix, per tile x
tile block (32, the paper's PE-array block, on every path; any power of two
from 1 to 128, the tiles the reference's (256, 128) block admits):
``max|q|`` (what gates temporal-unary latency) and the count of zero codes
(word sparsity).  Cells of a ragged edge tile past M or N count as zeros;
``ops.bit_sparsity_stats`` subtracts them, as the reference does.  The same
launch also sums both statistics into two int64 (:func:`block_stats_with_sums`),
so the profile needs one read from the device.  It adds them up in one
zeroed accumulator a device, which its last warp resets: calls on one
device go on one stream.

Bound on an H100: the M*N code bytes, read once (memory).  A CPU tensor runs
:func:`repro_torch.kernels.ref.block_stats_ref`; a CUDA tensor launches the
kernel (any M, every tile above) or raises.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import block_stats_ref

__all__ = ["block_stats", "block_stats_with_sums", "TILES", "LAUNCHES",
           "reset_launches"]

#: kernel launches since the last :func:`reset_launches`
LAUNCHES = {"block_stats": 0}

#: the tiles that divide the reference's (256, 128) block
TILES = tuple(1 << i for i in range(8))

#: per device: the kernel's sum accumulator and ticket, zero between launches
_STATE: dict[int, torch.Tensor] = {}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def block_stats(q: torch.Tensor, *, tile: int = 32):
    """(M, N) int8 codes -> (ceil(M/tile), ceil(N/tile)) int32 block max|q|
    and zero counts (ragged-edge padding counted as zeros).  Inputs of more
    than two dims are flattened over their trailing axis."""
    maxes, zeros, _ = block_stats_with_sums(q, tile=tile)
    return maxes, zeros


def block_stats_with_sums(q: torch.Tensor, *, tile: int = 32):
    """:func:`block_stats` and, on q's device, the (2,) int64 tensor
    ``[maxes.sum(), zeros.sum()]`` (from the same launch on a card)."""
    if q.dtype != torch.int8:
        raise TypeError(f"block_stats wants int8 codes, got {q.dtype}")
    if tile not in TILES:
        raise ValueError(f"block_stats takes a tile in {TILES} (a divisor of "
                         f"the reference's (256, 128) block), got {tile}")
    if q.ndim != 2:
        q = q.reshape(-1, q.shape[-1])
    if q.device.type != "cuda":
        maxes, zeros = block_stats_ref(q, tile)
        return maxes, zeros, torch.stack([maxes.sum(dtype=torch.int64),
                                          zeros.sum(dtype=torch.int64)])
    m, n = q.shape
    q = q.contiguous()
    maxes = torch.empty((-(-m // tile), -(-n // tile)), dtype=torch.int32,
                        device=q.device)
    zeros = torch.empty_like(maxes)
    if m == 0 or n == 0:
        return maxes, zeros, torch.zeros(2, dtype=torch.int64, device=q.device)
    sums = torch.empty(2, dtype=torch.int64, device=q.device)
    state = _STATE.get(q.device.index)
    if state is None:
        state = _STATE[q.device.index] = torch.zeros(3, dtype=torch.int64,
                                                     device=q.device)
    lib = _build.load_library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.block_stats_launch(q.data_ptr(), maxes.data_ptr(),
                                      zeros.data_ptr(), state.data_ptr(),
                                      sums.data_ptr(), m, n, tile, stream)
    _build.check_launch(code, "block_stats")
    LAUNCHES["block_stats"] += 1
    return maxes, zeros, sums
