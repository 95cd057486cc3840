"""Packed int8-container GEMM (the PE-array stand-in): CUDA kernel wrapper +
plain version.

Replaces the TPU kernel ``repro/kernels/quant_gemm.py:quant_gemm_kernel``
with ``csrc/quant_gemm.cu`` (body in ``csrc/int_gemm.cuh``).  ``x:(M,K) int8
@ unpack(w_packed):(K,N)`` with ``w_packed`` (K*bits/8, N) int8, 2 or 4
values a byte at 4 or 2 bits, low nibble/crumb first; int32 accumulate and,
with ``fuse_dequant``, the per-channel float32 epilogue ``float32(acc) *
scales`` — one rounding, bit-equal to the plain version.  The kernel runs
on the int8 tensor cores (``int_mma_kernel``: ``out^T = unpack(w)^T .
x^T`` with ``mma.sync.m16n8k32``, each packed tile unpacked once in shared
memory into the A fragments).

Bound on an H100: at decode (M = 8) the packed weight bytes (memory); the
kernel splits K across blocks for narrow outputs (the plan the tensor-core
GEMMs share, :func:`repro_torch.kernels._build.plan_splits`, from the
instance's resident blocks) and finishes each output tile in the block
that adds its last partial sum (a ticket counter), so the fused output is
exact.  This module also holds the launch path (:func:`launch_int_gemm`)
that ``packed_gemm`` shares: its word stores run on the same kernel.

A CPU tensor runs :func:`repro_torch.kernels.ref.quant_gemm_ref`; a CUDA
tensor launches the kernel or raises — there is no fallback.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import block_rows, plan_splits
from repro_torch.kernels.ref import quant_gemm_ref, unpack_values_ref

__all__ = ["quant_gemm", "unpack_values", "LAUNCHES", "reset_launches",
           "plan_splits"]

#: kernel launches since the last :func:`reset_launches`
LAUNCHES = {"quant_gemm": 0}

#: the int8 container holds 8 // bits values a byte
_PACK_BITS = (2, 4, 8)


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


#: sign-extend packed w-bit integers (int8 container) along ``axis``:
#: consecutive values share a byte, low nibble/crumb first
unpack_values = unpack_values_ref


def launch_int_gemm(fn_name: str, x: torch.Tensor, w: torch.Tensor,
                    scales: torch.Tensor | None, *, k: int, bits: int,
                    splits: int, fuse_dequant: bool) -> torch.Tensor:
    """Launch the packed GEMM kernel of ``csrc/int_gemm.cuh`` through the
    C entry ``fn_name`` (the int8 container's or the word store's) on CUDA
    tensors, K split ``splits`` ways: output, split-K workspace and ticket
    counters are allocated here, the launch goes to the current stream;
    raises if the launch fails."""
    m, n = x.shape[0], w.shape[1]
    x = x.contiguous()
    w = w.contiguous()
    out = torch.empty((m, n), dtype=torch.float32 if fuse_dequant else torch.int32,
                      device=x.device)
    if m == 0 or n == 0:
        return out
    ws = counters = None
    if splits > 1:
        tiles = -(-m // block_rows(m)) * -(-n // _build.TILE_N)
        scratch = torch.zeros(m * n + tiles, dtype=torch.int32, device=x.device)
        ws, counters = scratch[: m * n], scratch[m * n:]
    if fuse_dequant:
        scales = (torch.ones(n, dtype=torch.float32, device=x.device)
                  if scales is None
                  else scales.to(torch.float32).reshape(-1).contiguous())
    lib = _build.load_library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = getattr(lib, fn_name)(
            x.data_ptr(), w.data_ptr(),
            scales.data_ptr() if fuse_dequant else None, out.data_ptr(),
            None if ws is None else ws.data_ptr(),
            None if counters is None else counters.data_ptr(),
            m, k, n, w.shape[0], bits, splits, int(fuse_dequant), stream)
    _build.check_launch(code, fn_name)
    return out


def check_operands(name: str, x: torch.Tensor, w: torch.Tensor,
                   scales: torch.Tensor | None, fuse_dequant: bool) -> None:
    """Device, rank and scale checks shared by the packed GEMM wrappers."""
    if x.ndim != 2 or w.ndim != 2:
        raise ValueError(f"{name} wants a 2-D x and a 2-D store, got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    if x.device != w.device:
        raise ValueError(f"{name}: operands on {x.device} and {w.device}")
    if fuse_dequant and scales is not None:
        if scales.numel() != w.shape[1]:
            raise ValueError(f"{name}: {scales.numel()} scales for "
                             f"{w.shape[1]} output columns")
        if scales.device != x.device:
            raise ValueError(f"{name}: scales on {scales.device}, operands "
                             f"on {x.device}")


def quant_gemm(x: torch.Tensor, w_packed: torch.Tensor,
               scales: torch.Tensor | None = None, *, bits: int = 8,
               fuse_dequant: bool = False) -> torch.Tensor:
    """``x:(M,K) int8 @ unpack(w_packed):(K,N) -> (M,N)`` int32 or float32.

    ``w_packed`` is (K*bits/8, N) int8.  ``scales`` is (1, N) float32
    (weight per channel x activation per tensor, pre-folded), ones when
    omitted; with ``fuse_dequant`` the output is float32.
    """
    if x.dtype != torch.int8 or w_packed.dtype != torch.int8:
        raise TypeError("quant_gemm wants int8 operands (packed for w), got "
                        f"{x.dtype} and {w_packed.dtype}")
    if bits not in _PACK_BITS:
        raise ValueError(f"quant_gemm packs bits in {_PACK_BITS}, got {bits}")
    check_operands("quant_gemm", x, w_packed, scales, fuse_dequant)
    pack = 8 // bits
    if w_packed.shape[0] * pack != x.shape[1]:
        raise ValueError(f"K mismatch: x has K={x.shape[1]}, w_packed unpacks "
                         f"to {w_packed.shape[0] * pack}")
    if x.device.type == "cuda":
        m, k, n = x.shape[0], x.shape[1], w_packed.shape[1]
        sm_count = torch.cuda.get_device_properties(x.device).multi_processor_count
        resident = _build.resident_blocks("quant_gemm_resident_blocks",
                                          x.device.index, block_rows(m), bits)
        out = launch_int_gemm("quant_gemm_launch", x, w_packed, scales, k=k,
                              bits=bits,
                              splits=plan_splits(m, k, n, sm_count, resident),
                              fuse_dequant=fuse_dequant)
        LAUNCHES["quant_gemm"] += 1
        return out
    return quant_gemm_ref(x, w_packed, scales, bits=bits,
                          fuse_dequant=fuse_dequant)
