"""Fused unpack-and-contract GEMM over int32-word stores: CUDA kernel
wrapper + plain version.

Replaces the TPU kernel ``repro/kernels/packed_gemm.py:packed_gemm_kernel``
with ``csrc/packed_gemm.cu``: ``int_mma_kernel`` of ``csrc/int_gemm.cuh``
with its word format (``WORDS``), the kernel ``quant_gemm``'s int8
container runs on, on the int8 tensor cores (``mma.sync.m16n8k32``).
Weights travel as the int32 words :func:`repro_torch.core.packing.pack_codes`
emits (16 / 8 / 4 codes a word at 2 / 4 / 8 bits); each 64-k tile of words
lands raw in shared memory and is unpacked there once into the A
fragments, so neither the float weight nor the int8 code matrix exists in
device memory.  int32 accumulate, optional per-channel float32 dequant
epilogue.  The launch path (:func:`repro_torch.kernels.quant_gemm.launch_int_gemm`)
and the split-K plan (:func:`repro_torch.kernels._build.plan_splits`, at
this kernel's own instances' resident blocks) are ``quant_gemm``'s.

A CPU tensor runs the materialising
:func:`repro_torch.kernels.ref.packed_gemm_ref` (``unpack_codes``, then
the integer GEMM); a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import torch

from repro_torch.core import packing
from repro_torch.kernels import _build
from repro_torch.kernels._build import block_rows, plan_splits
from repro_torch.kernels.quant_gemm import check_operands, launch_int_gemm
from repro_torch.kernels.ref import packed_gemm_ref

__all__ = ["packed_gemm", "packed_matmul", "unpack_words", "LAUNCHES",
           "reset_launches", "plan_splits"]

#: kernel launches since the last :func:`reset_launches`
LAUNCHES = {"packed_gemm": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def unpack_words(words: torch.Tensor, bits: int) -> torch.Tensor:
    """Sign-extend a ``(words, n)`` int32-word tile to ``(words*cpw, n)``
    int32 codes (lane order per ``packing.pack_codes``: low lanes first)."""
    cpw = packing.codes_per_word(bits)
    return packing.unpack_codes(words, bits, words.shape[0] * cpw,
                                axis=0).to(torch.int32)


def packed_gemm(x: torch.Tensor, words: torch.Tensor,
                scales: torch.Tensor | None = None, *, bits: int, k: int,
                fuse_dequant: bool = False) -> torch.Tensor:
    """``x:(M,K) int8 @ unpack(words):(K,N) -> (M,N)`` int32 or float32.

    ``words`` is the ``(ceil(K/cpw), N)`` int32 store ``pack_codes`` emits
    for a (K, N) code matrix; ``k`` is the logical K (the padding lanes of
    the last word hold zero codes).  ``scales`` is (1, N) float32, ones
    when omitted; with ``fuse_dequant`` the output is float32.
    """
    if x.dtype != torch.int8:
        raise TypeError(f"packed_gemm wants int8 activations, got {x.dtype}")
    if words.dtype != torch.int32:
        raise TypeError(f"packed_gemm wants an int32 word store, got {words.dtype}")
    cpw = packing.codes_per_word(bits)
    check_operands("packed_gemm", x, words, scales, fuse_dequant)
    if x.shape[1] != k:
        raise ValueError(f"K mismatch: x has K={x.shape[1]}, store holds k={k}")
    if words.shape[0] != -(-k // cpw):
        raise ValueError(
            f"word-count mismatch: store has {words.shape[0]} words, "
            f"k={k} at {bits}-bit needs {-(-k // cpw)}")
    if x.device.type == "cuda":
        m, n = x.shape[0], words.shape[1]
        sm_count = torch.cuda.get_device_properties(x.device).multi_processor_count
        resident = _build.resident_blocks("packed_gemm_resident_blocks",
                                          x.device.index, block_rows(m), bits)
        out = launch_int_gemm("packed_gemm_launch", x, words, scales, k=k,
                              bits=bits,
                              splits=plan_splits(m, k, n, sm_count, resident),
                              fuse_dequant=fuse_dequant)
        LAUNCHES["packed_gemm"] += 1
        return out
    return packed_gemm_ref(x, words, scales, bits=bits, k=k,
                           fuse_dequant=fuse_dequant)


def packed_matmul(x: torch.Tensor, store: packing.PackedQuantized, *,
                  fuse_dequant: bool = True) -> torch.Tensor:
    """Contract int8 activation codes against a :class:`PackedQuantized`
    store without leaving the word domain.

    ``store`` must be a flat (``grid_x == 1``), unstacked store.  With
    ``fuse_dequant`` the weight's per-channel scales apply in the epilogue
    (fold the activation scale into the float32 result, as
    ``models/common._backend_matmul`` does).
    """
    if not packing.is_packed(store):
        raise TypeError(f"packed_matmul wants a PackedQuantized store, "
                        f"got {type(store).__name__}")
    if store.grid_x != 1:
        raise ValueError("grid stores execute through GridBackend; "
                         "packed_matmul wants a flat (grid_x=1) store")
    if store.packed.ndim != 2:
        raise ValueError(f"packed_matmul wants an unstacked store, got "
                         f"packed shape {tuple(store.packed.shape)}")
    scales = store.scale.reshape(1, -1) if fuse_dequant else None
    return packed_gemm(x, store.packed, scales, bits=store.bits, k=store.k,
                       fuse_dequant=fuse_dequant)
