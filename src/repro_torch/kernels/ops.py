"""Public wrappers around the kernels (the names the backend mirrors bind)."""

from __future__ import annotations

import torch

from repro_torch.kernels import unary_gemm as _ug

__all__ = ["tub_matmul", "tu_matmul"]


def tub_matmul(a_q: torch.Tensor, b_q: torch.Tensor, *, bits: int = 8):
    """tubGEMM slot-loop GEMM.  ``a_q`` (M, K) w-bit codes, ``b_q`` (K, N)
    int8; returns ``((M, N) int32, wc_cycles)`` — bit-identical to binary
    GEMM, scheduled as the paper's 2-unary unit."""
    return _ug.tub_gemm(a_q, b_q, bits=bits)


def tu_matmul(a_q: torch.Tensor, b_q: torch.Tensor, *, bits: int = 8):
    """tuGEMM temporal slot-loop GEMM; returns ``((M, N) int32, wc_cycles)``
    with ``K * (2^(w-1))^2`` cycles."""
    return _ug.tu_gemm(a_q, b_q, bits=bits)
