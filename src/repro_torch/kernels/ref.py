"""Plain PyTorch versions of the slot-loop GEMM kernels (the correctness
contract): each mirrors one kernel's schedule slot by slot.

Integer contractions run per slot through :func:`_contractor`, which is an
integer matmul on the CPU and an exact K-chunked fp32 product on CUDA (CUDA
has no int32 matmul); either way every slot's pulse operand is formed and
accumulated on its own, as in the kernels.
"""

from __future__ import annotations

import torch

__all__ = ["tub_gemm_ref", "tu_gemm_ref"]

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
