"""tubGEMM / tuGEMM slot-loop GEMMs: CUDA kernel wrappers + plain versions.

Replaces the TPU kernels ``repro/kernels/unary_gemm.py:tub_gemm_kernel`` and
``tu_gemm_kernel`` with ``csrc/unary_gemm.cu``.  ``(M,K) int8 w-bit codes x
(K,N) int8 -> (M,N) int32``, bit-identical to integer GEMM, executed on the
unit's literal slot schedule.  Both designs run on the int8 tensor cores,
as two instances of one kernel (``unary_mma_kernel``): per K tile the A tile
is decomposed once into the design's pulse planes — ``(v1 + 127, 2 sign,
slot-0 pulse)`` for tub, ``(|a| + 127, sign)`` for tu — then every slot
forms its pulse operand in registers and executes its own
multiply-accumulate, one int8 ``mma.sync.m16n8k32`` per fragment pair
(``out^T = B^T . pulses^T``, B through a ``cp.async`` ring).

Bound on an H100: at decode (M = 8) the ``K*N`` weight-code bytes (memory);
at prefill widths or many slots the tensor-core rate on the slot schedule.
K is split across blocks (exact int32 atomics) so that narrow outputs still
fill the SMs, by the plan the tensor-core GEMMs share
(:func:`repro_torch.kernels._build.plan_splits`), which reads each
instance's resident blocks from the CUDA occupancy calculator.

A CPU tensor runs the plain slot loop of :mod:`repro_torch.kernels.ref`; a
CUDA tensor launches the kernel or raises — there is no fallback.  Alongside
the output the wrappers report the design's worst-case cycle count, a
host-side constant of the simulated unit, not a device measurement.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import block_rows, plan_splits
from repro_torch.kernels.ref import tu_gemm_ref, tub_gemm_ref

__all__ = ["tub_gemm", "tub_wc_cycles", "tu_gemm", "tu_wc_cycles",
           "LAUNCHES", "reset_launches", "plan_splits"]

#: kernel launches per wrapper since the last :func:`reset_launches`
LAUNCHES = {"tub_gemm": 0, "tu_gemm": 0}

_MODE = {"tub_gemm": 0, "tu_gemm": 1}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def tub_wc_cycles(bits: int, common_dim: int) -> int:
    """Worst-case tubGEMM cycles: one pass of ``L2 = 2^(w-2)`` slots per
    outer-product step, ``K * L2``.  Equals ``wc_cycles("tubgemm", ...)``."""
    return common_dim * max(1, 2 ** (bits - 2))


def tu_wc_cycles(bits: int, common_dim: int) -> int:
    """Worst-case tuGEMM cycles: every one of A's ``L = 2^(w-1)`` slots
    replays B's full L-slot stream, per outer-product step — ``K * L^2``.
    Equals ``wc_cycles("tugemm", ...)``."""
    return common_dim * (2 ** (bits - 1)) ** 2


def _check(name: str, a: torch.Tensor, b: torch.Tensor, bits: int) -> None:
    if a.dtype != torch.int8 or b.dtype != torch.int8:
        raise TypeError(f"{name} wants int8 operands, got {a.dtype} and {b.dtype}")
    if a.ndim != 2 or b.ndim != 2:
        raise ValueError(f"{name} wants (M,K) x (K,N), got {tuple(a.shape)} "
                         f"and {tuple(b.shape)}")
    if b.shape[0] != a.shape[1]:
        raise ValueError(f"K mismatch: a has K={a.shape[1]}, b has K={b.shape[0]}")
    if a.device != b.device:
        raise ValueError(f"{name}: operands on {a.device} and {b.device}")
    if not 2 <= bits <= 8:
        raise ValueError(f"{name} supports 2 <= bits <= 8, got {bits}")


def _launch(name: str, a: torch.Tensor, b: torch.Tensor, n_slots: int) -> torch.Tensor:
    a = a.contiguous()
    b = b.contiguous()
    m, k = a.shape
    n = b.shape[1]
    sm_count = torch.cuda.get_device_properties(a.device).multi_processor_count
    resident = _build.resident_blocks("unary_resident_blocks", a.device.index,
                                      _MODE[name], block_rows(m))
    splits = plan_splits(m, k, n, sm_count, resident)
    alloc = torch.zeros if splits > 1 else torch.empty
    out = alloc((m, n), dtype=torch.int32, device=a.device)
    if m == 0 or n == 0:
        return out
    lib = _build.load_library()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.unary_gemm_launch(_MODE[name], a.data_ptr(), b.data_ptr(),
                                     out.data_ptr(), m, k, n, n_slots, splits,
                                     stream)
    _build.check_launch(code, name)
    LAUNCHES[name] += 1
    return out


def tub_gemm(a: torch.Tensor, b: torch.Tensor, *, bits: int = 8):
    """``a:(M,K) int8 codes @ b:(K,N) int8 -> ((M,N) int32, wc_cycles)``.

    ``a`` holds w-bit sign-magnitude-encodable codes (|a| <= 2^(w-1)-1, the
    symmetric-quantization range); ``b`` is plain int8.  Output is exactly
    the integer GEMM — the point is the *schedule*, priced by ``core.ppa``
    at ``tub_wc_cycles(bits, K)`` cycles.
    """
    _check("tub_gemm", a, b, bits)
    if a.device.type == "cuda":
        out = _launch("tub_gemm", a, b, max(1, 2 ** (bits - 2)))
    else:
        out = tub_gemm_ref(a, b, bits=bits)
    return out, tub_wc_cycles(bits, a.shape[1])


def tu_gemm(a: torch.Tensor, b: torch.Tensor, *, bits: int = 8):
    """``a:(M,K) int8 codes @ b:(K,N) int8 -> ((M,N) int32, wc_cycles)``.

    Same operands as :func:`tub_gemm`; ``2^(bits-1)`` temporal slots, priced
    at ``tu_wc_cycles(bits, K)`` cycles.
    """
    _check("tu_gemm", a, b, bits)
    if a.device.type == "cuda":
        out = _launch("tu_gemm", a, b, 2 ** (bits - 1))
    else:
        out = tu_gemm_ref(a, b, bits=bits)
    return out, tu_wc_cycles(bits, a.shape[1])
