"""Hand-written Hopper kernels (CUDA C++ under ``../csrc``) and their plain
PyTorch versions.

- quant_gemm            : packed int8-container integer GEMM (``cfg.quant_kernel``)
- packed_gemm           : the same GEMM over int32-word stores (``core.packing``)
- unary_gemm            : tuGEMM / tubGEMM slot loops
- bitsparsity           : per-32x32-tile max|q| / zero counts (Eq. 1 input)
- paged_attention_fused : decode attention walking the block table
- flash_attention       : tiled attention forward and backward (training)
- paged_attention       : the gather oracle and KV writes (no kernel)
- ops                   : public wrappers (pack, quantized_matmul, stats)
- ref                   : the plain versions the CPU runs and the tests sweep
- backends              : deprecated, scoped registration of the ``*_cuda``
  mirrors in the ``gemm_sims`` registry (imported on demand, not here)

Each kernel module holds the ctypes wrapper (device / dtype / shape checks,
output allocation, launch on the current stream, a launch counter) next to
the plain version the CPU tests run.  Nothing here touches CUDA, ``nvcc`` or
``ctypes.CDLL`` at import time: the shared library is built at first launch
(:mod:`repro_torch.kernels._build`).
"""

from repro_torch.kernels import (bitsparsity, flash_attention, ops, packed_gemm,
                                 paged_attention, paged_attention_fused,
                                 quant_gemm, ref, unary_gemm)

__all__ = ["bitsparsity", "flash_attention", "ops", "packed_gemm",
           "paged_attention", "paged_attention_fused", "quant_gemm", "ref",
           "unary_gemm"]
