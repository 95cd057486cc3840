"""Typed GEMM backend API: ``resolve`` a design into a :class:`GemmBackend`
and thread it into the model with :func:`use_backend`.

    from repro_torch import backends
    be = backends.resolve("tubgemm_cuda", bits=4)
    out = be.execute(a_codes, b_codes)          # int32, == binary GEMM
    with backends.use_backend("tubgemm_cuda", bits=4):
        logits = model.forward(params, cfg, tokens)

Per-site plans (``use_plan``), packed weight stores (``pack_weights``) and
PE-array grids are not ported yet.
"""

from repro_torch.backends.base import GemmBackend
from repro_torch.backends.registry import (CUDA_SUFFIX, KERNEL_SIBLINGS,
                                           available, mirror_design_spec,
                                           resolve)
from repro_torch.backends.runtime import (BackendExecution, ExecutedGemm,
                                          active_backend, active_execution,
                                          current_site, site_scope,
                                          use_backend)

__all__ = [
    "GemmBackend", "resolve", "available", "mirror_design_spec",
    "KERNEL_SIBLINGS", "CUDA_SUFFIX",
    "BackendExecution", "ExecutedGemm", "use_backend", "active_backend",
    "active_execution", "site_scope", "current_site",
]
