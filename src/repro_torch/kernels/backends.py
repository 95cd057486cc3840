"""Registry-side access to the CUDA unary-GEMM kernel mirrors (legacy).

The typed way to run the kernels is ``repro_torch.backends.resolve(
"tugemm_cuda")`` — pure construction, no global state.  This module keeps
the older *registry-mutating* surface for consumers that drive the kernels
through ``gemm_sims`` string dispatch:

* :func:`register_kernel_backends` (deprecated) registers the mirrors as
  ``tugemm_cuda`` / ``tubgemm_cuda`` registry designs.  Nothing registers
  at import time: consumers that iterate ``gemm_sims.DESIGNS`` see exactly
  the four calibrated designs.
* :func:`kernel_backends` scopes a registration to a ``with`` block via
  ``gemm_sims.scoped_registry``, so ``DESIGNS`` is restored on exit and on
  an exception.

The mirrors inherit their sibling's latency and sparsity model: one cost
model, two execution engines.
"""

from __future__ import annotations

import contextlib

from repro_torch.core import gemm_sims

__all__ = ["register_kernel_backends", "kernel_backends"]


def _register() -> tuple[str, ...]:  # analysis: allow-registry-mutation (kernel_backends scopes it; register_kernel_backends is the deprecated unscoped surface)
    from repro_torch.backends.registry import (KERNEL_SIBLINGS,
                                               mirror_design_spec)

    for name in KERNEL_SIBLINGS:
        spec = mirror_design_spec(name)
        gemm_sims.register_design(
            name,
            exact_fn=spec.exact_fn,
            stream_fn=spec.stream_fn,
            wc_cycles_fn=spec.wc_cycles_fn,
            sparsity_aware=spec.sparsity_aware,
            dyn_operand_fn=spec.dyn_operand_fn,
            exact=spec.exact,
            overwrite=True,
        )
    return tuple(KERNEL_SIBLINGS)


def register_kernel_backends() -> tuple[str, ...]:
    """Deprecated: resolve mirrors with ``repro_torch.backends.resolve``.

    Idempotently registers ``tugemm_cuda`` / ``tubgemm_cuda`` into the
    ``gemm_sims`` registry (``overwrite=True``) and returns their names.
    """
    gemm_sims._warn_once(
        "repro_torch.kernels.backends.register_kernel_backends",
        "repro_torch.backends.resolve('tugemm_cuda', ...) — no registry "
        "mutation needed")
    return _register()


@contextlib.contextmanager
def kernel_backends():
    """Scoped registration: the mirrors exist only inside the ``with`` block.

    Snapshot and restore run through ``gemm_sims.scoped_registry``, so
    scopes nest and an exception inside the body still restores the outer
    state (including any ``*_cuda`` registration this scope overwrote).
    """
    with gemm_sims.scoped_registry():
        yield _register()
