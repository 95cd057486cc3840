"""Backend construction: :func:`resolve` specs into :class:`GemmBackend`s.

Resolution rules (in order):

1. A :class:`GemmBackend` instance resolves to itself (re-widthed if ``bits``
   differs).
2. A CUDA mirror name (``tugemm_cuda`` / ``tubgemm_cuda``) absent from the
   live ``gemm_sims`` registry is built **directly** from the kernel entry
   points in ``repro_torch.kernels.ops``: no registration, no global
   mutation.  The mirror inherits its simulator sibling's cycle/sparsity
   model and prices as the sibling.
3. Any other name is looked up in the live ``gemm_sims`` registry, else a
   ValueError names the resolvable backends.

The rate-coded ``ugemm_stochastic`` family is not ported yet.
"""

from __future__ import annotations

import dataclasses

from repro_torch.backends.base import GemmBackend
from repro_torch.configs import paper_gemm
from repro_torch.core import gemm_sims

__all__ = ["KERNEL_SIBLINGS", "CUDA_SUFFIX", "available", "resolve",
           "mirror_design_spec"]

CUDA_SUFFIX = "_cuda"
#: kernel-backed mirror name -> the simulated design it executes
KERNEL_SIBLINGS: dict[str, str] = {
    "tugemm" + CUDA_SUFFIX: "tugemm",
    "tubgemm" + CUDA_SUFFIX: "tubgemm",
}


def available() -> tuple[str, ...]:
    """Names :func:`resolve` accepts right now: live registry + CUDA mirrors."""
    names = list(gemm_sims.DESIGNS)
    names.extend(n for n in KERNEL_SIBLINGS if n not in names)
    return tuple(names)


def mirror_design_spec(name: str) -> gemm_sims.DesignSpec:
    """Build a CUDA-mirror :class:`~repro_torch.core.gemm_sims.DesignSpec`.

    Pure construction — nothing is registered.  The returned spec shares the
    sibling's ``wc_cycles_fn`` / ``dyn_operand_fn`` / ``sparsity_aware`` /
    ``exact`` — one cost model, two execution engines.  Its functions launch
    the hand-written slot-loop kernels on CUDA tensors and run the plain
    slot-loop version on CPU tensors.
    """
    from repro_torch.kernels import ops  # deferred: keeps import order acyclic

    sibling = KERNEL_SIBLINGS[name]
    sib = gemm_sims.get_design(sibling)
    fn = {"tugemm": ops.tu_matmul, "tubgemm": ops.tub_matmul}[sibling]
    return dataclasses.replace(
        sib, name=name,
        # exact path drops the cycle report; stream path keeps (out, cycles)
        exact_fn=lambda a, b, bits, _fn=fn: _fn(a, b, bits=bits)[0],
        stream_fn=lambda a, b, bits, _fn=fn: _fn(a, b, bits=bits))


def _check_envelope_nonempty(name: str, bits: int) -> None:
    """Reject (design, bits) points whose accumulator envelope is empty."""
    from repro_torch.analysis import ranges
    try:
        safe_k = ranges.max_safe_k(KERNEL_SIBLINGS.get(name, name), bits)
    except KeyError:
        return
    if safe_k < 1:
        raise ValueError(
            f"{name}@{bits}b has an empty accumulator envelope: even a K=1 "
            f"contraction exceeds its register capacity "
            f"(see repro_torch.analysis.ranges.max_safe_k) — lower bits")


def resolve(spec: str | GemmBackend, *, bits: int | None = None) -> GemmBackend:
    """Construct (or pass through) a :class:`GemmBackend`.

    ``spec`` — a backend instance or a design name; ``bits`` — operand
    bit-width (default 8, or the instance's own width).  Never mutates the
    ``gemm_sims`` registry.
    """
    if isinstance(spec, GemmBackend):
        backend = spec
        if bits is not None and int(bits) != backend.bits:
            backend = dataclasses.replace(backend, bits=int(bits))
            _check_envelope_nonempty(backend.name, backend.bits)
        return backend

    name = str(spec)
    bits = 8 if bits is None else int(bits)
    if name in KERNEL_SIBLINGS and name not in gemm_sims.DESIGNS:
        dspec = mirror_design_spec(name)
    elif name in gemm_sims.DESIGNS:
        dspec = gemm_sims.get_design(name)
    else:
        raise ValueError(
            f"unknown design {name!r}; resolvable backends: {available()}")
    _check_envelope_nonempty(name, bits)
    return GemmBackend(
        name=name, bits=bits, exact=dspec.exact,
        has_synthesis_data=name in paper_gemm.DESIGNS,
        pricing_design=KERNEL_SIBLINGS.get(name, name),
        spec=dspec)
