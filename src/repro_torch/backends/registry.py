"""Backend construction: :func:`resolve` specs into :class:`GemmBackend`s.

Resolution rules (in order):

1. A :class:`GemmBackend` instance resolves to itself (re-widthed if ``bits``
   differs).
2. A CUDA mirror name (``tugemm_cuda`` / ``tubgemm_cuda``) absent from the
   live ``gemm_sims`` registry is built **directly** from the kernel entry
   points in ``repro_torch.kernels.ops``: no registration, no global
   mutation.  The mirror inherits its simulator sibling's cycle/sparsity
   model and prices as the sibling.
3. The rate-coded stochastic family ``ugemm_stochastic`` — optionally
   spelled ``"ugemm_stochastic:<stream_len>"`` — builds a **pure** spec from
   ``repro_torch.stochastic.sgemm`` closing over the stream length (default
   one full RNG period, ``2^bits``).  No registration; prices as ``ugemm``
   with ``stream_len / 2^bits`` cycle scaling (``GemmBackend.cycle_scale``).
4. Any other name is looked up in the live ``gemm_sims`` registry, else a
   ValueError names the resolvable backends.

``stream_len`` is a stochastic-family knob: passing it for any other design
is an error rather than a silent no-op.
"""

from __future__ import annotations

import dataclasses

from repro_torch.backends.base import GemmBackend
from repro_torch.configs import paper_gemm
from repro_torch.core import gemm_sims

__all__ = ["KERNEL_SIBLINGS", "CUDA_SUFFIX", "STOCHASTIC_DESIGN", "available",
           "resolve", "mirror_design_spec"]

CUDA_SUFFIX = "_cuda"
#: kernel-backed mirror name -> the simulated design it executes
KERNEL_SIBLINGS: dict[str, str] = {
    "tugemm" + CUDA_SUFFIX: "tugemm",
    "tubgemm" + CUDA_SUFFIX: "tubgemm",
}

#: the rate-coded bitstream family (repro_torch.stochastic); prices as ugemm
STOCHASTIC_DESIGN = "ugemm_stochastic"


def available() -> tuple[str, ...]:
    """Names :func:`resolve` accepts right now: live registry + CUDA mirrors
    + the stochastic bitstream family."""
    names = list(gemm_sims.DESIGNS)
    names.extend(n for n in KERNEL_SIBLINGS if n not in names)
    if STOCHASTIC_DESIGN not in names:
        names.append(STOCHASTIC_DESIGN)
    return tuple(names)


def _parse_spec_string(name: str) -> tuple[str, int | None]:
    """Split ``"ugemm_stochastic:64"`` into ``(name, stream_len)``.

    Only the stochastic family takes a ``:<stream_len>`` suffix; a colon on
    any other name falls through to the unknown-design error in resolve.
    """
    head, sep, tail = name.partition(":")
    if sep and head == STOCHASTIC_DESIGN:
        try:
            return head, int(tail)
        except ValueError:
            raise ValueError(
                f"bad stream length {tail!r} in backend spec {name!r}; "
                f"expected {STOCHASTIC_DESIGN}:<int>") from None
    return name, None


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


def _check_envelope_nonempty(name: str, bits: int,
                             stream_len: int | None = None) -> None:
    """Reject (design, bits) points whose accumulator envelope is empty."""
    from repro_torch.analysis import ranges
    try:
        safe_k = ranges.max_safe_k(KERNEL_SIBLINGS.get(name, name), bits,
                                   stream_len=stream_len)
    except KeyError:
        return
    if safe_k < 1:
        raise ValueError(
            f"{name}@{bits}b has an empty accumulator envelope: even a K=1 "
            f"contraction exceeds its register capacity "
            f"(see repro_torch.analysis.ranges.max_safe_k) — lower bits")


def resolve(spec: str | GemmBackend, *, bits: int | None = None,
            stream_len: int | None = None) -> GemmBackend:
    """Construct (or pass through) a :class:`GemmBackend`.

    ``spec`` — a backend instance or a design name (the stochastic family
    also as ``"ugemm_stochastic:<stream_len>"``); ``bits`` — operand
    bit-width (default 8, or the instance's own width); ``stream_len`` —
    rate-coded stream length (stochastic family only; default one full RNG
    period, ``2^bits``).  Never mutates the ``gemm_sims`` registry.
    """
    if isinstance(spec, GemmBackend):
        backend = spec
        if stream_len is not None:
            # re-build by name so the stream length can apply
            return resolve(backend.name,
                           bits=backend.bits if bits is None else bits,
                           stream_len=stream_len)
        if bits is not None and int(bits) != backend.bits:
            if backend.stream_len is not None:
                # a stream length tuned for one width is meaningless at
                # another — re-resolve with the new default period
                return resolve(backend.name, bits=int(bits))
            backend = dataclasses.replace(backend, bits=int(bits))
            _check_envelope_nonempty(backend.name, backend.bits)
        return backend

    name, spec_stream_len = _parse_spec_string(str(spec))
    if spec_stream_len is not None:
        if stream_len is not None and stream_len != spec_stream_len:
            raise ValueError(
                f"stream_len={stream_len} conflicts with the spec string "
                f"{spec!r}")
        stream_len = spec_stream_len
    bits = 8 if bits is None else int(bits)
    is_stochastic = name == STOCHASTIC_DESIGN and name not in gemm_sims.DESIGNS
    if stream_len is not None and not is_stochastic:
        raise ValueError(
            f"stream_len is a {STOCHASTIC_DESIGN!r} knob; {name!r} is "
            f"count-exact per design (its slot count is not plannable)")
    if name in KERNEL_SIBLINGS and name not in gemm_sims.DESIGNS:
        dspec = mirror_design_spec(name)
    elif is_stochastic:
        from repro_torch.stochastic import sgemm  # deferred: the engine
        if stream_len is None:
            stream_len = sgemm.default_stream_len(bits)
        dspec = sgemm.stochastic_design_spec(stream_len)
    elif name in gemm_sims.DESIGNS:
        dspec = gemm_sims.get_design(name)
    else:
        raise ValueError(
            f"unknown design {name!r}; resolvable backends: {available()}")
    _check_envelope_nonempty(name, bits, stream_len=stream_len)
    return GemmBackend(
        name=name, bits=bits, exact=dspec.exact,
        has_synthesis_data=name in paper_gemm.DESIGNS,
        pricing_design=("ugemm" if is_stochastic
                        else KERNEL_SIBLINGS.get(name, name)),
        spec=dspec, stream_len=stream_len)
