"""Rate-coded stochastic GEMM: the ``ugemm_stochastic`` design family.

``stochastic_gemm`` multiplies signed-magnitude integer codes the way the
paper's uGEMM hardware does — as rate-coded bitstreams — instead of the
closed-form slot counts of ``core.gemm_sims.ugemm_exact``:

1. **SourceGen** maps each magnitude to a comparator threshold
   (``gen.source_gen_codes``).
2. **BSGen** turns thresholds into ``stream_len``-cycle bitstreams against
   distinct Sobol dimensions per operand (dim 0 for A, dim 1 for B).
3. The per-cycle **AND** products are accumulated over cycles and the
   common dimension by an exact integer adder tree.
4. Decode scales counts by ``vmax^2 / stream_len``.

The count is the same two-port slot count uGEMM's is, so it runs through
``gemm_sims.signed_slot_counts``: B's bit in cycle t is a threshold on
``|b|`` (``r_b[t] < tau(|b|)``, ``tau`` monotone), the cycles group by
threshold, and no ``(L, K, N)`` stream is materialized.  The counts equal
the reference's int32 contraction of the materialized streams
(:func:`_bitstreams`) bit for bit.

Stream length ``L`` is the accuracy/energy knob; worst-case cycles are
``L`` independent of the common dimension.  :func:`stochastic_design_spec`
packages the engine as a pure ``DesignSpec`` (no registry mutation), which
``repro_torch.backends.resolve("ugemm_stochastic", bits=..., stream_len=...)``
exposes.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from repro_torch.core import gemm_sims
from repro_torch.core.quantization import vmax
from repro_torch.stochastic import gen

__all__ = [
    "STOCHASTIC_DESIGN", "default_stream_len", "stochastic_gemm",
    "stochastic_gemm_stream", "stochastic_counts", "stochastic_decode",
    "stochastic_design_spec",
    "UnaryLinearAcc", "scaled_output_stream",
]

#: The design-family name ``repro_torch.backends.resolve`` accepts
#: (optionally spelled ``"ugemm_stochastic:<stream_len>"``).
STOCHASTIC_DESIGN = "ugemm_stochastic"


def default_stream_len(bits: int) -> int:
    """One full RNG period — the stream length exact uGEMM implicitly uses."""
    return 2 ** bits


def _bitstreams(codes, bits: int, stream_len: int, *, dim: int, seed: int,
                rng_kind: str) -> torch.Tensor:
    """Signed bitstreams: BSGen on |codes| times the code's sign.

    Shape ``(stream_len, *codes.shape)`` int8 in {-1, 0, 1}.  Materialized
    for tests and small studies; :func:`stochastic_gemm` never builds it.
    """
    q = torch.as_tensor(codes).to(torch.int32)
    tau = gen.source_gen_codes(torch.abs(q), bits)
    seq = gen.rng_sequence(rng_kind, bits, stream_len, dim=dim, seed=seed,
                           device=q.device)
    return gen.bsgen(tau, seq) * torch.sign(q).to(torch.int8)[None]


def _pulse_table(bits: int, stream_len: int, *, dim: int, seed: int,
                 rng_kind: str) -> torch.Tensor:
    """``(vmax + 1, stream_len)`` bits: cycle t of a magnitude-i operand."""
    mags = torch.arange(vmax(bits) + 1, dtype=torch.int32)
    seq = gen.rng_sequence(rng_kind, bits, stream_len, dim=dim, seed=seed)
    return gen.bsgen(gen.source_gen_codes(mags, bits), seq).T.bool()


@functools.lru_cache(maxsize=None)
def _slot_groups(bits: int, stream_len: int, seed: int,
                 rng_kind: str) -> gemm_sims.SlotGroups:
    """The engine's schedule: A on Sobol/LFSR dim 0, B on dim 1."""
    kw = dict(seed=seed, rng_kind=rng_kind)
    return gemm_sims.SlotGroups(
        _pulse_table(bits, stream_len, dim=0, **kw),
        _pulse_table(bits, stream_len, dim=1, **kw))


def stochastic_gemm(a, b, bits: int = 8, *, stream_len: int | None = None,
                    seed: int = 0, rng_kind: str = "sobol") -> torch.Tensor:
    """Rate-coded GEMM of signed integer codes ``a @ b``.

    ``a``: ``(m, k)``; ``b``: ``(k, n)``; both with entries in
    ``[-vmax(bits), vmax(bits)]`` and on one device (a ``ValueError``
    otherwise).  Returns float32 decoded estimates; the contraction itself
    is an exact integer count, each temporary within
    ``gemm_sims.CHUNK_BUDGET_BYTES``.
    """
    if stream_len is None:
        stream_len = default_stream_len(bits)
    counts = stochastic_counts(a, b, bits, stream_len=stream_len, seed=seed,
                               rng_kind=rng_kind)
    return stochastic_decode(counts, bits, stream_len)


def stochastic_counts(a, b, bits: int, *, stream_len: int, seed: int = 0,
                      rng_kind: str = "sobol") -> torch.Tensor:
    """The exact signed pulse counts behind :func:`stochastic_gemm`, int64."""
    return gemm_sims.signed_slot_counts(
        torch.as_tensor(a), torch.as_tensor(b),
        _slot_groups(bits, int(stream_len), int(seed), rng_kind))


def stochastic_decode(counts: torch.Tensor, bits: int,
                      stream_len: int) -> torch.Tensor:
    """Float32 estimate ``count * vmax^2 / stream_len`` of the counts."""
    v = vmax(bits)
    return gemm_sims._scaled(counts, v * v, stream_len)


def stochastic_gemm_stream(a, b, bits: int = 8, *,
                           stream_len: int | None = None, seed: int = 0,
                           rng_kind: str = "sobol"):
    """Streamed form: ``(estimate, cycles)`` — cycles is the stream length."""
    if stream_len is None:
        stream_len = default_stream_len(bits)
    est = stochastic_gemm(a, b, bits, stream_len=stream_len, seed=seed,
                          rng_kind=rng_kind)
    return est, stream_len


def stochastic_design_spec(stream_len: int, *, seed: int = 0,
                           rng_kind: str = "sobol") -> gemm_sims.DesignSpec:
    """A pure ``DesignSpec`` for one ``(stream_len, seed, rng)`` engine.

    Constructed per backend and never registered in the global design
    registry; worst-case cycles are ``stream_len`` regardless of the common
    dimension, mirroring uGEMM's k-independent ``2^bits``.
    """
    if stream_len < 1:
        raise ValueError(f"stream_len must be >= 1, got {stream_len}")

    def exact_fn(a, b, bits):
        return stochastic_gemm(a, b, bits, stream_len=stream_len, seed=seed,
                               rng_kind=rng_kind)

    def stream_fn(a, b, bits):
        return stochastic_gemm_stream(a, b, bits, stream_len=stream_len,
                                      seed=seed, rng_kind=rng_kind)

    def count_fn(a, b, bits):
        return stochastic_counts(a, b, bits, stream_len=stream_len, seed=seed,
                                 rng_kind=rng_kind)

    def decode_fn(counts, bits):
        return stochastic_decode(counts, bits, stream_len)

    return gemm_sims.DesignSpec(
        name=STOCHASTIC_DESIGN,
        exact_fn=exact_fn,
        stream_fn=stream_fn,
        wc_cycles_fn=lambda bits, common_dim: stream_len,
        sparsity_aware=False,
        exact=False,
        count_fn=count_fn,
        decode_fn=decode_fn,
    )


# ---------------------------------------------------------------------------
# UnaryLinear scaled accumulation (UnarySim's output-stream regeneration)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class UnaryLinearAcc:
    """UnaryLinear accumulation bookkeeping (UnarySim conventions).

    ``acc_bound`` is the scaled-addition divisor (number of summed input
    streams, +1 when a bias stream joins); ``offset`` recenters bipolar
    sums so the output stream stays a valid rate code.
    """

    in_features: int
    bias: bool = False
    bipolar: bool = False

    @property
    def acc_bound(self) -> int:
        return self.in_features + (1 if self.bias else 0)

    @property
    def offset(self) -> float:
        if not self.bipolar:
            return 0.0
        return (self.in_features - 1) / 2 + (0.5 if self.bias else 0.0)


def scaled_output_stream(product_bits, acc: UnaryLinearAcc) -> torch.Tensor:
    """Fold per-cycle product bits into one scaled rate-coded output stream.

    ``product_bits``: ``(L, ..., in_features)`` bits in {0, 1}.  Each cycle
    adds the popcount across ``in_features`` into a running accumulator and
    emits one output bit whenever it crosses ``acc_bound``.  Returns int8
    ``(L, ...)`` bits.
    """
    psum = torch.sum(torch.as_tensor(product_bits).to(torch.int32), dim=-1,
                     dtype=torch.int32)
    carry = torch.zeros(psum.shape[1:], dtype=torch.int32, device=psum.device)
    out = []
    for s in psum:
        carry = carry + s
        bit = (carry >= acc.acc_bound).to(torch.int8)
        carry = carry - bit.to(torch.int32) * acc.acc_bound
        out.append(bit)
    return torch.stack(out)
