"""Interval arithmetic over per-design accumulator magnitudes.

The paper's exactness claims are *envelope* claims: each design's result is
bit-exact only while its accumulator register can represent the largest
partial value the contraction can produce.  This module computes those
worst-case (and sparsity-informed) magnitudes symbolically, so a (design,
bits, K) point can be proved safe before anything executes:

* ``bgemm`` / ``tugemm`` / ``tubgemm`` accumulate int32 partial sums whose
  functional magnitude is bounded by ``K * Vmax(bits)^2``; tuGEMM's counter
  bank additionally counts up to ``K * L^2`` pulses per output with
  ``L = 2^(bits-1)`` slots (the slot-parallel contraction sums one {-1, 0,
  1} increment per (slot_a, slot_b, k) triple), so its register bound is
  the pulse count, which dominates the functional bound.
* ``ugemm`` keeps its pulse counts in float32 (the BLAS-path trade
  documented in ``gemm_sims.ugemm_stream``): counts are exact integers only
  inside the fp32 exact-integer window, i.e. while ``L * K < 2^24`` with
  ``L = 2^bits`` slots.
* ``ugemm_stochastic`` (the rate-coded family in ``repro_torch.stochastic``)
  accumulates signed AND-pulse counts in an int32 adder tree: up to one
  pulse per (cycle, k) pair, so its register bound is ``K * stream_len``
  against int32 capacity.  The *count* is exact inside that envelope; the
  decoded *estimate* is not — its accuracy model is the separate
  :func:`stochastic_error_bound` (expected + tail relative RMSE vs exact
  uGEMM as a function of stream length), which the planner's accuracy
  guard and ``plan-lint``'s ``stream-guard`` rule consume.

Everything here is closed-form python arithmetic — no JAX — so the runtime
guards in ``repro_torch.backends`` can import it without cost and the property
tests can brute-force-check it against the simulators.

CUDA kernel mirrors (``tugemm_cuda``…) inherit their sibling's
envelope: :func:`design_family` strips the ``_cuda`` suffix, mirroring
``repro_torch.backends.registry.KERNEL_SIBLINGS``; spec spellings like
``"ugemm_stochastic:64"`` strip the stream-length suffix the same way.
"""

from __future__ import annotations

import dataclasses
import math

from repro_torch.analysis.findings import ERROR, Finding
from repro_torch.core.quantization import vmax

INT32_MAX = 2**31 - 1
#: Largest integer window in which every fp32 value is exact — uGEMM's
#: float-held pulse counts are bit-exact only strictly below 2^24.
FLOAT32_EXACT_MAX = 2**24 - 1

_MIRROR_SUFFIX = "_cuda"

#: The rate-coded family whose per-step pulse count is its *stream length*
#: (a plannable knob) rather than a function of the bit-width.
STOCHASTIC_FAMILY = "ugemm_stochastic"

#: Designs with a closed-form accumulator model: the paper's four units
#: plus the rate-coded stochastic family layered on uGEMM.
FAMILIES = ("bgemm", "ugemm", "tugemm", "tubgemm", STOCHASTIC_FAMILY)


@dataclasses.dataclass(frozen=True)
class Interval:
    """A closed interval ``[lo, hi]`` with the arithmetic the bounds need."""

    lo: float
    hi: float

    def __post_init__(self) -> None:
        if self.lo > self.hi:
            raise ValueError(f"empty interval: [{self.lo}, {self.hi}]")

    @classmethod
    def point(cls, v: float) -> "Interval":
        return cls(v, v)

    @classmethod
    def symmetric(cls, mag: float) -> "Interval":
        """``[-mag, +mag]`` — the value set of a signed magnitude bound."""
        return cls(-mag, mag)

    def __add__(self, other: "Interval") -> "Interval":
        return Interval(self.lo + other.lo, self.hi + other.hi)

    def __mul__(self, other: "Interval") -> "Interval":
        corners = (self.lo * other.lo, self.lo * other.hi,
                   self.hi * other.lo, self.hi * other.hi)
        return Interval(min(corners), max(corners))

    def scale(self, n: float) -> "Interval":
        """n-fold sum of independent copies (n >= 0): ``[n*lo, n*hi]``."""
        if n < 0:
            raise ValueError("scale expects a non-negative repeat count")
        return Interval(self.lo * n, self.hi * n)

    def contains(self, value: float) -> bool:
        return self.lo <= value <= self.hi

    @property
    def abs_max(self) -> float:
        return max(abs(self.lo), abs(self.hi))


def design_family(design: str) -> str:
    """Canonical envelope family of a design name (mirrors inherit).

    Spec spellings carrying a stream length (``"ugemm_stochastic:64"``)
    canonicalise to the bare family name.
    """
    base = design.partition(":")[0]
    if base.endswith(_MIRROR_SUFFIX):
        base = base[:-len(_MIRROR_SUFFIX)]
    return base


def _effective_k(k: int, word_sparsity: float) -> int:
    """Contraction terms that can be non-zero given a word-sparsity bound.

    ``word_sparsity`` is the fraction of exactly-zero quantized words (the
    planner's profiled ``stats.word``); a zero word contributes nothing to
    any accumulator, so at most ``ceil(k * (1 - s))`` terms carry magnitude.
    0.0 (the default) is the worst case.
    """
    if not 0.0 <= word_sparsity <= 1.0:
        raise ValueError(f"word_sparsity must be in [0, 1], "
                         f"got {word_sparsity}")
    return min(k, math.ceil(k * (1.0 - word_sparsity)))


def output_interval(design: str, bits: int, k: int, *,
                    word_sparsity: float = 0.0) -> Interval:
    """Interval containing the design's (M, N) output values.

    For the exact designs the output *is* the int32 accumulator; for uGEMM
    the estimate ``count * V^2/L <= |a||b|``-ish is still bounded by the
    same functional product sum.  Built from first principles with interval
    arithmetic: k-fold sum of the product of two ``[-V, +V]`` code
    intervals.
    """
    family = design_family(design)
    if family not in FAMILIES:
        raise KeyError(f"no accumulator model for design {design!r} "
                       f"(families: {FAMILIES})")
    v = Interval.symmetric(vmax(bits))
    return (v * v).scale(_effective_k(k, word_sparsity))


def counter_interval(design: str, bits: int, k: int, *,
                     word_sparsity: float = 0.0,
                     stream_len: int | None = None) -> Interval:
    """Interval of the *register* each design actually accumulates in.

    This is what capacity is checked against, and it can exceed the
    functional output bound: tuGEMM's counter sums one signed pulse per
    (slot_a, slot_b, k) triple — up to ``L^2`` per step, L = 2^(bits-1) —
    and uGEMM counts up to ``L = 2^bits`` AND-pulses per step before
    rescaling.  bgemm/tubgemm registers hold the functional partial sum
    itself (tubGEMM's slot weights sum back to the operand magnitude).
    The stochastic family counts up to ``stream_len`` signed AND-pulses
    per step (default one full period, ``2^bits``).
    """
    family = design_family(design)
    if family in ("bgemm", "tubgemm"):
        return output_interval(design, bits, k, word_sparsity=word_sparsity)
    if family == "tugemm":
        per_step = Interval.symmetric(2 ** (bits - 1)) \
            * Interval.symmetric(2 ** (bits - 1))
        return per_step.scale(_effective_k(k, word_sparsity))
    if family == "ugemm":
        per_step = Interval.symmetric(2 ** bits)
        return per_step.scale(_effective_k(k, word_sparsity))
    if family == STOCHASTIC_FAMILY:
        per_step = Interval.symmetric(
            2 ** bits if stream_len is None else stream_len)
        return per_step.scale(_effective_k(k, word_sparsity))
    raise KeyError(f"no accumulator model for design {design!r} "
                   f"(families: {FAMILIES})")


def capacity(design: str, bits: int) -> int:
    """Largest accumulator magnitude the design represents exactly."""
    if design_family(design) == "ugemm":
        return FLOAT32_EXACT_MAX
    return INT32_MAX


@dataclasses.dataclass(frozen=True)
class AccumulatorBound:
    """The verdict for one (design, bits, K) point."""

    design: str
    bits: int
    k: int
    interval: Interval        # register interval (capacity domain)
    output: Interval          # functional output interval
    capacity: int
    word_sparsity: float = 0.0
    stream_len: int | None = None

    @property
    def ok(self) -> bool:
        return self.interval.abs_max <= self.capacity

    @property
    def headroom(self) -> float:
        """capacity / |register| — > 1 means safe, with margin."""
        mag = self.interval.abs_max
        return math.inf if mag == 0 else self.capacity / mag

    def describe(self) -> str:
        kind = ("fp32 exact-int window" if design_family(self.design)
                == "ugemm" else "int32 accumulator")
        stream = (f" L={self.stream_len}" if self.stream_len is not None
                  else "")
        return (f"{self.design}@{self.bits}b{stream} K={self.k}: register "
                f"magnitude <= {self.interval.abs_max:.0f} vs {kind} "
                f"capacity {self.capacity} (headroom {self.headroom:.2f}x)")


def accumulator_bound(design: str, bits: int, k: int, *,
                      word_sparsity: float = 0.0,
                      stream_len: int | None = None) -> AccumulatorBound:
    """Bound the accumulator of a (·, K) x (K, ·) contraction.

    Raises ``KeyError`` for designs without an accumulator model — callers
    linting user plans should catch it and emit an ``unknown-design``
    finding instead.  ``stream_len`` scales the stochastic family's
    per-step pulse count; it is ignored for every other family.
    """
    if k < 0:
        raise ValueError(f"contraction length must be >= 0, got k={k}")
    return AccumulatorBound(
        design=design, bits=bits, k=k,
        interval=counter_interval(design, bits, k,
                                  word_sparsity=word_sparsity,
                                  stream_len=stream_len),
        output=output_interval(design, bits, k,
                               word_sparsity=word_sparsity),
        capacity=capacity(design, bits),
        word_sparsity=word_sparsity,
        stream_len=(stream_len
                    if design_family(design) == STOCHASTIC_FAMILY else None))


def max_safe_k(design: str, bits: int,
               stream_len: int | None = None) -> int:
    """Largest K for which ``accumulator_bound(design, bits, K).ok``.

    Closed form: the register magnitude is ``K * u`` for a per-step unit
    ``u`` (``Vmax^2``, ``L^2`` pulses, or ``L`` counts), so the envelope
    edge is ``capacity // u``.  0 means no contraction length is safe at
    this width (e.g. hypothetical ``ugemm`` above 24 bits).
    """
    per_step = counter_interval(design, bits, 1,
                                stream_len=stream_len).abs_max
    if per_step == 0:
        return INT32_MAX
    return int(capacity(design, bits) // per_step)


def check_gemm(design: str, bits: int, k: int, *, where: str,
               word_sparsity: float = 0.0,
               stream_len: int | None = None) -> Finding | None:
    """A ranges-pass finding if the point leaves its envelope, else None."""
    try:
        bound = accumulator_bound(design, bits, k,
                                  word_sparsity=word_sparsity,
                                  stream_len=stream_len)
    except KeyError:
        return Finding(
            pass_name="ranges", rule="unknown-design", severity=ERROR,
            where=where,
            message=f"design {design!r} has no accumulator model "
                    f"(families: {', '.join(FAMILIES)})")
    if bound.ok:
        return None
    return Finding(
        pass_name="ranges", rule="acc-overflow", severity=ERROR,
        where=where,
        message=f"{bound.describe()} — exceeds envelope; largest safe K "
                f"is {max_safe_k(design, bits, stream_len=stream_len)}")


def assert_within_envelope(design: str, bits: int, k: int, *,
                           where: str = "",
                           stream_len: int | None = None) -> None:
    """Runtime guard used by ``GemmBackend.execute`` and the grid path.

    Raises ``ValueError`` with an actionable message when the contraction
    would leave the design's validated accumulator envelope.  Unknown
    designs pass (custom registrations carry their own numerics contract).
    """
    try:
        bound = accumulator_bound(design, bits, k, stream_len=stream_len)
    except KeyError:
        return
    if bound.ok:
        return
    site = f" at {where}" if where else ""
    family = design_family(design)
    fix = (f"split the contraction (e.g. a GridBackend with units_x >= "
           f"{math.ceil(k / max(max_safe_k(design, bits, stream_len=stream_len), 1))}) "
           f"or use an int32-accumulating design"
           if family == "ugemm" else
           "shard the contraction over a GridBackend or lower the "
           "bit-width")
    raise ValueError(
        f"{design}@{bits}b cannot run a K={k} contraction{site}: "
        f"{bound.describe()}; results would silently stop being "
        f"bit-exact (largest safe K is "
        f"{max_safe_k(design, bits, stream_len=stream_len)}) — {fix}")


# ---------------------------------------------------------------------------
# Stochastic accuracy envelope (rate-coded estimate vs exact uGEMM)
# ---------------------------------------------------------------------------

#: Calibrated coefficients of the expected relative-RMSE model
#: ``c1 / stream_len + c2 / 2^bits`` — fit to upper-bound the measured
#: Sobol-paired curves in ``repro_torch.stochastic.error`` (see
#: ``benchmarks/stochastic_bench.py``, which gates measurements against
#: the tail bound on every run).  The ``1/L`` term is the low-discrepancy
#: pairing error; the ``1/2^bits`` term is the SourceGen-rounding floor
#: no stream length can cross.
STOCHASTIC_ERR_C1 = 2.5
STOCHASTIC_ERR_C2 = 4.0
#: Tail multiplier: measured per-site RMSE stays below ``tail = 2x
#: expected`` across seeds/shapes in calibration.
STOCHASTIC_ERR_TAIL = 2.0


@dataclasses.dataclass(frozen=True)
class StochasticErrorBound:
    """Analytic accuracy envelope of one ``(bits, stream_len)`` engine.

    ``expected`` / ``tail`` are *relative RMSE vs exact uGEMM* (the oracle
    the family replaces); squares of these are comparable to the planner's
    per-site relative-MSE guard.
    """

    bits: int
    stream_len: int
    expected: float
    tail: float

    @property
    def expected_rel_mse(self) -> float:
        return self.expected ** 2

    @property
    def tail_rel_mse(self) -> float:
        return self.tail ** 2

    def describe(self) -> str:
        return (f"{STOCHASTIC_FAMILY}@{self.bits}b L={self.stream_len}: "
                f"expected rel-RMSE {self.expected:.4f} "
                f"(tail {self.tail:.4f}) vs exact uGEMM")


def stochastic_error_bound(bits: int, stream_len: int) -> StochasticErrorBound:
    """Closed-form expected/tail error of the rate-coded family.

    This is the *static* half of the stochastic accuracy story: the
    planner pre-filters ``(bits, stream_len)`` candidates whose expected
    error already violates the accuracy guard, and ``plan-lint`` re-derives
    the same bound from a serialized plan (no JAX, no measurement).  The
    *measured* half — seeded per-site RMSE curves — lives in
    ``repro_torch.stochastic.error``.
    """
    if stream_len < 1:
        raise ValueError(f"stream_len must be >= 1, got {stream_len}")
    expected = STOCHASTIC_ERR_C1 / stream_len + STOCHASTIC_ERR_C2 / 2 ** bits
    return StochasticErrorBound(
        bits=bits, stream_len=stream_len, expected=expected,
        tail=STOCHASTIC_ERR_TAIL * expected)
