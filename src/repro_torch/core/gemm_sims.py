"""Functional + schedule-faithful simulators for the paper's four GEMM units.

Each design consumes *already-quantized* integer matrices ``a: (M, K)`` and
``b: (K, N)`` (int8 container holding w-bit values) and produces the unit's
output in int32 (exact designs) or float32 (uGEMM's estimate), together with
the latency the unit would incur.

Two fidelity levels, as in the reference:

* ``*_exact`` — fast functional forms the model-level inference path calls.
  For tuGEMM/tubGEMM/bGEMM the hardware is deterministic, so the exact
  result *is* integer GEMM (the CUDA kernels in
  ``repro_torch.kernels.unary_gemm`` execute the slot schedule literally);
  uGEMM's is the closed form of its unified temporal x rate streams.
* ``*_stream`` — schedule-faithful simulators returning ``(out, cycles)``,
  with one-slot-per-step ``*_stream_scan`` loops kept as the tests' oracles.

uGEMM (and the rate-coded family in ``repro_torch.stochastic``) counts, per
output, the slots where the A-port pulse and the B-port pulse are both 1.
The count is computed without the reference's ``(M, K, N)`` LUT gather,
which would not fit on a card at model width: every slot's B pulse is a
threshold on ``|b|`` (``rate[t] < |b| / V`` is monotone in ``|b|``), so the
slots group by threshold ``r`` and

    count = sum_r (D[|a|, r] * sgn a) @ ([|b| >= r] * sgn b)

with ``D[i, r]`` the number of threshold-``r`` slots in which magnitude
``i`` fires on port A — at most ``V = 2^(w-1) - 1`` products of the weight
size instead of ``2^w`` slot products.  The products run in float32 in
chunks of (thresholds x K) whose partial counts stay below 2^24, where
float32 is exact in any summation order; chunks add as integers, and the
count is scaled by ``V^2 / L`` once.  No temporary exceeds a byte budget
(``CHUNK_BUDGET_BYTES``).  The integer count equals the reference's
``ugemm_stream`` bit for bit; the reference's ``ugemm_exact`` sums scaled
LUT entries in float32, which equals it wherever that sum is exact (always
at 2 bits; at 4 bits while K < 21,399) and is within rounding of it at 8.

Latency formulas (paper §II, outer-product dataflow, ``N`` = common dim = K):

    bGEMM    : K
    uGEMM    : 2^w
    tuGEMM   : K * (2^(w-1))^2
    tubGEMM  : K * 2^(w-2)

Designs are dispatched through a registry (:func:`register_design`); the
built-in four register at import, in the reference's order.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import warnings
from typing import Callable

import numpy as np
import torch

from repro_torch.core import unary
from repro_torch.core.quantization import vmax

__all__ = [
    "DESIGNS",
    "DesignSpec",
    "register_design",
    "get_design",
    "registry_snapshot",
    "registry_restore",
    "scoped_registry",
    "wc_cycles",
    "dynamic_cycles_from_sparsity",
    "rel_rmse",
    "bgemm_exact",
    "tugemm_exact",
    "tubgemm_exact",
    "ugemm_exact",
    "ugemm_counts",
    "ugemm_decode",
    "tugemm_stream",
    "tubgemm_stream",
    "ugemm_stream",
    "tugemm_stream_scan",
    "tubgemm_stream_scan",
    "ugemm_stream_scan",
    "SlotGroups",
    "signed_slot_counts",
    "CHUNK_BUDGET_BYTES",
    "gemm",
    "gemm_batched",
    "stream_gemm",
]


# ---------------------------------------------------------------------------
# Design registry
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DesignSpec:
    """Everything the dispatch layer needs to know about one PE-array design.

    ``exact_fn(a, b, bits)`` — fast functional GEMM.
    ``stream_fn(a, b, bits)`` — schedule-faithful run, returns ``(out, cycles)``.
    ``wc_cycles_fn(bits, common_dim)`` — worst-case latency formula.
    ``sparsity_aware`` — True iff the unit early-terminates on bit sparsity
    (paper Eq. 1 applies); False runs at worst case regardless of operands.
    ``dyn_operand_fn(bits, step_max)`` — dynamic cycles from the per-outer-
    product-step max magnitudes ``step_max: (K,)``; None means worst case.
    ``exact`` — True iff the functional result is deterministic integer GEMM
    (bit-identical to the binary oracle); False for stochastic designs.
    ``count_fn(a, b, bits)`` / ``decode_fn(counts, bits)`` — for designs
    whose float result decodes an exact integer count (uGEMM and the
    rate-coded family): ``exact_fn == decode_fn(count_fn(...))``, and the
    int64 counts of two K-slices add exactly, which is how a PE-array grid
    reduces its shards before decoding once.  None for the int32 designs.
    """

    name: str
    exact_fn: Callable[[torch.Tensor, torch.Tensor, int], torch.Tensor]
    stream_fn: Callable[[torch.Tensor, torch.Tensor, int], tuple]
    wc_cycles_fn: Callable[[int, int], int]
    sparsity_aware: bool = False
    dyn_operand_fn: Callable[[int, torch.Tensor], torch.Tensor] | None = None
    exact: bool = True
    count_fn: Callable[[torch.Tensor, torch.Tensor, int], torch.Tensor] | None = None
    decode_fn: Callable[[torch.Tensor, int], torch.Tensor] | None = None


_REGISTRY: dict[str, DesignSpec] = {}

# Canonical design order (rebuilt by register_design; kept a plain tuple for
# the call sites that iterate over it).
DESIGNS: tuple[str, ...] = ()


def register_design(name: str,
                    exact_fn: Callable,
                    stream_fn: Callable,
                    wc_cycles_fn: Callable[[int, int], int],
                    *,
                    sparsity_aware: bool = False,
                    dyn_operand_fn: Callable | None = None,
                    exact: bool = True,
                    count_fn: Callable | None = None,
                    decode_fn: Callable | None = None,
                    overwrite: bool = False) -> DesignSpec:
    """Register a GEMM unit design with the dispatch layer.

    PPA *pricing* additionally needs paper-calibrated synthesis data, which
    ``core.ppa`` only has for the built-in four — pricing an uncalibrated
    design raises a clear error.  Consumers holding a from-import snapshot of
    ``DESIGNS`` won't see later registrations; read ``gemm_sims.DESIGNS`` via
    the module attribute for a live view.
    """
    global DESIGNS
    if name in _REGISTRY and not overwrite:
        raise ValueError(f"design {name!r} already registered")
    spec = DesignSpec(name=name, exact_fn=exact_fn, stream_fn=stream_fn,
                      wc_cycles_fn=wc_cycles_fn,
                      sparsity_aware=sparsity_aware,
                      dyn_operand_fn=dyn_operand_fn,
                      exact=exact, count_fn=count_fn, decode_fn=decode_fn)
    _REGISTRY[name] = spec  # analysis: allow-registry-mutation (this is the registry's own module)
    DESIGNS = tuple(_REGISTRY)
    return spec


def get_design(name: str) -> DesignSpec:
    """Look up a registered :class:`DesignSpec` by name (ValueError if absent)."""
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(f"unknown design {name!r}") from None


def registry_snapshot() -> dict[str, DesignSpec]:
    """Copy of the current design registry, for :func:`registry_restore`."""
    return dict(_REGISTRY)


def registry_restore(snapshot: dict[str, DesignSpec]) -> None:
    """Reset the registry (and ``DESIGNS``) to a :func:`registry_snapshot`."""
    global DESIGNS
    _REGISTRY.clear()
    _REGISTRY.update(snapshot)
    DESIGNS = tuple(_REGISTRY)


@contextlib.contextmanager
def scoped_registry():
    """Context manager: registry mutations inside the block don't escape it.

    Snapshots on entry and restores on exit (exception-safe, nestable).
    Yields the snapshot taken at entry.
    """
    snapshot = registry_snapshot()
    try:
        yield snapshot
    finally:
        registry_restore(snapshot)


# ---------------------------------------------------------------------------
# Latency model
# ---------------------------------------------------------------------------

def wc_cycles(design: str, bits: int, common_dim: int) -> int:
    """Worst-case cycles for one (n x n x common_dim) GEMM on the unit.

    §II formulas: bGEMM K, uGEMM 2^w, tuGEMM K*(2^(w-1))^2, tubGEMM
    K*2^(w-2).  Dimensionless count — multiply by ``ppa.CLOCK_PERIOD_NS``.
    """
    return get_design(design).wc_cycles_fn(bits, common_dim)


def dynamic_cycles_from_sparsity(design: str, bits: int, common_dim: int,
                                 bit_sparsity: float) -> float:
    """Paper Eq. 1: dynamic latency = WC latency * (1 - bit_sparsity).

    Only the temporal designs (tuGEMM, tubGEMM) exploit bit sparsity; uGEMM
    and bGEMM run at worst case regardless of operand values.
    """
    wc = wc_cycles(design, bits, common_dim)
    if get_design(design).sparsity_aware:
        return wc * (1.0 - float(bit_sparsity))
    return float(wc)


def _tugemm_dyn(bits: int, step_max: torch.Tensor) -> torch.Tensor:
    # outer stream gates inner full pass
    return torch.sum((2 ** (bits - 1)) * step_max)


def _tubgemm_dyn(bits: int, step_max: torch.Tensor) -> torch.Tensor:
    # 2-unary stream slots actually used
    per_step = torch.ceil(step_max.to(torch.float32) / 2.0)
    return torch.sum(torch.clamp(per_step, min=1))


def rel_rmse(est, oracle) -> float:
    """Relative RMSE of an estimate vs its oracle (0.0 means bit-exact).

    Computed in float64 on the tensors' device; guarded against an
    all-zero oracle.
    """
    est = torch.as_tensor(est).to(torch.float64)
    oracle = torch.as_tensor(oracle).to(device=est.device, dtype=torch.float64)
    denom = float(torch.sqrt(torch.mean(oracle ** 2)))
    return float(torch.sqrt(torch.mean((est - oracle) ** 2))) / max(denom, 1e-12)


# ---------------------------------------------------------------------------
# Fast functional paths
# ---------------------------------------------------------------------------

#: K-chunk inside which an fp32 product of int8 codes is exact in any
#: summation order: 512 * 128 * 128 = 2^23 < 2^24.
_FP32_EXACT_CHUNK = 512


def bgemm_exact(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:  # analysis: allow-float-accumulation (int32 matmul on the CPU; on CUDA K-chunked fp32 partial sums < 2^24 are exact integers)
    """Conventional binary GEMM: the int32 oracle every exact design equals.

    Args: ``a`` (M, K) and ``b`` (K, N) integer matrices (any int dtype
    holding int8-range codes).  Returns: (M, N) int32 product.

    CPU tensors use the integer matmul directly.  CUDA has no int32
    ``matmul``, so device tensors go through K-chunked fp32 products — each
    chunk's partial sums stay below 2^24, where fp32 (and TF32, which holds
    int8 values exactly) is exact in any order — summed in int32.
    ``torch._int_mm`` is not used: cuBLASLt on the H100 refuses row counts
    its shape rules admit (M = 24, 27), which a plan's prefill reaches.
    """
    if a.device.type != "cuda":
        return torch.matmul(a.to(torch.int32), b.to(torch.int32))
    out = torch.zeros((a.shape[0], b.shape[1]), dtype=torch.int32,
                      device=a.device)
    for lo in range(0, a.shape[1], _FP32_EXACT_CHUNK):
        hi = lo + _FP32_EXACT_CHUNK
        part = torch.matmul(a[:, lo:hi].to(torch.float32),
                            b[lo:hi].to(torch.float32))
        out += part.to(torch.int32)
    return out


def tugemm_exact(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """tuGEMM is deterministic: functional result == integer GEMM."""
    return bgemm_exact(a, b)


def tubgemm_exact(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """tubGEMM is deterministic: functional result == integer GEMM."""
    return bgemm_exact(a, b)


#: largest byte size of any one temporary :func:`signed_slot_counts` holds
CHUNK_BUDGET_BYTES = 1 << 30

#: float32 holds every integer below 2^24 exactly
_FP32_EXACT_COUNT = 1 << 24


def _threshold_table(pulses: torch.Tensor) -> torch.Tensor:
    """Per slot, the least magnitude whose B-port pulse fires (``V + 1`` for
    none), from a ``(V + 1, L)`` pulse table monotone in the magnitude."""
    p = pulses.to(torch.int64)
    if bool((p[1:] < p[:-1]).any()):
        raise ValueError("B-port pulses must be monotone in the magnitude")
    return p.shape[0] - p.sum(dim=0)


class SlotGroups:
    """A two-port slot schedule grouped by port B's threshold.

    Built from ``(V + 1, L)`` pulse tables: slot ``t`` of a magnitude-``i``
    operand fires on port A (port B) iff entry ``[i, t]``; port B's table
    must be monotone in ``i`` (a comparator threshold).  ``thresholds`` —
    the ``r`` in 1..V at which some slot's B pulse starts firing;
    ``counts`` — ``(V + 1, len(thresholds))`` float32: in how many
    threshold-``r`` slots magnitude ``i`` fires on port A; ``row_max`` — the
    largest per-magnitude slot total, which bounds a product's partial
    counts per k.  Device copies of ``counts`` are kept per device.
    """

    def __init__(self, a_pulses: torch.Tensor, b_pulses: torch.Tensor):
        nmag = a_pulses.shape[0]                              # V + 1
        thr = _threshold_table(b_pulses.cpu()).clamp(min=1)   # (L,)
        d = torch.zeros((nmag, nmag + 1), dtype=torch.int64)
        d.index_add_(1, thr, a_pulses.cpu().to(torch.int64))
        d = d[:, 1:nmag]                                      # r = 1..V
        keep = [r - 1 for r in range(1, nmag) if bool(d[:, r - 1].any())]
        self.thresholds = tuple(r + 1 for r in keep)
        self.counts = d[:, keep].to(torch.float32)
        self.row_max = int(d[:, keep].sum(dim=1).max()) if keep else 0
        self._on_device: dict = {}

    def on(self, device) -> tuple[torch.Tensor, torch.Tensor]:
        """``(counts, thresholds)`` as tensors on ``device``."""
        key = str(device)
        if key not in self._on_device:
            self._on_device[key] = (
                self.counts.to(device),
                torch.tensor(self.thresholds, dtype=torch.int16,
                             device=device))
        return self._on_device[key]


def _chunk_plan(m: int, k: int, n: int, groups: int,
                row_max: int) -> tuple[int, int]:
    """``(thresholds, k rows)`` per chunk: each float32 product's partial
    counts stay below 2^24 (``k_c * row_max``) and each of its two operands,
    ``(m, r_c * k_c)`` and ``(r_c * k_c, n)``, within
    :data:`CHUNK_BUDGET_BYTES`."""
    budget = CHUNK_BUDGET_BYTES
    k_c = max(1, min(k, (_FP32_EXACT_COUNT - 1) // max(row_max, 1),
                     budget // (4 * max(m, n))))
    r_c = max(1, min(groups, budget // (4 * k_c * max(m, n))))
    return r_c, k_c


def _chunk_product(a_chunk: torch.Tensor, w_chunk: torch.Tensor) -> torch.Tensor:
    """One chunk's exact float32 product of signed slot counts."""
    return torch.matmul(a_chunk, w_chunk)


def signed_slot_counts(a: torch.Tensor, b: torch.Tensor,
                       groups: SlotGroups) -> torch.Tensor:
    """Exact signed AND-pulse counts of a two-port slot schedule.

    Returns the int64 ``(M, N)`` counts ``sum_k sum_t A[|a|, t] B[|b|, t]
    sgn(a) sgn(b)`` of ``groups``' schedule, summed threshold by threshold
    as the module docstring sets out; :data:`CHUNK_BUDGET_BYTES` caps every
    temporary.  ``a`` and ``b`` must lie on one device; nothing is read
    back to the host.
    """
    if a.device != b.device:
        raise ValueError(f"operands on different devices: {a.device} and "
                         f"{b.device}")
    dev = a.device
    (m, k), n = a.shape, b.shape[1]
    counts = torch.zeros((m, n), dtype=torch.int64, device=dev)
    ng = len(groups.thresholds)
    if not ng or k == 0:
        return counts
    d_dev, thr_dev = groups.on(dev)
    r_c, k_c = _chunk_plan(m, k, n, ng, groups.row_max)
    for k0 in range(0, k, k_c):
        ak = a[:, k0:k0 + k_c].to(torch.int32)
        a_mag, a_sgn = torch.abs(ak).to(torch.int64), torch.sign(ak).to(torch.float32)
        bk = b[k0:k0 + k_c].to(torch.int16)
        b_mag, b_sgn = torch.abs(bk), torch.sign(bk).to(torch.float32)
        kk = ak.shape[1]
        for g0 in range(0, ng, r_c):
            rc = min(r_c, ng - g0)
            # port A: (m, rc, kk) signed slot counts of each magnitude
            a_buf = torch.mul(d_dev[:, g0:g0 + rc][a_mag].permute(0, 2, 1),
                              a_sgn[:, None, :]).contiguous()
            # port B: (rc, kk, n) signed thresholds [|b| >= r] * sgn(b)
            fires = b_mag[None] >= thr_dev[g0:g0 + rc, None, None]
            w_buf = torch.empty((rc, kk, n), dtype=torch.float32, device=dev)
            torch.mul(b_sgn[None], fires, out=w_buf)
            del fires
            part = _chunk_product(a_buf.view(m, -1), w_buf.view(-1, n))
            counts += part.to(torch.int64)
            del a_buf, w_buf, part
    return counts


def _scaled(counts: torch.Tensor, numer: int, denom: int) -> torch.Tensor:
    """``counts`` as float32 times ``fl32(numer / denom)``: the reference's
    float32 count times its weakly typed Python constant, one rounding."""
    return counts.to(torch.float32) * float(np.float32(numer / denom))


def _unified_streams(bits: int):
    """Comparator sequences of uGEMM's *unified* multiplier.

    Port A streams **temporal** (slot t fires iff ``t/L < |a|/V``); port B
    streams **rate** (van der Corput comparator).  Counting A AND B over
    the 2^w slots approximates ``|a|*|b|*L/V^2``.
    """
    L = unary.rate_stream_len(bits)
    temporal = torch.arange(L, dtype=torch.float32) / L
    rate = unary.van_der_corput(L)
    return temporal, rate, L


def _unified_tables(bits: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The ``(V + 1, L)`` pulse tables ``sa``/``sb`` of the reference's
    ``ugemm_exact``: the same float32 compares ``temporal < mags / V`` and
    ``rate < mags / V`` (CPU tensors)."""
    temporal, rate, _ = _unified_streams(bits)
    mags = torch.arange(vmax(bits) + 1, dtype=torch.float32) / vmax(bits)
    return temporal[None, :] < mags[:, None], rate[None, :] < mags[:, None]


@functools.lru_cache(maxsize=None)
def _unified_groups(bits: int) -> SlotGroups:
    return SlotGroups(*_unified_tables(bits))


def ugemm_counts(a: torch.Tensor, b: torch.Tensor, bits: int = 8) -> torch.Tensor:
    """uGEMM's exact signed AND-counts of its unified streams, (M, N) int64."""
    return signed_slot_counts(a, b, _unified_groups(bits))


def ugemm_decode(counts: torch.Tensor, bits: int = 8) -> torch.Tensor:
    """uGEMM's float32 estimate ``count * V^2 / L`` of :func:`ugemm_counts`."""
    V = vmax(bits)
    return _scaled(counts, V * V, unary.rate_stream_len(bits))


def ugemm_exact(a: torch.Tensor, b: torch.Tensor, bits: int = 8) -> torch.Tensor:  # analysis: allow-float-accumulation (float32 chunk products of integer counts below 2^24, summed as int64)
    """uGEMM's output: exact AND-counts of its unified streams, decoded.

    Args: ``a`` (M, K), ``b`` (K, N) integer codes at ``bits``, on one
    device.  Returns the (M, N) float32 estimate ``count * V^2 / L`` (see
    the module docstring for how this relates to the reference's LUT sum).
    """
    return ugemm_decode(ugemm_counts(a, b, bits), bits)


# ---------------------------------------------------------------------------
# Schedule-faithful stream simulators
# ---------------------------------------------------------------------------

def tugemm_stream(a: torch.Tensor, b: torch.Tensor, bits: int):
    """Counter-based fully-temporal GEMM on explicit pulse trains.

    For each step k, every 1-slot i of a's temporal stream replays b's full
    stream; slot pair (i, j) adds ``pulse_a[i] * pulse_b[j] * sign`` to the
    output counter.  Summing both slot axes first leaves one integer GEMM
    of the per-operand slot sums.  Returns ``(out int32, K * L^2)``.
    """
    L = unary.temporal_stream_len(bits)
    stream_a, sign_a = unary.encode_temporal(a, bits)   # (L, M, K), (M, K)
    stream_b, sign_b = unary.encode_temporal(b, bits)   # (L, K, N), (K, N)
    pa = torch.sum(stream_a * sign_a[None], dim=0, dtype=torch.int32)
    pb = torch.sum(stream_b * sign_b[None], dim=0, dtype=torch.int32)
    return bgemm_exact(pa, pb), a.shape[1] * L * L


def tubgemm_stream(a: torch.Tensor, b: torch.Tensor, bits: int):
    """Temporal-unary (a, 2-unary) x binary (b) hybrid GEMM.

    Per step k, a's magnitude streams over L2 = 2^(w-2) slots worth 2 each,
    the odd bit riding slot 0; b is added into the accumulators every slot
    its pulse is on.  Returns ``(out int32, K * L2)``.
    """
    L2 = unary.tub_stream_len(bits)
    stream2, lsb, sign = unary.encode_tub(a, bits)     # (L2, M, K), (M, K)
    weights = 2 * stream2
    weights[0] += lsb                                   # odd bit rides slot 0
    weights = weights * sign[None]
    out = bgemm_exact(torch.sum(weights, dim=0, dtype=torch.int32), b)
    return out, a.shape[1] * L2


def ugemm_stream(a: torch.Tensor, b: torch.Tensor, bits: int):
    """Unified-unary GEMM simulator: ``(float32 estimate, cycles = 2^w)``.

    Slot-wise AND multipliers feed signed parallel adder trees, so the
    accumulation over K is exact and only the multiply is stochastic; the
    counts come from :func:`signed_slot_counts`, bit-identical to the
    reference's float32 slot contraction (valid while ``L * K < 2^24``).
    """
    return ugemm_exact(a, b, bits=bits), unary.rate_stream_len(bits)


# ---------------------------------------------------------------------------
# One-slot-per-step references (the tests' oracles: tiny shapes only)
# ---------------------------------------------------------------------------

def tugemm_stream_scan(a: torch.Tensor, b: torch.Tensor, bits: int):
    """Slot-by-slot loop reference for :func:`tugemm_stream`."""
    L = 2 ** (bits - 1)
    ia, sa = torch.abs(a.to(torch.int32)), torch.sign(a.to(torch.int32))
    ib, sb = torch.abs(b.to(torch.int32)), torch.sign(b.to(torch.int32))
    K = a.shape[1]
    acc = torch.zeros((a.shape[0], b.shape[1]), dtype=torch.int32,
                      device=a.device)
    for k in range(K):
        sign = sa[:, k, None] * sb[None, k, :]
        for i in range(L):
            gate = (i < ia[:, k]).to(torch.int32)
            for j in range(L):
                pulse = (j < ib[k, :]).to(torch.int32)
                acc += gate[:, None] * pulse[None, :] * sign
    return acc, K * L * L


def tubgemm_stream_scan(a: torch.Tensor, b: torch.Tensor, bits: int):
    """Slot-by-slot loop reference for :func:`tubgemm_stream`."""
    L2 = max(1, 2 ** (bits - 2))
    ia, sa = torch.abs(a.to(torch.int32)), torch.sign(a.to(torch.int32))
    ib = b.to(torch.int32)
    K = a.shape[1]
    acc = torch.zeros((a.shape[0], b.shape[1]), dtype=torch.int32,
                      device=a.device)
    for k in range(K):
        v1, v0 = ia[:, k] // 2, ia[:, k] % 2
        for t in range(L2):
            weight = (2 * (t < v1).to(torch.int32)
                      + int(t == 0) * v0) * sa[:, k]
            acc += weight[:, None] * ib[None, k, :]
    return acc, K * L2


def ugemm_stream_scan(a: torch.Tensor, b: torch.Tensor, bits: int):
    """Slot-by-slot loop reference for :func:`ugemm_stream` (float32
    accumulation of one slot's pulse product per step, as the reference's
    scan)."""
    temporal, rate, L = _unified_streams(bits)
    V = vmax(bits)
    dev = a.device
    pa = torch.abs(a.to(torch.int32)).to(torch.float32) / V
    pb = torch.abs(b.to(torch.int32)).to(torch.float32) / V
    sgn_a = torch.sign(a.to(torch.float32))
    sgn_b = torch.sign(b.to(torch.float32))
    acc = torch.zeros((a.shape[0], b.shape[1]), dtype=torch.float32,
                      device=dev)
    for t in range(L):
        at = (float(temporal[t]) < pa).to(torch.float32) * sgn_a
        bt = (float(rate[t]) < pb).to(torch.float32) * sgn_b
        acc = acc + at @ bt
    return _scaled(acc, V * V, L), L


# ---------------------------------------------------------------------------
# Dispatch (deprecated shims)
#
# The string-keyed dispatch functions below predate the typed backend API in
# ``repro_torch.backends``; each warns once per process and returns what its
# replacement returns.
# ---------------------------------------------------------------------------

_DEPRECATION_EMITTED: set[str] = set()


def _warn_once(name: str, replacement: str) -> None:
    """One ``DeprecationWarning`` per process for the deprecated ``name``
    (qualified, or a function of this module), pointed at its caller's
    caller; ``kernels.backends`` shares it."""
    if name in _DEPRECATION_EMITTED:
        return
    _DEPRECATION_EMITTED.add(name)
    if "." not in name:
        name = f"repro_torch.core.gemm_sims.{name}"
    warnings.warn(f"{name} is deprecated; use {replacement}",
                  DeprecationWarning, stacklevel=3)


def gemm(design: str, a: torch.Tensor, b: torch.Tensor, bits: int = 8):
    """Deprecated: use ``repro_torch.backends.resolve(design, bits=...).execute``."""
    _warn_once("gemm", "repro_torch.backends.resolve(design, bits=bits)"
                       ".execute(a, b)")
    from repro_torch import backends
    return backends.resolve(design, bits=bits).execute(a, b)


def stream_gemm(design: str, a: torch.Tensor, b: torch.Tensor, bits: int = 8):
    """Deprecated: use ``repro_torch.backends.resolve(design, bits=...).stream``."""
    _warn_once("stream_gemm", "repro_torch.backends.resolve(design, "
                              "bits=bits).stream(a, b)")
    from repro_torch import backends
    return backends.resolve(design, bits=bits).stream(a, b)


def gemm_batched(design: str, a: torch.Tensor, b: torch.Tensor,
                 bits: int = 8):
    """Deprecated: use ``repro_torch.backends.resolve(design, bits=...).execute``.

    ``a``: (B, M, K) (or (M, K)); ``b``: (B, K, N) per-problem operands or
    (K, N) shared across the batch.
    """
    _warn_once("gemm_batched", "repro_torch.backends.resolve(design, "
                               "bits=bits).execute(a, b)")
    from repro_torch import backends
    return backends.resolve(design, bits=bits).execute(a, b)


# ---------------------------------------------------------------------------
# Built-in designs (paper §II), in the reference's registration order
# ---------------------------------------------------------------------------

register_design(
    "ugemm",
    exact_fn=lambda a, b, bits: ugemm_exact(a, b, bits=bits),
    stream_fn=lambda a, b, bits: ugemm_stream(a, b, bits),
    wc_cycles_fn=lambda bits, common_dim: 2 ** bits,
    exact=False,   # stochastic multiplier: estimate, not the int32 oracle
    count_fn=lambda a, b, bits: ugemm_counts(a, b, bits),
    decode_fn=lambda counts, bits: ugemm_decode(counts, bits),
)

register_design(
    "tugemm",
    exact_fn=lambda a, b, bits: tugemm_exact(a, b),
    stream_fn=lambda a, b, bits: tugemm_stream(a, b, bits),
    wc_cycles_fn=lambda bits, common_dim: common_dim * (2 ** (bits - 1)) ** 2,
    sparsity_aware=True,
    dyn_operand_fn=_tugemm_dyn,
)

register_design(
    "tubgemm",
    exact_fn=lambda a, b, bits: tubgemm_exact(a, b),
    stream_fn=lambda a, b, bits: tubgemm_stream(a, b, bits),
    wc_cycles_fn=lambda bits, common_dim: common_dim * 2 ** (bits - 2),
    sparsity_aware=True,
    dyn_operand_fn=_tubgemm_dyn,
)

register_design(
    "bgemm",
    exact_fn=lambda a, b, bits: bgemm_exact(a, b),
    stream_fn=lambda a, b, bits: (bgemm_exact(a, b), a.shape[1]),
    wc_cycles_fn=lambda bits, common_dim: common_dim,
)
