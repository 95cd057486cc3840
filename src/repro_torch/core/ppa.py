"""Calibrated Power-Performance-Area model for the four GEMM units.

The paper's post-synthesis Tables I (area), II (power) and IV (64x64/128x128
@4-bit) are embedded verbatim as calibration data.  Energy (Table III/IV) and
ADP (Table IV) are *derived* quantities:

    energy = power * wc_cycles(design, bits, N) * CLOCK_PERIOD_NS
    ADP    = area  * wc_cycles(design, bits, N) * CLOCK_PERIOD_NS

We verified every derived entry reproduces the paper's tables (tests assert
< 1% relative error, limited only by the paper's rounding).

Off-grid queries — any (bits, n) the paper did not synthesize — use a
per-design log-log least-squares fit ``log2 x = c0 + cw*log2(w) + cn*log2(n)``
over all calibration points.  Grid hits always return the exact paper value.
The paper's Fig. 2 "slopes" are the geometric ratio per bitwidth doubling
(e.g. uGEMM power slope 1.56 = sqrt(784.4/323.8)); ``fig2_slope`` reproduces
them.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from repro_torch.core.gemm_sims import DESIGNS, wc_cycles

__all__ = [
    "CLOCK_PERIOD_NS",
    "HOP_CYCLES",
    "HOP_ENERGY_PJ_PER_BYTE",
    "AREA_UM2",
    "POWER_MW",
    "area_um2",
    "power_mw",
    "latency_ns",
    "energy_nj",
    "adp_mm2_ns",
    "fig2_slope",
    "dynamic_energy_nj",
    "PPAQuery",
    "DLAModel",
    "GridDLAModel",
]

CLOCK_PERIOD_NS = 2.5  # 400 MHz, Nangate45 (paper §III-A)

# --- Inter-chip interconnect model (GridDLAModel) ---------------------------
# The paper prices single units; composing them into a multi-chip grid adds
# link traffic the unit tables cannot see.  One hop = moving one shard-local
# operand/result tile to a neighbouring chip over a NoC-class link.  The
# constants are deliberately round figures in the range of published 2.5-D
# interposer links (~32 link cycles latency, ~10 pJ/byte including SerDes) —
# they set the *scale* of the composition overhead, not a calibrated value,
# and every grid number the repo emits carries them explicitly.
HOP_CYCLES = 32              # link latency per hop, in unit clock cycles
HOP_ENERGY_PJ_PER_BYTE = 10.0  # link energy per byte moved chip-to-chip

# --- Table I: post-synthesis cell area (um^2) --------------------------------
# key: (bits, n) ; value order follows DESIGNS = (ugemm, tugemm, tubgemm, bgemm)
AREA_UM2: dict[tuple[int, int], dict[str, float]] = {
    (2, 16): dict(ugemm=99_445.7, tugemm=13_436.4, tubgemm=19_112.6, bgemm=16_739.1),
    (2, 32): dict(ugemm=791_794.4, tugemm=52_272.4, tubgemm=76_375.5, bgemm=67_201.7),
    (4, 16): dict(ugemm=203_920.7, tugemm=29_061.0, tubgemm=38_912.6, bgemm=44_925.8),
    (4, 32): dict(ugemm=1_799_961.0, tugemm=117_261.3, tubgemm=151_933.6, bgemm=180_458.6),
    (8, 16): dict(ugemm=445_396.2, tugemm=61_064.0, tubgemm=99_916.8, bgemm=132_786.9),
    (8, 32): dict(ugemm=3_689_829.0, tugemm=235_470.9, tubgemm=338_692.7, bgemm=560_778.5),
    # Table IV (4-bit, EdgeTPU / CloudTPUv3 sizes), converted mm^2 -> um^2
    (4, 64): dict(ugemm=15.89e6, tugemm=0.46e6, tubgemm=0.59e6, bgemm=1.09e6),
    (4, 128): dict(ugemm=140.24e6, tugemm=1.83e6, tubgemm=2.41e6, bgemm=6.64e6),
}

# --- Table II: post-synthesis total power (mW) -------------------------------
POWER_MW: dict[tuple[int, int], dict[str, float]] = {
    (2, 16): dict(ugemm=42.2, tugemm=4.9, tubgemm=5.0, bgemm=7.7),
    (2, 32): dict(ugemm=323.8, tugemm=18.3, tubgemm=19.8, bgemm=30.9),
    (4, 16): dict(ugemm=64.1, tugemm=9.2, tubgemm=9.9, bgemm=22.4),
    (4, 32): dict(ugemm=513.6, tugemm=37.2, tubgemm=39.1, bgemm=88.3),
    (8, 16): dict(ugemm=100.8, tugemm=19.7, tubgemm=26.1, bgemm=72.8),
    (8, 32): dict(ugemm=784.4, tugemm=74.7, tubgemm=90.9, bgemm=321.3),
    # Table IV (4-bit)
    (4, 64): dict(ugemm=4_115.21, tugemm=145.52, tubgemm=154.42, bgemm=496.77),
    (4, 128): dict(ugemm=32_973.04, tugemm=579.28, tubgemm=620.92, bgemm=2_794.80),
}

# Paper Table III / IV reference energies (nJ) — used only by tests/benchmarks
# to validate the derived model; *not* consumed by the model itself.
PAPER_ENERGY_NJ: dict[tuple[int, int], dict[str, float]] = {
    (2, 16): dict(ugemm=0.42, tugemm=0.78, tubgemm=0.20, bgemm=0.31),
    (2, 32): dict(ugemm=3.24, tugemm=5.86, tubgemm=1.58, bgemm=2.47),
    (4, 16): dict(ugemm=2.56, tugemm=23.55, tubgemm=1.58, bgemm=0.90),
    (4, 32): dict(ugemm=20.54, tugemm=190.46, tubgemm=12.51, bgemm=7.06),
    (8, 16): dict(ugemm=64.51, tugemm=12_910.59, tubgemm=66.82, bgemm=2.91),
    (8, 32): dict(ugemm=502.02, tugemm=97_910.78, tubgemm=465.41, bgemm=25.70),
    (4, 64): dict(ugemm=164.61, tugemm=1_490.12, tubgemm=98.83, bgemm=79.48),
    (4, 128): dict(ugemm=1_318.92, tugemm=11_863.65, tubgemm=794.78, bgemm=894.34),
}

PAPER_ADP_MM2_NS: dict[tuple[int, int], dict[str, float]] = {
    (4, 64): dict(ugemm=635.6, tugemm=4_710.4, tubgemm=377.6, bgemm=174.4),
    (4, 128): dict(ugemm=5_609.6, tugemm=37_478.4, tubgemm=3_084.8, bgemm=2_124.8),
}


def _fit(table: dict[tuple[int, int], dict[str, float]], design: str):
    """Least-squares log-log fit: log2(x) = c0 + cw*log2(bits) + cn*log2(n)."""
    pts = [(b, n, vals[design]) for (b, n), vals in table.items()]
    A = np.array([[1.0, math.log2(b), math.log2(n)] for b, n, _ in pts])
    y = np.array([math.log2(v) for _, _, v in pts])
    coef, *_ = np.linalg.lstsq(A, y, rcond=None)
    return coef  # (c0, cw, cn)


_AREA_FIT = {d: _fit(AREA_UM2, d) for d in DESIGNS}
_POWER_FIT = {d: _fit(POWER_MW, d) for d in DESIGNS}


def _lookup(table, fit, design: str, bits: int, n: int) -> float:
    if design not in fit:
        # registered-but-uncalibrated designs (gemm_sims.register_design)
        # can simulate GEMMs, but pricing needs paper synthesis data
        raise ValueError(f"no PPA calibration for design {design!r}; "
                         f"paper tables cover {tuple(fit)}")
    key = (bits, n)
    if key in table:
        return table[key][design]
    c0, cw, cn = fit[design]
    return float(2.0 ** (c0 + cw * math.log2(bits) + cn * math.log2(n)))


def area_um2(design: str, bits: int, n: int) -> float:
    """Synthesized cell area of one n x n GEMM unit.

    Args: ``design`` — calibrated design name (``ugemm``/``tugemm``/
    ``tubgemm``/``bgemm``); ``bits`` — operand bit-width w; ``n`` — square
    PE-array size.
    Returns: area in **um^2** — the exact Table I value on the paper grid,
    the log-log fit off-grid.  Raises ValueError for uncalibrated designs.
    """
    return _lookup(AREA_UM2, _AREA_FIT, design, bits, n)


def power_mw(design: str, bits: int, n: int) -> float:
    """Total post-synthesis power of one n x n GEMM unit.

    Args: as :func:`area_um2`.
    Returns: power in **mW** (Table II exact on the grid, fit off-grid).
    """
    return _lookup(POWER_MW, _POWER_FIT, design, bits, n)


def latency_ns(design: str, bits: int, common_dim: int,
               bit_sparsity: float = 0.0) -> float:
    """Wall-clock latency of one GEMM on the unit.

    Args: ``design``/``bits`` as above; ``common_dim`` — the contraction
    length K the unit streams over (equals n for the paper's square GEMMs);
    ``bit_sparsity`` — fraction in [0, 1), Eq. 1 dynamic scaling (only the
    temporal designs tuGEMM/tubGEMM exploit it; others ignore it).
    Returns: latency in **ns** = cycles x ``CLOCK_PERIOD_NS`` (2.5 ns @
    400 MHz).  Not an area/power table lookup — pure cycle model.
    """
    cyc = wc_cycles(design, bits, common_dim)
    if design in ("tugemm", "tubgemm") and bit_sparsity:
        cyc = cyc * (1.0 - bit_sparsity)
    return cyc * CLOCK_PERIOD_NS


def energy_nj(design: str, bits: int, n: int, common_dim: int | None = None,
              bit_sparsity: float = 0.0) -> float:
    """Energy of one GEMM on an n x n unit: power x latency.

    Args: ``n`` — unit size (prices power); ``common_dim`` — contraction
    length K (prices latency; defaults to n, the paper's Tables III/IV
    convention); ``bit_sparsity`` — Eq. 1 scaling, 0 for worst case.
    Returns: energy in **nJ** (P[mW] x t[ns] x 1e-3).
    """
    N = n if common_dim is None else common_dim
    t_ns = latency_ns(design, bits, N, bit_sparsity)
    # P[mW] * t[ns] = 1e-12 J = 1e-3 nJ
    return power_mw(design, bits, n) * t_ns * 1e-3


def fig2_slope(table: dict, design: str, n: int = 32) -> float:
    """Paper Fig. 2 'slope': geometric ratio per bit-width doubling.

    Args: ``table`` — ``AREA_UM2`` or ``POWER_MW``; ``design`` — design name;
    ``n`` — size at which the slope is read (paper uses 32).
    Returns: dimensionless ratio ``sqrt(x(8b) / x(2b))`` — the factor the
    metric grows per 2b -> 4b -> 8b doubling.
    """
    lo, hi = table[(2, n)][design], table[(8, n)][design]
    return math.sqrt(hi / lo)


def dynamic_energy_nj(design: str, bits: int, n: int, bit_sparsity: float,
                      common_dim: int | None = None) -> float:
    """Fig. 3 right panel: workload-dependent energy via Eq. 1.

    Same args/units as :func:`energy_nj` (returns **nJ**) with
    ``bit_sparsity`` mandatory — the measured block-max weight sparsity.
    """
    return energy_nj(design, bits, n, common_dim, bit_sparsity)


def adp_mm2_ns(design: str, bits: int, n: int, common_dim: int | None = None) -> float:
    """Area-Delay Product of one GEMM on an n x n unit (Table IV).

    Args: as :func:`energy_nj` (``common_dim`` defaults to n).
    Returns: ADP in **mm^2 * ns** (area converted um^2 -> mm^2, worst-case
    latency — the paper tabulates ADP without sparsity scaling).
    """
    N = n if common_dim is None else common_dim
    return area_um2(design, bits, n) * 1e-6 * latency_ns(design, bits, N)


@dataclasses.dataclass(frozen=True)
class PPAQuery:
    """Convenience record bundling every metric for one configuration.

    Fields: ``design`` — calibrated design name; ``bits`` — operand width;
    ``n`` — square unit size.  Properties return area in mm^2, power in mW,
    worst-case latency in ns, worst-case energy in nJ and ADP in mm^2*ns.
    """

    design: str
    bits: int
    n: int

    @property
    def area_mm2(self) -> float:
        """Unit area in mm^2 (Table I um^2 value x 1e-6)."""
        return area_um2(self.design, self.bits, self.n) * 1e-6

    @property
    def power_mw(self) -> float:
        """Total power in mW (Table II)."""
        return power_mw(self.design, self.bits, self.n)

    @property
    def wc_latency_ns(self) -> float:
        """Worst-case (zero-sparsity) latency in ns, common_dim = n."""
        return latency_ns(self.design, self.bits, self.n)

    @property
    def wc_energy_nj(self) -> float:
        """Worst-case energy in nJ per GEMM, common_dim = n."""
        return energy_nj(self.design, self.bits, self.n)

    @property
    def adp(self) -> float:
        """Area-Delay Product in mm^2*ns (Table IV)."""
        return adp_mm2_ns(self.design, self.bits, self.n)


@dataclasses.dataclass(frozen=True)
class DLAModel:
    """A deep-learning accelerator built from ``num_units`` n x n GEMM units.

    Maps a (M, K, N_out) matmul onto the unit grid with the same tiling the
    device GEMM kernels use (outer-product over K inside a tile), and prices it
    with the calibrated PPA model.  ``bit_sparsity`` comes from the weight
    operand's measured block-max statistics (core.sparsity).
    """

    design: str = "tubgemm"
    bits: int = 4
    n: int = 128              # PE array size (CloudTPUv3-like default)
    num_units: int = 1
    # Per-tile cycle multiplier for designs whose slot count deviates from
    # the named design's wc_cycles formula.  The rate-coded stochastic
    # family prices as uGEMM (same datapath power, k-independent cycles)
    # scaled by stream_len / 2^bits — energy and latency are linear in
    # cycles, so one factor covers both.
    cycle_scale: float = 1.0

    def tiles(self, m: int, n_out: int) -> int:
        """Number of n x n output tiles a (m, n_out) result decomposes into."""
        return math.ceil(m / self.n) * math.ceil(n_out / self.n)

    def matmul_latency_ns(self, m: int, k: int, n_out: int,
                          bit_sparsity: float = 0.0) -> float:
        """End-to-end (m, k) @ (k, n_out) latency in **ns**: per-tile latency
        (common_dim = k, Eq. 1 scaled) x ceil(tiles / num_units) waves."""
        per_tile = latency_ns(self.design, self.bits, k, bit_sparsity) \
            * self.cycle_scale
        waves = math.ceil(self.tiles(m, n_out) / self.num_units)
        return per_tile * waves

    def matmul_energy_nj(self, m: int, k: int, n_out: int,
                         bit_sparsity: float = 0.0) -> float:
        """Total matmul energy in **nJ**: per-tile energy x tile count
        (independent of num_units — parallel units burn the same total)."""
        per_tile = energy_nj(self.design, self.bits, self.n, common_dim=k,
                             bit_sparsity=bit_sparsity) * self.cycle_scale
        return per_tile * self.tiles(m, n_out)

    @property
    def total_area_mm2(self) -> float:
        """Silicon area of the whole unit grid in **mm^2**."""
        return area_um2(self.design, self.bits, self.n) * 1e-6 * self.num_units


@dataclasses.dataclass(frozen=True)
class GridDLAModel:
    """A tensor-parallel grid of ``units_x`` × ``units_y`` DLA nodes.

    Each node is a :class:`DLAModel` (``num_units`` n×n units of ``design``
    at ``bits``).  One (M, K) @ (K, N_out) matmul is sharded the way
    ``repro_torch.backends.grid.GridBackend.execute`` executes it: the contraction
    dim K is ceil-split ``units_x`` ways (partial sums reduced chip-to-chip),
    N_out is ceil-split ``units_y`` ways (disjoint output column slices), M
    is replicated.  Latency is the per-shard latency plus the interconnect
    critical path; energy is the per-shard energy summed over all shards plus
    the link energy of the activation fan-out and the partial-sum reduction.
    """

    design: str = "tubgemm"
    bits: int = 4
    n: int = 128
    num_units: int = 1
    units_x: int = 1          # K-dim partitions (partial-sum reduction)
    units_y: int = 1          # N-dim partitions (disjoint column slices)
    cycle_scale: float = 1.0  # see DLAModel.cycle_scale

    def __post_init__(self) -> None:
        if self.units_x < 1 or self.units_y < 1:
            raise ValueError(f"grid must be >= 1x1, got "
                             f"{self.units_x}x{self.units_y}")

    @property
    def num_shards(self) -> int:
        return self.units_x * self.units_y

    def node(self) -> DLAModel:
        """The per-shard single-chip cost model."""
        return DLAModel(design=self.design, bits=self.bits, n=self.n,
                        num_units=self.num_units,
                        cycle_scale=self.cycle_scale)

    def shard_dims(self, k: int, n_out: int) -> tuple[int, int]:
        """Per-shard (k, n_out) after the ceil-split (padded rows/cols)."""
        return (math.ceil(k / self.units_x), math.ceil(n_out / self.units_y))

    def utilization(self, m: int, k: int, n_out: int) -> float:
        """Useful MACs / padded MACs across the grid, in (0, 1].

        1.0 when ``units_x | k`` and ``units_y | n_out``; below 1.0 the
        ceil-split pads the operands with zero codes and the padded lanes
        burn cycles without contributing."""
        ks, ns = self.shard_dims(k, n_out)
        return (m * k * n_out) / (m * ks * self.units_x * ns * self.units_y)

    def hop_latency_ns(self) -> float:
        """Interconnect critical path per matmul: the activation fan-out
        across ``units_y`` columns plus the ``units_x``-chip partial-sum
        reduction, one hop each step."""
        hops = (self.units_x - 1) + (self.units_y - 1)
        return hops * HOP_CYCLES * CLOCK_PERIOD_NS

    def hop_energy_nj(self, m: int, k: int, n_out: int) -> float:
        """Link energy per matmul in **nJ**.

        Two traffic terms: every activation shard is fanned out to the other
        ``units_y - 1`` column replicas (w-bit codes), and every output
        column slice is reduced across ``units_x`` chips ((units_x - 1)
        int32 partial-tile moves).  Padded dims are what actually moves.
        """
        if self.num_shards == 1:
            return 0.0
        ks, ns = self.shard_dims(k, n_out)
        a_bytes = m * ks * self.units_x * self.bits / 8.0
        psum_bytes = m * ns * self.units_y * 4.0
        pj = ((self.units_y - 1) * a_bytes + (self.units_x - 1) * psum_bytes) \
            * HOP_ENERGY_PJ_PER_BYTE
        return pj * 1e-3

    def matmul_latency_ns(self, m: int, k: int, n_out: int,
                          bit_sparsity: float = 0.0) -> float:
        """End-to-end grid matmul latency in **ns**: all shards run in
        parallel (equal padded sizes), so per-shard latency + hop path."""
        ks, ns = self.shard_dims(k, n_out)
        return self.node().matmul_latency_ns(m, ks, ns, bit_sparsity) \
            + self.hop_latency_ns()

    def matmul_energy_nj(self, m: int, k: int, n_out: int,
                         bit_sparsity: float = 0.0) -> float:
        """Total grid matmul energy in **nJ**: per-shard compute energy
        summed over all ``units_x * units_y`` shards, plus link energy."""
        ks, ns = self.shard_dims(k, n_out)
        compute = self.node().matmul_energy_nj(m, ks, ns, bit_sparsity) \
            * self.num_shards
        return compute + self.hop_energy_nj(m, k, n_out)

    @property
    def total_area_mm2(self) -> float:
        """Silicon area of every node's unit grid in **mm^2**."""
        return self.node().total_area_mm2 * self.num_shards
