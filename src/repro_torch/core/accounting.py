"""Hardware-in-the-loop energy/latency accounting for model execution.

The paper prices a *single* GEMM unit; a real DLA runs a model as thousands of
tiled GEMM invocations.  This module walks a model's GEMM workload — produced
by the modeling layer via `GemmWorkloadRecorder` — and prices every matmul on
a chosen unit design with its *measured* weight bit sparsity (Eq. 1), giving
end-to-end per-token / per-batch energy, latency and an energy-per-MAC view.

This is the "extend Table V + Fig. 3 to whole models" machinery: the paper
profiles weights and plugs average sparsity into a 32x32 unit; we price each
layer with its own block-max sparsity and the actual tile counts.
"""

from __future__ import annotations

import dataclasses
import math

from repro_torch.core import ppa
from repro_torch.core.sparsity import SparsityStats

__all__ = ["GemmCall", "GemmWorkloadRecorder", "ModelCost", "GridCost",
           "PackedStoreReport", "packed_store_report", "price_workload"]


@dataclasses.dataclass(frozen=True)
class GemmCall:
    """One logical matmul: (m, k) @ (k, n_out), with the weight on the k side."""

    name: str
    m: int
    k: int
    n_out: int
    bit_sparsity: float = 0.0   # block-max stat of the temporal (weight) operand
    count: int = 1              # identical invocations (e.g. scanned layers)

    @property
    def macs(self) -> int:
        return self.m * self.k * self.n_out * self.count


class GemmWorkloadRecorder:
    """Collects GemmCalls during an abstract forward pass."""

    def __init__(self) -> None:
        self.calls: list[GemmCall] = []

    def record(self, name: str, m: int, k: int, n_out: int,
               bit_sparsity: float = 0.0, count: int = 1) -> None:
        self.calls.append(GemmCall(name, int(m), int(k), int(n_out),
                                   float(bit_sparsity), int(count)))

    def attach_sparsity(self, stats: dict[str, SparsityStats]) -> None:
        """Overwrite per-call sparsity from profiled weight stats by name."""
        updated = []
        for c in self.calls:
            s = stats.get(c.name)
            if s is not None:
                c = dataclasses.replace(c, bit_sparsity=s.bit_blockmax)
            updated.append(c)
        self.calls = updated


@dataclasses.dataclass(frozen=True)
class ModelCost:
    """Priced workload on one DLA configuration."""

    design: str
    bits: int
    unit_n: int
    num_units: int
    total_macs: int
    wc_latency_us: float
    dyn_latency_us: float
    wc_energy_uj: float
    dyn_energy_uj: float
    per_layer: dict[str, tuple[float, float]]  # name -> (dyn_us, dyn_uj)

    @property
    def energy_per_mac_pj(self) -> float:
        return self.dyn_energy_uj * 1e6 / max(self.total_macs, 1)

    @property
    def sparsity_saving(self) -> float:
        """Fractional energy saved by Eq. 1 vs worst case."""
        if self.wc_energy_uj == 0:
            return 0.0
        return 1.0 - self.dyn_energy_uj / self.wc_energy_uj


@dataclasses.dataclass(frozen=True)
class GridCost(ModelCost):
    """A :class:`ModelCost` priced on a ``units_x`` × ``units_y`` grid of
    DLA nodes (``repro_torch.core.ppa.GridDLAModel`` tiling).

    Extra fields over the single-node cost: the grid shape, the interconnect
    share of the dynamic totals (``hop_energy_uj`` / ``hop_latency_us``, also
    folded into ``dyn_*``/``wc_*``), and ``utilization`` — the MAC-weighted
    mean useful/padded ratio across the workload (1.0 when every contraction
    divides the grid evenly).  Consumers that only understand ``ModelCost``
    (sweet-spot ranking, serve cost tables) keep working: a grid prices as
    one bigger, hop-taxed DLA.
    """

    units_x: int = 1
    units_y: int = 1
    hop_energy_uj: float = 0.0
    hop_latency_us: float = 0.0
    utilization: float = 1.0

    @property
    def grid(self) -> tuple[int, int]:
        return (self.units_x, self.units_y)

    @property
    def hop_energy_share(self) -> float:
        """Fraction of the dynamic energy spent on chip-to-chip links."""
        if self.dyn_energy_uj == 0:
            return 0.0
        return self.hop_energy_uj / self.dyn_energy_uj


def price_workload(calls: list[GemmCall], design="tubgemm",
                   bits: int = 4, unit_n: int = 128,
                   num_units: int = 1, grid=None) -> ModelCost:
    """Price ``calls`` on a DLA built from ``design`` at ``bits`` width.

    ``design`` is a name or a ``repro_torch.backends.GemmBackend`` (whose own
    ``bits`` / ``pricing_design`` then win): CUDA kernel mirrors price as
    their simulator sibling, the rate-coded stochastic family as uGEMM
    scaled by ``backend.cycle_scale``, and uncalibrated designs fail in ppa
    with a clear "no PPA calibration" error.

    ``grid`` — optional ``(units_x, units_y)`` tensor-parallel grid of DLA
    nodes; a ``repro_torch.backends.GridBackend`` supplies its own grid
    shape.  With a grid the result is a :class:`GridCost` priced on the
    ``ppa.GridDLAModel`` sharded tiling (per-shard tile counts plus the
    interconnect hop terms).
    """
    from repro_torch import backends
    backend = (design if isinstance(design, backends.GemmBackend)
               else backends.resolve(design, bits=bits))
    if grid is None:
        grid = getattr(backend, "grid", None)
    design, bits = backend.pricing_design, backend.bits
    # Stream-coded backends price as their pricing design with a per-tile
    # cycle multiplier (stream_len / 2^bits); 1.0 for everything else.
    cycle_scale = float(backend.cycle_scale)
    if grid is not None:
        return _price_grid(calls, design, bits, unit_n, num_units,
                           int(grid[0]), int(grid[1]),
                           cycle_scale=cycle_scale)
    dla = ppa.DLAModel(design=design, bits=bits, n=unit_n,
                       num_units=num_units, cycle_scale=cycle_scale)
    wc_ns = dyn_ns = wc_nj = dyn_nj = 0.0
    per_layer: dict[str, tuple[float, float]] = {}
    macs = 0
    for c in calls:
        l_wc = dla.matmul_latency_ns(c.m, c.k, c.n_out, 0.0) * c.count
        l_dyn = dla.matmul_latency_ns(c.m, c.k, c.n_out, c.bit_sparsity) * c.count
        e_wc = dla.matmul_energy_nj(c.m, c.k, c.n_out, 0.0) * c.count
        e_dyn = dla.matmul_energy_nj(c.m, c.k, c.n_out, c.bit_sparsity) * c.count
        wc_ns += l_wc
        dyn_ns += l_dyn
        wc_nj += e_wc
        dyn_nj += e_dyn
        prev = per_layer.get(c.name, (0.0, 0.0))
        per_layer[c.name] = (prev[0] + l_dyn * 1e-3, prev[1] + e_dyn * 1e-3)
        macs += c.macs
    return ModelCost(
        design=design, bits=bits, unit_n=unit_n, num_units=num_units,
        total_macs=macs,
        wc_latency_us=wc_ns * 1e-3, dyn_latency_us=dyn_ns * 1e-3,
        wc_energy_uj=wc_nj * 1e-3, dyn_energy_uj=dyn_nj * 1e-3,
        per_layer=per_layer,
    )


@dataclasses.dataclass(frozen=True)
class PackedStoreReport:
    """Weight-memory footprint of a (possibly partially) bit-packed tree.

    ``float32_bytes`` counts every weight leaf at fp32; ``stored_bytes``
    counts packed leaves at their word+scale footprint and unpacked leaves
    at fp32, so ``reduction`` is the end-to-end factor on the whole store
    and ``packed_reduction`` the factor on just the packed sites.
    """

    float32_bytes: int
    stored_bytes: int
    packed_sites: int
    total_sites: int
    packed_float32_bytes: int
    packed_stored_bytes: int

    @property
    def reduction(self) -> float:
        return self.float32_bytes / max(self.stored_bytes, 1)

    @property
    def packed_reduction(self) -> float:
        return self.packed_float32_bytes / max(self.packed_stored_bytes, 1)


def _tree_leaves(tree):
    from repro_torch.core import packing
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _tree_leaves(tree[key])
    elif isinstance(tree, (list, tuple)) and not packing.is_packed(tree):
        for leaf in tree:
            yield from _tree_leaves(leaf)
    else:
        yield tree


def packed_store_report(params) -> PackedStoreReport:
    """Walk a nested-dict parameter tree and total the weight-store bytes
    (packed vs fp32).

    Counts every tensor leaf at fp32 (4 bytes an element) unless it is a
    packed store; ``total_sites`` is the number of ``ndim >= 2`` leaves (the
    GEMM-shaped ones that can be packed).
    """
    from repro_torch.core import packing

    f32 = stored = 0
    packed_sites = total_sites = 0
    packed_f32 = packed_stored = 0
    for leaf in _tree_leaves(params):
        if packing.is_packed(leaf):
            f32 += leaf.float32_bytes
            stored += leaf.stored_bytes
            packed_f32 += leaf.float32_bytes
            packed_stored += leaf.stored_bytes
            packed_sites += 1
            total_sites += 1
            continue
        if not hasattr(leaf, "ndim"):
            continue
        nbytes = leaf.numel() * 4
        f32 += nbytes
        stored += nbytes
        if leaf.ndim >= 2:
            total_sites += 1
    return PackedStoreReport(
        float32_bytes=f32, stored_bytes=stored,
        packed_sites=packed_sites, total_sites=total_sites,
        packed_float32_bytes=packed_f32, packed_stored_bytes=packed_stored)


def _price_grid(calls: list[GemmCall], design: str, bits: int, unit_n: int,
                num_units: int, units_x: int, units_y: int, *,
                cycle_scale: float = 1.0) -> GridCost:
    """The grid branch of :func:`price_workload` (same contract)."""
    gdla = ppa.GridDLAModel(design=design, bits=bits, n=unit_n,
                            num_units=num_units, units_x=units_x,
                            units_y=units_y, cycle_scale=cycle_scale)
    wc_ns = dyn_ns = wc_nj = dyn_nj = hop_nj = hop_ns = 0.0
    per_layer: dict[str, tuple[float, float]] = {}
    macs = padded_macs = 0
    for c in calls:
        l_wc = gdla.matmul_latency_ns(c.m, c.k, c.n_out, 0.0) * c.count
        l_dyn = gdla.matmul_latency_ns(c.m, c.k, c.n_out,
                                       c.bit_sparsity) * c.count
        e_wc = gdla.matmul_energy_nj(c.m, c.k, c.n_out, 0.0) * c.count
        e_dyn = gdla.matmul_energy_nj(c.m, c.k, c.n_out,
                                      c.bit_sparsity) * c.count
        hop_nj += gdla.hop_energy_nj(c.m, c.k, c.n_out) * c.count
        hop_ns += gdla.hop_latency_ns() * c.count
        wc_ns += l_wc
        dyn_ns += l_dyn
        wc_nj += e_wc
        dyn_nj += e_dyn
        prev = per_layer.get(c.name, (0.0, 0.0))
        per_layer[c.name] = (prev[0] + l_dyn * 1e-3, prev[1] + e_dyn * 1e-3)
        macs += c.macs
        ks, ns = gdla.shard_dims(c.k, c.n_out)
        padded_macs += c.m * ks * units_x * ns * units_y * c.count
    return GridCost(
        design=design, bits=bits, unit_n=unit_n, num_units=num_units,
        total_macs=macs,
        wc_latency_us=wc_ns * 1e-3, dyn_latency_us=dyn_ns * 1e-3,
        wc_energy_uj=wc_nj * 1e-3, dyn_energy_uj=dyn_nj * 1e-3,
        per_layer=per_layer,
        units_x=units_x, units_y=units_y,
        hop_energy_uj=hop_nj * 1e-3, hop_latency_us=hop_ns * 1e-3,
        utilization=(macs / padded_macs) if padded_macs else 1.0,
    )
