"""Sweet-spot explorer: cross-design PPA sweeps over bits x size x design.

The paper's §IV contribution beyond the individual units is the *sweet-spot
analysis*: post-synthesis PPA swept across bit-widths and matrix sizes to
find where each unary design beats binary GEMM (Tables I-IV, Fig. 2).  This
module turns that from a fixed set of tables into an explorable space:

* :func:`sweep` prices every (design, bits, n) point through ``core.ppa`` —
  paper-grid points are the exact published values, off-grid points come from
  the per-design log-log fit (monotone in ``n`` and exact on the grid).
* :func:`winners` / :func:`winner_grid` reduce the sweep to the per-metric
  winning design at every (bits, n), with the margin over the runner-up.
* :func:`crossovers` finds the frontier: walking ``n`` upward at fixed bits,
  the points where a metric's winner changes hands (e.g. the tubGEMM-over-
  bGEMM 4-bit energy takeover between 32x32 and 64x64 the paper highlights).
* :func:`kernel_crosscheck` executes the hand-written CUDA kernels (the
  ``*_cuda`` mirrors, resolved as typed ``repro_torch.backends`` objects —
  no registry mutation) and verifies their outputs and cycle reports
  against the stream simulators and ``wc_cycles``; on the card by default,
  on the kernels' plain versions with ``device="cpu"``.
* :func:`recommend_backend` prices a *model's* recorded GEMM workload
  (``core.accounting``) on every design and names the optimal backend for the
  model's actual layer shapes — wired into ``launch/serve.py``.

Units note (everything lower-is-better): ``area_um2`` um^2, ``power_mw`` mW,
``latency_ns`` ns (worst-case), ``energy_nj`` nJ per GEMM, ``adp_mm2_ns``
mm^2*ns.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Sequence

import numpy as np
import torch

from repro_torch.configs import paper_gemm
from repro_torch.core import gemm_sims, ppa
from repro_torch.core.accounting import GemmCall

__all__ = [
    "METRICS",
    "DEFAULT_BITS",
    "DEFAULT_SIZES",
    "CALIBRATED_DESIGNS",
    "SweepPoint",
    "Winner",
    "Crossover",
    "SweetspotReport",
    "sweep",
    "winners",
    "winner_grid",
    "crossovers",
    "kernel_crosscheck",
    "grid_fidelity",
    "build_report",
    "recommend_backend",
]

#: metric names, all lower-is-better
METRICS: tuple[str, ...] = ("area_um2", "power_mw", "latency_ns",
                            "energy_nj", "adp_mm2_ns")

DEFAULT_BITS: tuple[int, ...] = (2, 4, 8)
DEFAULT_SIZES: tuple[int, ...] = (16, 32, 64, 128, 256)

#: the four designs the paper synthesized (the only ones ppa can price)
CALIBRATED_DESIGNS: tuple[str, ...] = paper_gemm.DESIGNS

_METRIC_FNS = {
    "area_um2": ppa.area_um2,
    "power_mw": ppa.power_mw,
    "latency_ns": lambda d, b, n: ppa.latency_ns(d, b, n),
    "energy_nj": lambda d, b, n: ppa.energy_nj(d, b, n),
    "adp_mm2_ns": ppa.adp_mm2_ns,
}


@dataclasses.dataclass(frozen=True)
class SweepPoint:
    """One priced configuration: an n x n ``design`` unit at ``bits`` width.

    ``on_grid`` is True iff (bits, n) is a paper-synthesized point, i.e. the
    metric values are the exact published Table I/II numbers (and Table
    III/IV derivations) rather than log-log-fit extrapolations.
    """

    design: str
    bits: int
    n: int
    on_grid: bool
    wc_cycles: int
    area_um2: float
    power_mw: float
    latency_ns: float
    energy_nj: float
    adp_mm2_ns: float

    def metric(self, name: str) -> float:
        """Value of one of :data:`METRICS` (raises AttributeError if unknown)."""
        return getattr(self, name)


@dataclasses.dataclass(frozen=True)
class Winner:
    """Per-metric winner at one (bits, n): lowest-valued design.

    ``margin`` is runner-up value / winner value (>= 1.0; how decisively the
    winner wins).  ``values`` maps every competing design to its value.
    """

    metric: str
    bits: int
    n: int
    design: str
    value: float
    runner_up: str
    margin: float
    values: dict[str, float]


@dataclasses.dataclass(frozen=True)
class Crossover:
    """A frontier edge: walking n upward at fixed bits, ``metric``'s winner
    changes from ``from_design`` (still best at ``n_below``) to ``to_design``
    (best from ``n_at`` on)."""

    metric: str
    bits: int
    n_below: int
    n_at: int
    from_design: str
    to_design: str


@dataclasses.dataclass(frozen=True)
class SweetspotReport:
    """Everything :mod:`repro_torch.eval.report` serializes."""

    bits: tuple[int, ...]
    sizes: tuple[int, ...]
    designs: tuple[str, ...]
    points: list[SweepPoint]
    winners: list[Winner]
    crossovers: list[Crossover]
    grid_fidelity: dict[str, float]
    kernel_crosscheck: list[dict]


def sweep(bits_list: Sequence[int] = DEFAULT_BITS,
          sizes: Sequence[int] = DEFAULT_SIZES,
          designs: Sequence[str] = CALIBRATED_DESIGNS) -> list[SweepPoint]:
    """Price the full (design x bits x n) cross product.

    Args: ``bits_list`` — operand widths; ``sizes`` — square unit sizes n;
    ``designs`` — registry design names (must have ppa calibration).
    Returns: one :class:`SweepPoint` per combination, grid hits exact.
    """
    pts = []
    for bits in bits_list:
        for n in sizes:
            on_grid = (bits, n) in ppa.AREA_UM2
            for d in designs:
                pts.append(SweepPoint(
                    design=d, bits=bits, n=n, on_grid=on_grid,
                    wc_cycles=gemm_sims.wc_cycles(d, bits, n),
                    **{m: float(fn(d, bits, n))
                       for m, fn in _METRIC_FNS.items()}))
    return pts


def winners(points: Iterable[SweepPoint]) -> list[Winner]:
    """Reduce a sweep to the per-(metric, bits, n) winning design."""
    by_cell: dict[tuple[int, int], list[SweepPoint]] = {}
    for p in points:
        by_cell.setdefault((p.bits, p.n), []).append(p)
    out = []
    for (bits, n), cell in sorted(by_cell.items()):
        for metric in METRICS:
            ranked = sorted(cell, key=lambda p: p.metric(metric))
            best, second = ranked[0], ranked[min(1, len(ranked) - 1)]
            out.append(Winner(
                metric=metric, bits=bits, n=n, design=best.design,
                value=best.metric(metric), runner_up=second.design,
                margin=second.metric(metric) / max(best.metric(metric), 1e-30),
                values={p.design: p.metric(metric) for p in cell}))
    return out


def winner_grid(points: Iterable[SweepPoint]
                ) -> dict[str, dict[tuple[int, int], Winner]]:
    """``{metric: {(bits, n): Winner}}`` view of :func:`winners`."""
    grid: dict[str, dict[tuple[int, int], Winner]] = {m: {} for m in METRICS}
    for w in winners(points):
        grid[w.metric][(w.bits, w.n)] = w
    return grid


def crossovers(points: Iterable[SweepPoint]) -> list[Crossover]:
    """Frontier edges: winner changes along ascending n at fixed (metric, bits)."""
    grid = winner_grid(points)
    out = []
    for metric, cells in grid.items():
        by_bits: dict[int, list[tuple[int, Winner]]] = {}
        for (bits, n), w in cells.items():
            by_bits.setdefault(bits, []).append((n, w))
        for bits, seq in sorted(by_bits.items()):
            seq.sort(key=lambda t: t[0])
            for (n0, w0), (n1, w1) in zip(seq, seq[1:]):
                if w0.design != w1.design:
                    out.append(Crossover(metric=metric, bits=bits,
                                         n_below=n0, n_at=n1,
                                         from_design=w0.design,
                                         to_design=w1.design))
    return out


def grid_fidelity(points: Iterable[SweepPoint]) -> dict[str, float]:
    """Max relative error of on-grid sweep values vs the published tables.

    ``area_um2`` / ``power_mw`` compare against the verbatim Table I/II data
    (must be 0.0 — grid hits bypass the fit); ``energy_nj`` / ``adp_mm2_ns``
    compare the derived values against the paper's rounded Table III/IV
    entries (< 1%, the repo-wide reproduction bar).
    """
    errs = {"area_um2": 0.0, "power_mw": 0.0, "energy_nj": 0.0,
            "adp_mm2_ns": 0.0}

    def rel(got, ref):
        return abs(got - ref) / abs(ref)

    for p in points:
        if not p.on_grid:
            continue
        key = (p.bits, p.n)
        errs["area_um2"] = max(errs["area_um2"],
                               rel(p.area_um2, ppa.AREA_UM2[key][p.design]))
        errs["power_mw"] = max(errs["power_mw"],
                               rel(p.power_mw, ppa.POWER_MW[key][p.design]))
        if key in ppa.PAPER_ENERGY_NJ:
            errs["energy_nj"] = max(
                errs["energy_nj"],
                rel(p.energy_nj, ppa.PAPER_ENERGY_NJ[key][p.design]))
        if key in ppa.PAPER_ADP_MM2_NS:
            errs["adp_mm2_ns"] = max(
                errs["adp_mm2_ns"],
                rel(p.adp_mm2_ns, ppa.PAPER_ADP_MM2_NS[key][p.design]))
    return errs


def kernel_crosscheck(bits_list: Sequence[int] = (2, 4, 8),
                      mkn: tuple[int, int, int] = (8, 16, 8),
                      block: tuple[int, int, int] = (32, 32, 32),
                      seed: int = 0, device="cuda") -> list[dict]:
    """Run the CUDA kernel backends against their simulator siblings.

    Resolves each ``*_cuda`` mirror / simulator pair as typed
    ``repro_torch.backends`` objects — pure construction, the ``gemm_sims``
    registry is never touched.  For each pair and bit-width both engines
    run the same random (m, k) x (k, n) operands (drawn with numpy from
    ``seed``, the reference's draws) on ``device``; records bit-identity of
    outputs, equality of the kernel's cycle report with the simulator's,
    and with the analytic worst-case cycle model.  Returns one dict per
    (design, bits) with boolean ``output_ok`` / ``cycles_ok`` plus both
    cycle numbers.

    On a CUDA device the mirrors launch the hand-written kernels (any shape
    launches, however far under the kernels' tiles); on the CPU they run
    the kernels' plain versions.  ``block`` is the reference's Pallas tile
    and keeps its signature: the CUDA kernels choose their own tiles and
    ignore it.
    """
    from repro_torch import backends

    del block   # the CUDA kernels pick their own tiles
    rng = np.random.default_rng(seed)
    m, k, n = mkn
    rows = []
    for bits in bits_list:
        v = 2 ** (bits - 1) - 1
        a = torch.from_numpy(rng.integers(-v, v + 1, (m, k)).astype(np.int8)
                             ).to(device)
        b = torch.from_numpy(rng.integers(-v, v + 1, (k, n)).astype(np.int8)
                             ).to(device)
        for name, sibling in backends.KERNEL_SIBLINGS.items():
            kb = backends.resolve(name, bits=bits)
            sb = backends.resolve(sibling, bits=bits)
            k_out, k_cyc = kb.stream(a, b)
            s_out, s_cyc = sb.stream(a, b)
            wc = sb.cycles(k)
            rows.append(dict(
                design=sibling, kernel=name, bits=bits, m=m, k=k, n=n,
                output_ok=bool(torch.equal(k_out.cpu(), s_out.cpu())),
                cycles_ok=(int(k_cyc) == int(s_cyc) == wc),
                kernel_cycles=int(k_cyc), sim_cycles=int(s_cyc),
                wc_cycles=wc))
    return rows


def build_report(bits_list: Sequence[int] = DEFAULT_BITS,
                 sizes: Sequence[int] = DEFAULT_SIZES,
                 designs: Sequence[str] = CALIBRATED_DESIGNS,
                 *, crosscheck: bool = True, device="cuda") -> SweetspotReport:
    """Assemble the full sweet-spot report (see :class:`SweetspotReport`).

    ``crosscheck=False`` skips the kernel execution (pure cost-model sweep);
    otherwise :func:`kernel_crosscheck` runs on ``device``.
    """
    pts = sweep(bits_list, sizes, designs)
    return SweetspotReport(
        bits=tuple(bits_list), sizes=tuple(sizes), designs=tuple(designs),
        points=pts, winners=winners(pts), crossovers=crossovers(pts),
        grid_fidelity=grid_fidelity(pts),
        kernel_crosscheck=(kernel_crosscheck(bits_list, device=device)
                           if crosscheck else []))


def recommend_backend(calls: list[GemmCall], *, bits: int, unit_n: int,
                      num_units: int = 1,
                      designs: Sequence[str] = CALIBRATED_DESIGNS,
                      costs: dict | None = None) -> dict[str, dict]:
    """Name the optimal PE-array design for a model's actual GEMM workload.

    Prices ``calls`` (recorded layer shapes + measured bit sparsity, see
    ``core.accounting``) on every design at the given ``bits`` / ``unit_n``
    and ranks them.  Callers that already priced the workload (serve's cost
    table) pass ``costs`` — ``{design: ModelCost}`` — to skip the
    re-pricing; ``calls``/``bits``/``unit_n`` are then unused.  Returns
    ``{objective: {"best": design, "ranking": [(design, value), ...]}}`` for
    the four serving objectives — ``dyn_energy_uj``, ``wc_energy_uj`` (uJ)
    and ``dyn_latency_us``, ``wc_latency_us`` (us); lower is better,
    rankings ascending.
    """
    if costs is None:
        from repro_torch import backends
        costs = {d: backends.resolve(d, bits=bits)
                 .price(calls, unit_n=unit_n, num_units=num_units)
                 for d in designs}
    out: dict[str, dict] = {}
    for objective in ("dyn_energy_uj", "wc_energy_uj",
                      "dyn_latency_us", "wc_latency_us"):
        ranking = sorted(((d, getattr(c, objective))
                          for d, c in costs.items()), key=lambda t: t[1])
        out[objective] = {"best": ranking[0][0], "ranking": ranking}
    return out
