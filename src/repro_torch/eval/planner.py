"""Per-layer mixed-precision backend planner (paper Table V + Eq. 1 + Fig. 3
composed into a decision).

The paper's sweet-spot conclusion is a *map*, not a winner: which GEMM design
is cheapest depends on bit-width, matrix size, and — through Eq. 1 — the
measured weight bit sparsity.  This module turns that map into an executable
per-site assignment:

1. **Discover** every dense GEMM site of a model with one forward pass on
   the ``meta`` device under ``repro_torch.backends.record_sites`` — no
   FLOPs run and no weight is read; the site names and contraction shapes
   are exactly what ``models/common.dense`` executes under a backend scope.
2. **Profile** each site's weight with ``core.sparsity.profile_tensor`` at
   every candidate bit-width (word / element-bit / block-max-bit sparsity)
   and measure its quantization error (relative per-output-channel MSE, the
   accuracy-guard statistic), on the device the weights live on, one row
   chunk at a time.
3. **Price** every (site, design, bits) candidate on the ``core.ppa`` DLA
   tiling with Eq. 1 sparsity-scaled dynamic cycles instead of worst case,
   drop candidates whose quantization error violates the guard — and,
   first, candidates whose accumulator envelope the site's contraction
   length provably leaves (``repro_torch.analysis.ranges``); the pruning
   evidence ships in the plan's ``range_pruned`` meta block.
4. **Pick** the per-site argmin of the objective.
5. **Emit** a typed :class:`repro_torch.backends.BackendPlan`, which
   ``repro_torch.backends.use_plan`` executes and ``launch/serve.py
   --backend-plan`` replays.

Because every uniform single-backend assignment that satisfies the guard at
all sites is in each site's candidate set, the planned total is ≤ the best
uniform plan's total by construction.

With ``ugemm_stochastic`` in ``designs`` and ``stream_lens`` given, each
bit-width also gets rate-coded ``(ugemm_stochastic, bits, L)`` candidates,
guarded by the analytic stream-error bound and then by the error measured
on the site's own weight.

:func:`build_grid_plan` plans a ``units_x`` × ``units_y`` PE-array grid:
each site's weight is cut the way ``GridBackend.execute`` shards it, every
shard's slice is profiled on its own (a strided view on the weight's
device, walked in row chunks), and each shard gets its own plan beside the
aggregate one execution replays (a
:class:`repro_torch.backends.GridPlan`).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import torch

from repro_torch.analysis import ranges as ranges_lib
from repro_torch.backends import grid as grid_lib
from repro_torch.backends import runtime as runtime_lib
from repro_torch.backends.plan import BackendPlan, SiteAssignment
from repro_torch.core import packing, ppa, sparsity
from repro_torch.core.quantization import _codes, _scale_from_amax
from repro_torch.core.sparsity import SparsityStats

__all__ = [
    "DEFAULT_BITS_CANDIDATES",
    "DEFAULT_DESIGNS",
    "DEFAULT_MAX_REL_MSE",
    "DEFAULT_STREAM_LENS",
    "STOCHASTIC_DESIGN",
    "GemmSite",
    "Candidate",
    "discover_sites",
    "meta_forward",
    "meta_like",
    "sites_from_calls",
    "quantization_rel_mse",
    "price_site",
    "prune_infeasible",
    "site_candidates",
    "build_plan",
    "build_grid_plan",
    "measure_site_cycles",
    "measure_grid_site_cycles",
    "plan_totals",
    "to_markdown",
    "grid_plan_to_markdown",
]

#: candidate operand widths (paper grid); 2-bit usually fails the guard
DEFAULT_BITS_CANDIDATES: tuple[int, ...] = (2, 4, 8)
#: exact calibrated designs — stochastic uGEMM is excluded by default so a
#: planned model stays bit-identical to the binary oracle
DEFAULT_DESIGNS: tuple[str, ...] = ("tugemm", "tubgemm", "bgemm")
#: default accuracy guard: per-site relative quantization MSE ceiling
DEFAULT_MAX_REL_MSE: float = 0.05
#: the rate-coded family (opt-in: add to ``designs`` + pass ``stream_lens``)
STOCHASTIC_DESIGN = ranges_lib.STOCHASTIC_FAMILY
#: default stream lengths tried per stochastic candidate
DEFAULT_STREAM_LENS: tuple[int, ...] = (16, 32, 64, 128)

#: elements per row chunk of :func:`quantization_rel_mse`'s two passes
_REL_MSE_CHUNK_ELEMS = 1 << 26


@dataclasses.dataclass(frozen=True)
class GemmSite:
    """One plannable GEMM site of a model.

    ``name`` — the site name per the runtime naming contract (equals the
    weight's parameter-tree path); ``m``/``k``/``n_out`` — the per-invocation
    contraction ``(m, k) @ (k, n_out)`` ``dense`` performs there; ``count`` —
    invocations per forward pass (stacked layers); ``leaf`` — the site's
    parameter-tree leaf, held by reference (zero-copy).
    """

    name: str
    m: int
    k: int
    n_out: int
    count: int
    leaf: object = dataclasses.field(repr=False, compare=False)

    def weight_matrix(self) -> torch.Tensor:
        """The (count · k, n_out) float32 matrix the contraction consumes
        (all invocations stacked along rows): a view of a float32 leaf on
        its own device, never a copy (other dtypes are converted).

        Refuses a bit-packed leaf: the planner's sparsity/guard statistics
        and candidate quantization must read the *pre-quantization* float
        weight — re-quantizing a :class:`PackedQuantized` store's
        dequantized codes at a second width would compound rounding error
        into every downstream plan decision.
        """
        if packing.is_packed(self.leaf):
            raise TypeError(
                f"site {self.name!r}: leaf is an already-packed "
                f"{self.leaf.bits}-bit PackedQuantized store — plan from the "
                f"float parameters (pack with backends.pack_weights only "
                f"*after* planning); re-quantizing packed codes at a second "
                f"width compounds quantization error")
        w = self.leaf.reshape(-1, self.n_out)
        return w if w.dtype == torch.float32 else w.to(torch.float32)


@dataclasses.dataclass(frozen=True)
class Candidate:
    """One priced (design, bits[, stream_len]) option for a site.

    ``stream_len`` is 0 for count-exact designs.  For stochastic candidates
    ``rel_mse`` is the combined statistic: quantization rel-MSE plus the
    measured stream-error rel-RMSE squared.
    """

    design: str
    bits: int
    stats: SparsityStats
    rel_mse: float
    guard_ok: bool
    dyn_energy_uj: float
    dyn_latency_us: float
    wc_energy_uj: float
    wc_latency_us: float
    stream_len: int = 0


def _walk(tree, prefix=()):
    """``("/"-joined path, leaf)`` of a nested-dict tree (packed stores are
    leaves), in sorted key order."""
    for key in sorted(tree):
        node = tree[key]
        if isinstance(node, dict):
            yield from _walk(node, prefix + (str(key),))
        else:
            yield "/".join(prefix + (str(key),)), node


def _leaf_index(params) -> dict:
    return dict(_walk(params))


def meta_like(tree):
    """The tree's geometry on the ``meta`` device (packed stores by their
    logical shape): what discovery runs the forward on."""
    if isinstance(tree, dict):
        return {k: meta_like(v) for k, v in tree.items()}
    dtype = tree.scale.dtype if packing.is_packed(tree) else tree.dtype
    return torch.empty(tuple(tree.shape), dtype=dtype, device="meta")


def discover_sites(cfg, params, *, batch: int = 1,
                   seq_len: int = 8) -> list[GemmSite]:
    """Find every dense GEMM site of ``cfg``'s model, with weights attached.

    Runs one forward pass on the ``meta`` device — parameters and tokens
    carry shapes only, so no FLOPs run and nothing is allocated — inside a
    ``repro_torch.backends.record_sites`` scope, and joins the recorded
    (site, k, n_out) against the parameter tree by the same ``/``-joined
    path ``serving/energy.py`` walks.  ``count`` per site is ``leaf size /
    (k · n_out)`` (the stacked-layers multiplier), times the number of
    shared-block applications for the hybrid family's ``shared/…`` sites.
    Sites hold the parameter leaves by reference.

    ``m`` is reported for a *decode step*: ``batch`` rows per invocation
    (``seq_len`` only shapes the discovery pass).  Returns sites in model
    order, deduplicated by name.
    """
    from repro_torch import backends

    with torch.no_grad(), backends.record_sites() as rec:
        meta_forward(cfg, meta_like(params), batch=batch, seq_len=seq_len)
    return sites_from_calls(cfg, params, rec.calls, batch=batch)


def meta_forward(cfg, meta_params, *, batch: int = 1, seq_len: int = 8):
    """One forward of ``cfg``'s model on ``meta`` parameters and inputs
    (token ids, or float32 embeddings for a frontend stub): shapes only."""
    from repro_torch.models import model as model_lib

    if getattr(cfg, "frontend_stub", False):
        embeds = torch.empty((batch, seq_len, cfg.d_model),
                             dtype=torch.float32, device="meta")
        return model_lib.forward(meta_params, cfg, embeds=embeds)
    tokens = torch.zeros((batch, seq_len), dtype=torch.int32, device="meta")
    return model_lib.forward(meta_params, cfg, tokens)


def sites_from_calls(cfg, params, calls, *, batch: int = 1) -> list[GemmSite]:
    """Join the ``record_sites`` calls of a discovery forward against the
    parameter tree (see :func:`discover_sites`)."""
    leaves = _leaf_index(params)
    shared_applications = 1
    if getattr(cfg, "family", None) == "hybrid":
        from repro_torch.models import blocks as blocks_lib
        shared_applications = blocks_lib.hybrid_counts(cfg)[0]

    sites: list[GemmSite] = []
    seen: set[str] = set()
    for call in calls:
        if call.site in seen:
            continue
        seen.add(call.site)
        leaf = leaves.get(call.site)
        if leaf is None:
            raise ValueError(
                f"recorded site {call.site!r} has no parameter-tree leaf — "
                "a dense(name=...) annotation disagrees with the param path")
        size = math.prod(leaf.shape)
        count = size // (call.k * call.n_out)
        if count * call.k * call.n_out != size:
            raise ValueError(
                f"site {call.site!r}: leaf shape {tuple(leaf.shape)} is not "
                f"a stack of (k={call.k}, n_out={call.n_out}) matrices")
        if call.site.startswith("shared/"):
            count *= shared_applications
        sites.append(GemmSite(name=call.site, m=max(int(batch), 1),
                              k=call.k, n_out=call.n_out, count=count,
                              leaf=leaf))
    return sites


def quantization_rel_mse(w: torch.Tensor, bits: int) -> float:
    """Relative quantization MSE of a 2-D ``w`` at ``bits`` — the guard
    statistic.

    Per-output-channel symmetric quantization (exactly what
    ``models/common.dense`` applies to the weight under a backend scope),
    dequantized and compared to the original: ``mean((w - dq)²) /
    mean(w²)``.  Dimensionless; 0 = lossless, ~0.01–0.03 for 4-bit Gaussian
    weights, ≫ 0.1 for 2-bit.

    Walks ``w`` in row chunks on its own device: one pass for the column
    maxima, one for the two sums (float32 elements, float64 sums), so a
    stacked multi-gigabyte matrix needs scratch of one chunk only.  The
    reference takes float32 means, so the two agree to float32 rounding of
    the sums, not bit for bit.
    """
    rows, cols = w.shape
    step = max(1, _REL_MSE_CHUNK_ELEMS // max(cols, 1))
    chunks = [w[lo: lo + step].to(torch.float32)
              for lo in range(0, rows, step)]          # views for float32
    amax = torch.stack([torch.amax(torch.abs(c), dim=0) for c in chunks])
    scale = _scale_from_amax(amax.amax(dim=0, keepdim=True), bits)
    err = sq = 0.0
    for c in chunks:
        dq = _codes(c, scale, bits).to(torch.float32) * scale
        err += float(torch.sum(torch.square(c - dq), dtype=torch.float64))
        sq += float(torch.sum(torch.square(c), dtype=torch.float64))
    n = rows * cols
    return (err / n) / max(sq / n, 1e-30)


def price_site(design: str, bits: int, *, m: int, k: int, n_out: int,
               count: int, bit_sparsity: float, unit_n: int,
               num_units: int, cycle_scale: float = 1.0) -> dict[str, float]:
    """Price one site's per-decode-step cost on a (design, bits) DLA.

    Uses the same ``core.ppa.DLAModel`` tiling the serve cost table uses,
    with Eq. 1 ``bit_sparsity`` (block-max statistic) scaling the dynamic
    numbers and 0.0 for the worst case.  ``cycle_scale`` is the stochastic
    family's per-tile multiplier (``stream_len / 2^bits``, priced as
    uGEMM); 1.0 otherwise.  Returns µJ / µs totals over the site's
    ``count`` invocations: ``dyn_energy_uj``, ``dyn_latency_us``,
    ``wc_energy_uj``, ``wc_latency_us``.
    """
    dla = ppa.DLAModel(design=design, bits=bits, n=unit_n,
                       num_units=num_units, cycle_scale=cycle_scale)
    return {
        "dyn_energy_uj":
            dla.matmul_energy_nj(m, k, n_out, bit_sparsity) * count * 1e-3,
        "dyn_latency_us":
            dla.matmul_latency_ns(m, k, n_out, bit_sparsity) * count * 1e-3,
        "wc_energy_uj":
            dla.matmul_energy_nj(m, k, n_out, 0.0) * count * 1e-3,
        "wc_latency_us":
            dla.matmul_latency_ns(m, k, n_out, 0.0) * count * 1e-3,
    }


def prune_infeasible(site_name: str, k: int,
                     designs: Sequence[str],
                     bits_candidates: Sequence[int],
                     pruned: list | None) -> set[tuple[str, int]]:
    """(design, bits) pairs whose accumulator envelope ``k`` provably
    leaves (``repro_torch.analysis.ranges``) — the planner never prices,
    picks, or baselines them.  Evidence is appended to ``pruned`` (the
    plan's ``range_pruned`` meta block) when a list is given."""
    out: set[tuple[str, int]] = set()
    for design in designs:
        for bits in bits_candidates:
            finding = ranges_lib.check_gemm(design, bits, int(k),
                                            where=site_name)
            if finding is not None:
                out.add((design, bits))
                if pruned is not None:
                    pruned.append({
                        "site": site_name, "design": design, "bits": bits,
                        "k": int(k),
                        "max_safe_k": ranges_lib.max_safe_k(design, bits),
                        "reason": finding.message})
    return out


def _stochastic_candidates(site: GemmSite, weight: torch.Tensor, bits: int,
                           stream_lens: Sequence[int], *,
                           quant_rel_mse: float, stats: SparsityStats,
                           max_rel_mse: float, unit_n: int, num_units: int,
                           pruned: list | None) -> list[Candidate]:
    """Priced ``(ugemm_stochastic, bits, L)`` candidates for one site.

    Two static filters run before any measurement (excluded candidates are
    never priced, never picked, and their evidence lands in ``pruned``):

    1. the analytic expected-error bound
       (``ranges.stochastic_error_bound``) squared must fit the guard on
       its own — what ``plan-lint``'s ``stream-guard`` rule re-derives;
    2. the int32 pulse-count envelope at the site's K and this L.

    Surviving lengths get a *measured* seeded RMSE on the site's real
    quantized weight (``repro_torch.stochastic.error.site_rmse_curve``, on
    the weight's device); the guard then applies to quantization + stream
    error combined.  Priced as uGEMM with ``L / 2^bits`` cycle scaling.
    """
    from repro_torch.stochastic import error as stoch_error
    out: list[Candidate] = []
    admissible: list[int] = []
    for L in sorted({int(L) for L in stream_lens}):
        bound = ranges_lib.stochastic_error_bound(bits, L)
        if bound.expected_rel_mse > max_rel_mse:
            if pruned is not None:
                pruned.append({
                    "site": site.name, "design": STOCHASTIC_DESIGN,
                    "bits": bits, "stream_len": L, "k": int(site.k),
                    "reason": f"{bound.describe()} — expected rel MSE "
                              f"{bound.expected_rel_mse:.4f} > guard "
                              f"{max_rel_mse}"})
            continue
        finding = ranges_lib.check_gemm(STOCHASTIC_DESIGN, bits,
                                        int(site.k), where=site.name,
                                        stream_len=L)
        if finding is not None:
            if pruned is not None:
                pruned.append({
                    "site": site.name, "design": STOCHASTIC_DESIGN,
                    "bits": bits, "stream_len": L, "k": int(site.k),
                    "max_safe_k": ranges_lib.max_safe_k(
                        STOCHASTIC_DESIGN, bits, stream_len=L),
                    "reason": finding.message})
            continue
        admissible.append(L)
    if not admissible:
        return out
    curve = dict(stoch_error.site_rmse_curve(
        weight, bits, admissible, rows=max(site.m, 1)))
    for L in admissible:
        combined = quant_rel_mse + curve[L] ** 2
        priced = price_site("ugemm", bits, m=site.m, k=site.k,
                            n_out=site.n_out, count=site.count,
                            bit_sparsity=stats.bit_blockmax,
                            unit_n=unit_n, num_units=num_units,
                            cycle_scale=L / float(2 ** bits))
        out.append(Candidate(design=STOCHASTIC_DESIGN, bits=bits,
                             stats=stats, rel_mse=combined,
                             guard_ok=combined <= max_rel_mse,
                             stream_len=L, **priced))
    return out


def site_candidates(site: GemmSite, *,
                    bits_candidates: Sequence[int] = DEFAULT_BITS_CANDIDATES,
                    designs: Sequence[str] = DEFAULT_DESIGNS,
                    max_rel_mse: float = DEFAULT_MAX_REL_MSE,
                    unit_n: int = 64, num_units: int = 64,
                    block: int = 32,
                    pruned: list | None = None,
                    stream_lens: Sequence[int] = ()) -> list[Candidate]:
    """Profile and price every feasible (design, bits) candidate for one
    site.

    Candidates whose accumulator envelope the site's contraction length
    leaves are pruned *before* pricing (see :func:`prune_infeasible`;
    evidence lands in ``pruned`` when given).  The site's stacked weight
    matrix is profiled per the paper's convention (per-tensor quantization
    grid, ``block``×``block`` maxima for the Eq. 1 statistic); the guard
    statistic is :func:`quantization_rel_mse` at each bit-width.
    ``guard_ok`` is False where ``rel_mse > max_rel_mse``.  When
    ``designs`` contains ``ugemm_stochastic`` and ``stream_lens`` is
    non-empty, each bit-width also gets the rate-coded candidates of
    :func:`_stochastic_candidates`.
    """
    exact_designs = [d for d in designs if d != STOCHASTIC_DESIGN]
    want_stochastic = STOCHASTIC_DESIGN in designs and len(stream_lens) > 0
    infeasible = prune_infeasible(site.name, site.k, exact_designs,
                                  bits_candidates, pruned)
    weight = site.weight_matrix()
    out: list[Candidate] = []
    for bits in bits_candidates:
        stats = sparsity.profile_tensor(weight, bits=bits, block=block)
        rel_mse = quantization_rel_mse(weight, bits)
        guard_ok = rel_mse <= max_rel_mse
        for design in exact_designs:
            if (design, bits) in infeasible:
                continue
            priced = price_site(design, bits, m=site.m, k=site.k,
                                n_out=site.n_out, count=site.count,
                                bit_sparsity=stats.bit_blockmax,
                                unit_n=unit_n, num_units=num_units)
            out.append(Candidate(design=design, bits=bits, stats=stats,
                                 rel_mse=rel_mse, guard_ok=guard_ok,
                                 **priced))
        if want_stochastic:
            out.extend(_stochastic_candidates(
                site, weight, bits, stream_lens,
                quant_rel_mse=rel_mse, stats=stats,
                max_rel_mse=max_rel_mse, unit_n=unit_n,
                num_units=num_units, pruned=pruned))
    return out


def _pick(cands: list[Candidate], objective: str) -> tuple[Candidate, bool]:
    """Per-site argmin of ``objective`` among guard-passing candidates.

    Falls back to the most accurate (lowest rel_mse, then widest) candidates
    when the guard rejects every bit-width — the returned bool flags the
    relaxation.  Ties break deterministically by (value, design, bits).
    """
    allowed = [c for c in cands if c.guard_ok]
    relaxed = not allowed
    if relaxed:
        best_mse = min(c.rel_mse for c in cands)
        allowed = [c for c in cands if c.rel_mse == best_mse]
    return min(allowed, key=lambda c: (getattr(c, objective), c.design,
                                       c.bits, c.stream_len)), relaxed


def build_plan(cfg, params, *, batch: int = 1,
               bits_candidates: Sequence[int] = DEFAULT_BITS_CANDIDATES,
               designs: Sequence[str] = DEFAULT_DESIGNS,
               objective: str = "dyn_energy_uj",
               max_rel_mse: float = DEFAULT_MAX_REL_MSE,
               unit_n: int = 64, num_units: int = 64,
               seq_len: int = 8,
               sites: list[GemmSite] | None = None,
               stream_lens: Sequence[int] = ()) -> BackendPlan:
    """Derive a per-site mixed-precision :class:`BackendPlan` for a model.

    Args: ``cfg``/``params`` — the model; ``batch`` — decode rows per step
    (prices the tiling; does not change the per-site winner); ``objective``
    — one of ``dyn_energy_uj`` / ``dyn_latency_us`` / ``wc_energy_uj`` /
    ``wc_latency_us`` (lower is better); ``unit_n``/``num_units`` — the DLA
    geometry (n×n PE arrays); ``max_rel_mse`` — the accuracy guard;
    ``sites`` — optionally a pre-computed :func:`discover_sites` result
    (callers that also measure cycles reuse one discovery pass);
    ``stream_lens`` — rate-coded stream lengths tried per bit-width when
    ``designs`` contains ``ugemm_stochastic`` (e.g.
    :data:`DEFAULT_STREAM_LENS`).

    Returns a plan whose entries use exact site names as patterns, with
    ``meta`` carrying the planning inputs, per-(design, bits) uniform
    baselines, and the planned totals.  The planned total never exceeds the
    best guard-feasible uniform baseline (per-site argmin over a superset).
    Uniform baselines are exact designs only: stochastic candidates compete
    per site, where they must beat every exact candidate on the objective
    and survive the combined guard.  The statistics' scratch memory peaks
    at one row chunk of one site's weight; the stochastic error curves at
    the chunk budget of ``gemm_sims.signed_slot_counts``.
    """
    if sites is None:
        sites = discover_sites(cfg, params, batch=batch, seq_len=seq_len)
    if not sites:
        raise ValueError("model exposes no dense GEMM sites to plan")

    entries: list[SiteAssignment] = []
    range_pruned: list[dict] = []
    uniform = {(d, b): {**_zero_totals(), "feasible": True}
               for d in designs if d != STOCHASTIC_DESIGN
               for b in bits_candidates}
    for site in sites:
        n_pruned = len(range_pruned)
        cands = site_candidates(site, bits_candidates=bits_candidates,
                                designs=designs, max_rel_mse=max_rel_mse,
                                unit_n=unit_n, num_units=num_units,
                                pruned=range_pruned,
                                stream_lens=stream_lens)
        for rec in range_pruned[n_pruned:]:
            tot = uniform.get((rec["design"], rec["bits"]))
            if tot is not None:        # stochastic prunes have no baseline
                tot["feasible"] = False
        if not cands:
            raise ValueError(
                f"site {site.name!r}: no (design, bits) candidate among "
                f"{list(designs)} x {list(bits_candidates)} keeps a K="
                f"{site.k} contraction inside its accumulator envelope "
                f"(see repro_torch.analysis.ranges)")
        best, relaxed = _pick(cands, objective)
        entries.append(_assignment(site, best, relaxed, k=site.k,
                                   n_out=site.n_out))
        _fold_uniform(uniform, cands)

    meta = {
        "arch": getattr(cfg, "arch_id", None),
        "objective": objective,
        "bits_candidates": list(bits_candidates),
        "designs": list(designs),
        "stream_lens": sorted({int(L) for L in stream_lens}),
        "max_rel_mse": max_rel_mse,
        "unit_n": unit_n,
        "num_units": num_units,
        "batch": batch,
        # Numeric-safety evidence: every pruned (site, design, bits) with
        # its envelope bound.  Always present — an empty list is the
        # verifier's proof that no candidate was overflow-hazardous.
        "range_pruned": range_pruned,
        "totals": _uniform_verdict(uniform, plan_totals(entries), objective),
    }
    return BackendPlan(sites=tuple(entries),
                       meta=tuple(sorted(meta.items())))


def _zero_totals() -> dict[str, float]:
    return {"dyn_energy_uj": 0.0, "dyn_latency_us": 0.0,
            "wc_energy_uj": 0.0, "wc_latency_us": 0.0}


def _assignment(site: GemmSite, best: Candidate, relaxed: bool, *,
                k: int, n_out: int) -> SiteAssignment:
    """A plan entry for ``site`` from a picked candidate (``k``/``n_out``
    record the priced contraction)."""
    return SiteAssignment(
        pattern=site.name, design=best.design, bits=best.bits,
        m=site.m, k=int(k), n_out=int(n_out), count=site.count,
        word=best.stats.word, bit_elem=best.stats.bit_elem,
        bit_blockmax=best.stats.bit_blockmax,
        dyn_energy_uj=best.dyn_energy_uj,
        dyn_latency_us=best.dyn_latency_us,
        wc_energy_uj=best.wc_energy_uj,
        wc_latency_us=best.wc_latency_us,
        rel_mse=best.rel_mse, guard_relaxed=relaxed,
        stream_len=best.stream_len)


def _fold_uniform(uniform: dict, cands: list[Candidate]) -> None:
    """Accumulate every candidate into the per-(design, bits) uniform
    baselines (a uniform assignment is infeasible once any site's guard
    rejects that bit-width); stochastic candidates compete per site only."""
    for c in cands:
        tot = uniform.get((c.design, c.bits))
        if tot is None:
            continue
        if not c.guard_ok:
            tot["feasible"] = False
        for key in _zero_totals():
            tot[key] += getattr(c, key)


def _uniform_verdict(uniform: dict, planned: dict,
                     objective: str) -> dict:
    """The planned-vs-uniform totals block."""
    feasible = {f"{d}@{b}": {k: v for k, v in tot.items() if k != "feasible"}
                for (d, b), tot in uniform.items() if tot["feasible"]}
    best = (min(feasible, key=lambda name: feasible[name][objective])
            if feasible else None)
    return {"planned": planned, "uniform": feasible, "uniform_best": best}


def build_grid_plan(cfg, params, *, grid=(2, 2), batch: int = 1,
                    bits_candidates: Sequence[int] = DEFAULT_BITS_CANDIDATES,
                    designs: Sequence[str] = DEFAULT_DESIGNS,
                    objective: str = "dyn_energy_uj",
                    max_rel_mse: float = DEFAULT_MAX_REL_MSE,
                    unit_n: int = 64, num_units: int = 64,
                    seq_len: int = 8,
                    sites: list[GemmSite] | None = None):
    """Derive a per-shard heterogeneous :class:`repro_torch.backends.GridPlan`.

    Shards every site's weight the way ``GridBackend.execute`` does (K rows
    ceil-split over ``units_x``, output columns over ``units_y``), profiles
    **each shard's slice separately** — a shard's weight slice has its own
    sparsity, so the Eq. 1-priced winner may differ across shards — and
    prices every (shard, design, bits) candidate on the per-node DLA tiling
    (padded shard dims) plus that shard's share of the interconnect-hop
    energy and the full hop latency.

    The accuracy guard uses the **full-weight** quantization error at each
    bit-width: execution quantizes the whole weight per output channel
    before sharding the codes, so the shard slices see the full tensor's
    quantization grid — and per-shard, aggregate and uniform candidate sets
    then share one feasibility structure, keeping the planned-total ≤
    best-uniform property airtight at every level.

    Every statistic runs on the weight's device; a shard's slice is a view
    of the stacked site weight, walked one row chunk at a time, so the
    scratch memory stays at one chunk.

    Returns a :class:`~repro_torch.backends.GridPlan`: one
    :class:`BackendPlan` per shard (its meta carries that shard's
    planned-vs-uniform verdict), the *aggregate* plan execution replays
    (per-site argmin of the summed per-shard cost), and a meta block with
    the per-shard and aggregate verdicts plus the sites whose assignment is
    heterogeneous across shards.
    """
    grid = grid_lib.parse_grid(grid)
    units_x, units_y = grid
    num_shards = units_x * units_y
    if sites is None:
        sites = discover_sites(cfg, params, batch=batch, seq_len=seq_len)
    if not sites:
        raise ValueError("model exposes no dense GEMM sites to plan")

    shard_keys = [f"{gx},{gy}" for gx in range(units_x)
                  for gy in range(units_y)]
    shard_entries: dict[str, list[SiteAssignment]] = \
        {k: [] for k in shard_keys}
    shard_uniform = {k: {(d, b): {**_zero_totals(), "feasible": True}
                         for d in designs for b in bits_candidates}
                     for k in shard_keys}
    agg_entries: list[SiteAssignment] = []
    agg_uniform = {(d, b): {**_zero_totals(), "feasible": True}
                   for d in designs for b in bits_candidates}
    range_pruned: list[dict] = []

    for site in sites:
        full = site.weight_matrix()            # a view: one site at a time
        w3, _applications = _site_copies(site, full)
        full_mse = {b: quantization_rel_mse(full, b) for b in bits_candidates}
        full_stats = {b: sparsity.profile_tensor(full, bits=b)
                      for b in bits_candidates}
        ks_pad = -(-site.k // units_x)
        ns_pad = -(-site.n_out // units_y)
        # Envelope pruning at the *padded shard* contraction length — what
        # each grid node actually accumulates over.  Infeasible pairs are
        # never priced for any shard, the aggregate, or a uniform baseline.
        infeasible = prune_infeasible(site.name, ks_pad, designs,
                                      bits_candidates, range_pruned)
        for pair in infeasible:
            agg_uniform[pair]["feasible"] = False
            for skey in shard_keys:
                shard_uniform[skey][pair]["feasible"] = False
        if len(infeasible) == len(designs) * len(bits_candidates):
            raise ValueError(
                f"site {site.name!r}: no (design, bits) candidate among "
                f"{list(designs)} x {list(bits_candidates)} keeps the "
                f"per-shard K={ks_pad} contraction (grid {units_x}x"
                f"{units_y}) inside its accumulator envelope "
                f"(see repro_torch.analysis.ranges)")
        agg_costs: dict[tuple[str, int], dict[str, float]] = {}

        def _fold_agg(priced: dict[str, float], design: str,
                      bits: int) -> None:
            # energy sums across shards; shards run in parallel, so the
            # grid's latency is the slowest shard's (matching GridDLAModel)
            agg = agg_costs.setdefault((design, bits), _zero_totals())
            for key in ("dyn_energy_uj", "wc_energy_uj"):
                agg[key] += priced[key]
            for key in ("dyn_latency_us", "wc_latency_us"):
                agg[key] = max(agg[key], priced[key])

        for (gx, gy), (rows_sl, cols_sl) in grid_lib.shard_slices(
                site.k, site.n_out, units_x, units_y).items():
            sub = w3[:, rows_sl, cols_sl]      # a strided view, never copied
            # A pure-padding shard (units_x ∤ k) has nothing to plan, but
            # the priced grid still streams its zero codes and the reduction
            # still crosses it: charge its padded compute (all-zero codes →
            # block-max sparsity 1.0) and hop share into the aggregate,
            # keeping planner totals consistent with the grid pricer.
            padding_only = sub.numel() == 0
            if padding_only:
                shard_stats = {b: sparsity.SparsityStats(
                    bits=b, word=1.0, bit_elem=1.0, bit_blockmax=1.0,
                    numel=0) for b in bits_candidates}
            else:
                shard_stats = {b: sparsity.profile_tensor(sub, bits=b)
                               for b in bits_candidates}
            cands: list[Candidate] = []
            for bits in bits_candidates:
                stats = shard_stats[bits]
                guard_ok = full_mse[bits] <= max_rel_mse
                for design in designs:
                    if (design, bits) in infeasible:
                        continue
                    node = ppa.DLAModel(design=design, bits=bits, n=unit_n,
                                        num_units=num_units)
                    gdla = ppa.GridDLAModel(
                        design=design, bits=bits, n=unit_n,
                        num_units=num_units, units_x=units_x,
                        units_y=units_y)
                    hop_e = gdla.hop_energy_nj(site.m, site.k, site.n_out) \
                        / num_shards * site.count * 1e-3
                    hop_l = gdla.hop_latency_ns() * site.count * 1e-3
                    priced = {
                        "dyn_energy_uj": node.matmul_energy_nj(
                            site.m, ks_pad, ns_pad, stats.bit_blockmax)
                        * site.count * 1e-3 + hop_e,
                        "dyn_latency_us": node.matmul_latency_ns(
                            site.m, ks_pad, ns_pad, stats.bit_blockmax)
                        * site.count * 1e-3 + hop_l,
                        "wc_energy_uj": node.matmul_energy_nj(
                            site.m, ks_pad, ns_pad, 0.0)
                        * site.count * 1e-3 + hop_e,
                        "wc_latency_us": node.matmul_latency_ns(
                            site.m, ks_pad, ns_pad, 0.0)
                        * site.count * 1e-3 + hop_l,
                    }
                    _fold_agg(priced, design, bits)
                    if not padding_only:
                        cands.append(Candidate(design=design, bits=bits,
                                               stats=stats,
                                               rel_mse=full_mse[bits],
                                               guard_ok=guard_ok, **priced))
            if padding_only:
                continue
            best, relaxed = _pick(cands, objective)
            key = f"{gx},{gy}"
            shard_entries[key].append(_assignment(
                site, best, relaxed, k=sub.shape[1], n_out=sub.shape[2]))
            _fold_uniform(shard_uniform[key], cands)
        agg_cands = [
            Candidate(design=d, bits=b, stats=full_stats[b],
                      rel_mse=full_mse[b],
                      guard_ok=full_mse[b] <= max_rel_mse, **vals)
            for (d, b), vals in sorted(agg_costs.items())]
        best, relaxed = _pick(agg_cands, objective)
        agg_entries.append(_assignment(site, best, relaxed,
                                       k=site.k, n_out=site.n_out))
        _fold_uniform(agg_uniform, agg_cands)

    common = {
        "arch": getattr(cfg, "arch_id", None),
        "grid": list(grid),
        "objective": objective,
        "bits_candidates": list(bits_candidates),
        "designs": list(designs),
        "max_rel_mse": max_rel_mse,
        "unit_n": unit_n,
        "num_units": num_units,
        "batch": batch,
        # Always present — an empty list is the verifier's proof that every
        # candidate stayed inside its accumulator envelope at shard-local K.
        "range_pruned": range_pruned,
    }
    shards = []
    per_shard_verdicts = {}
    hetero_planned = _zero_totals()
    for key in shard_keys:
        entries = shard_entries[key]
        if not entries:
            continue
        verdict = _uniform_verdict(shard_uniform[key], plan_totals(entries),
                                   objective)
        per_shard_verdicts[key] = verdict
        for tkey in ("dyn_energy_uj", "wc_energy_uj"):
            hetero_planned[tkey] += verdict["planned"][tkey]
        for tkey in ("dyn_latency_us", "wc_latency_us"):
            # shards run in parallel: heterogeneous latency = slowest shard
            hetero_planned[tkey] = max(hetero_planned[tkey],
                                       verdict["planned"][tkey])
        shards.append((key, BackendPlan(
            sites=tuple(entries),
            meta=tuple(sorted({**common, "shard": key,
                               "totals": verdict}.items())))))
    agg_verdict = _uniform_verdict(agg_uniform, plan_totals(agg_entries),
                                   objective)
    aggregate = BackendPlan(
        sites=tuple(agg_entries),
        meta=tuple(sorted({**common, "shard": None,
                           "totals": agg_verdict}.items())))
    gplan = grid_lib.GridPlan(units_x=units_x, units_y=units_y,
                              aggregate=aggregate, shards=tuple(shards))
    meta = {
        **common,
        "totals": {
            "aggregate": {**agg_verdict,
                          "planned_heterogeneous": hetero_planned},
            "per_shard": per_shard_verdicts,
        },
        "heterogeneous_sites": list(gplan.heterogeneous_sites()),
    }
    return dataclasses.replace(gplan, meta=tuple(sorted(meta.items())))


def grid_plan_to_markdown(gplan) -> str:
    """Human-readable rendering of a grid plan."""
    meta = gplan.metadata()
    totals = meta.get("totals", {})
    agg = totals.get("aggregate", {})
    lines = [
        "# Per-shard mixed-precision grid plan",
        "",
        f"Arch: `{meta.get('arch')}` on a {gplan.units_x}×{gplan.units_y} "
        f"PE-array grid of {meta.get('num_units')}× {meta.get('unit_n')}×"
        f"{meta.get('unit_n')} DLA nodes — objective "
        f"`{meta.get('objective')}`, decode batch {meta.get('batch')}.",
        "",
        "## Aggregate (executed) assignment",
        "",
        "| site | backend | b_spa | dyn energy (µJ) | guard |",
        "|---|---|---|---|---|",
    ]
    for e in gplan.aggregate.sites:
        guard = "relaxed" if e.guard_relaxed else "ok"
        lines.append(f"| `{e.pattern}` ×{e.count} | {e.design}@{e.bits} | "
                     f"{e.bit_blockmax:.3f} | {e.dyn_energy_uj:.4f} | "
                     f"{guard} |")
    planned = agg.get("planned", {})
    hetero = agg.get("planned_heterogeneous", {})
    lines += [
        "",
        f"**Aggregate planned**: {planned.get('dyn_energy_uj', 0.0):.4f} µJ "
        f"dyn energy / decode step; per-shard heterogeneous planned: "
        f"{hetero.get('dyn_energy_uj', 0.0):.4f} µJ.",
        "",
        "## Uniform grid baselines (guard-feasible)",
        "",
        "| uniform backend | dyn energy (µJ) | dyn latency (µs) |",
        "|---|---|---|",
    ]
    uniform = agg.get("uniform", {})
    for name in sorted(uniform):
        tot = uniform[name]
        mark = " ← best" if name == agg.get("uniform_best") else ""
        lines.append(f"| {name}{mark} | {tot['dyn_energy_uj']:.4f} | "
                     f"{tot['dyn_latency_us']:.4f} |")
    lines += [
        "",
        "## Per-shard verdicts",
        "",
        "| shard | planned dyn energy (µJ) | best uniform | assignment |",
        "|---|---|---|---|",
    ]
    for key, plan in gplan.shards:
        verdict = totals.get("per_shard", {}).get(key, {})
        p = verdict.get("planned", {}).get("dyn_energy_uj", 0.0)
        best = verdict.get("uniform_best")
        tags = ", ".join(f"{s.design}@{s.bits}" for s in plan.sites)
        lines.append(f"| {key} | {p:.4f} | {best} | {tags} |")
    hsites = meta.get("heterogeneous_sites", [])
    lines += [
        "",
        f"Sites with shard-heterogeneous assignments: "
        f"{', '.join(f'`{s}`' for s in hsites) if hsites else 'none'}.",
        "",
        "Per-site, per-shard argmin over the same candidate set makes every "
        "shard's planned total ≤ its best uniform baseline and the "
        "aggregate ≤ the best uniform grid assignment, by construction; "
        "`use_plan` executes the aggregate shard by shard "
        "(`serve --backend-plan … --grid X,Y` replays it with bit-exactness "
        "and per-shard cycle-bound checks).",
        "",
    ]
    return "\n".join(lines)


def _site_copies(site: GemmSite, weight: torch.Tensor
                 ) -> tuple[torch.Tensor, int]:
    """The site's physical weight copies and the application multiplier.

    Returns ``(copies-stacked (copies, k, n_out) view, applications)``; a
    site's ``count`` exceeds its physical copies only where one weight is
    applied several times a step.
    """
    copies = weight.shape[0] // site.k
    return (weight.reshape(copies, site.k, site.n_out),
            site.count // copies)


def measure_site_cycles(site: GemmSite, entry, *, unit_n: int,
                        num_units: int) -> dict[str, float]:
    """Measured (operand-driven) decode-step cycles for one planned site.

    Runs the shared measured-cycles contract
    (``repro_torch.backends.runtime.measure_matrix_cycles`` — the same
    helper the serve driver totals with) over each of the site's physical
    weight copies with the entry's profiled Eq. 1 statistics, and sums.
    Returns cycles per decode step: ``measured`` (operand-driven early
    termination), ``dyn`` (Eq. 1 block-max), ``dyn_floor`` (Eq. 1
    element-level), ``wc`` (worst case).  For sparsity-aware designs
    ``dyn_floor ≤ measured ≤ wc``; designs without early termination report
    all four equal.
    """
    backend = entry.backend()
    w3, applications = _site_copies(site, site.weight_matrix())
    totals = {"measured": 0.0, "dyn": 0.0, "dyn_floor": 0.0, "wc": 0.0}
    for w in w3:
        cyc = runtime_lib.measure_matrix_cycles(
            backend, w, rows=site.m, unit_n=unit_n, num_units=num_units,
            bit_blockmax=entry.bit_blockmax, bit_elem=entry.bit_elem)
        for key in totals:
            totals[key] += cyc[key]
    return {key: val * applications for key, val in totals.items()}


def measure_grid_site_cycles(site: GemmSite, entry, *, grid: tuple[int, int],
                             unit_n: int, num_units: int
                             ) -> dict[str, dict[str, float]]:
    """Per-shard measured decode-step cycles for one planned site on a grid.

    Like :func:`measure_site_cycles` but sharded: each grid node measures
    its own weight slice (``repro_torch.backends.grid_matrix_cycles`` —
    per-shard tile counts, per-shard sparsity, hop term added to every
    bound), on the weight's device, summed over the site's physical copies
    and scaled by applications.  Returns ``{"gx,gy": {measured, dyn,
    dyn_floor, wc}}``; the per-shard invariant ``dyn_floor ≤ measured ≤
    wc`` holds shard by shard.
    """
    backend = grid_lib.as_grid(entry.backend(), *grid)
    w3, applications = _site_copies(site, site.weight_matrix())
    totals: dict[str, dict[str, float]] = {}
    for w in w3:
        per_shard = grid_lib.grid_matrix_cycles(
            backend, w, rows=site.m, unit_n=unit_n, num_units=num_units)
        for coord, cyc in per_shard.items():
            tot = totals.setdefault(
                coord, {"measured": 0.0, "dyn": 0.0, "dyn_floor": 0.0,
                        "wc": 0.0})
            for key in tot:
                tot[key] += cyc[key]
    return {coord: {key: val * applications for key, val in tot.items()}
            for coord, tot in totals.items()}


def plan_totals(entries) -> dict[str, float]:
    """Summed predicted cost of a plan's entries (µJ / µs per decode step)."""
    keys = ("dyn_energy_uj", "dyn_latency_us", "wc_energy_uj",
            "wc_latency_us")
    return {k: sum(getattr(e, k) for e in entries) for k in keys}


def to_markdown(plan: BackendPlan) -> str:
    """Human-readable rendering of a plan."""
    meta = plan.metadata()
    totals = meta.get("totals", {})
    planned = totals.get("planned", {})
    lines = [
        "# Per-layer mixed-precision backend plan",
        "",
        f"Arch: `{meta.get('arch')}` — objective `{meta.get('objective')}` "
        f"on a {meta.get('num_units')}× {meta.get('unit_n')}×"
        f"{meta.get('unit_n')} DLA, decode batch {meta.get('batch')}.",
        f"Candidates: designs {meta.get('designs')} × bits "
        f"{meta.get('bits_candidates')}; accuracy guard rel. quant MSE ≤ "
        f"{meta.get('max_rel_mse')}.",
        "",
        "| site | backend | bits | b_spa (blockmax) | dyn energy (µJ) | "
        "dyn latency (µs) | rel MSE | guard |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for e in plan.sites:
        guard = "relaxed" if e.guard_relaxed else "ok"
        design = (f"{e.design}:{e.stream_len}" if e.stream_len
                  else e.design)
        lines.append(
            f"| `{e.pattern}` ×{e.count} | {design} | {e.bits} | "
            f"{e.bit_blockmax:.3f} | {e.dyn_energy_uj:.4f} | "
            f"{e.dyn_latency_us:.4f} | {e.rel_mse:.4f} | {guard} |")
    lines += [
        "",
        f"**Planned totals**: {planned.get('dyn_energy_uj', 0.0):.4f} µJ "
        f"dyn energy, {planned.get('dyn_latency_us', 0.0):.4f} µs dyn "
        "latency per decode step.",
        "",
        "## Uniform single-backend baselines (guard-feasible)",
        "",
        "| uniform backend | dyn energy (µJ) | dyn latency (µs) | "
        "wc energy (µJ) |",
        "|---|---|---|---|",
    ]
    uniform = totals.get("uniform", {})
    for name in sorted(uniform):
        tot = uniform[name]
        mark = " ← best" if name == totals.get("uniform_best") else ""
        lines.append(f"| {name}{mark} | {tot['dyn_energy_uj']:.4f} | "
                     f"{tot['dyn_latency_us']:.4f} | "
                     f"{tot['wc_energy_uj']:.4f} |")
    distinct = ", ".join(f"{d}@{b}" + (f":{sl}" if sl else "")
                         for d, b, sl in plan.distinct_engines())
    lines += [
        "",
        f"Distinct backends chosen: {distinct}.",
        "",
        "Per-site argmin over the same candidate set makes the planned "
        "total ≤ every guard-feasible uniform baseline by construction; "
        "`repro_torch.backends.use_plan` executes this mapping and "
        "`serve --backend-plan` replays it with bit-exactness checks.",
        "",
    ]
    return "\n".join(lines)
