"""Static lint for ``BackendPlan`` / ``GridPlan`` documents.

A plan is a claim: "these (pattern -> design@bits) assignments are what the
model should execute".  This pass checks the claim without running
anything:

* ``unknown-design`` / ``invalid-bits`` — the assignment names a design
  outside the registry (+ kernel mirrors) or a bit-width the int8 code
  container cannot hold;
* ``shadowed-pattern`` / ``dead-pattern`` — fnmatch resolution semantics
  (exact > most-literal glob > earliest) make the entry unreachable, either
  intrinsically (a duplicate pattern) or against a concrete site inventory
  (the entry matches sites but wins none of them / matches nothing);
* ``unmatched-site`` — a site in the inventory no entry covers (it runs on
  the float path by contract; usually intentional, hence a warning);
* ``guard-relaxed`` — the planner shipped an assignment whose quantization
  error exceeded the accuracy guard (every bit-width failed);
* ``acc-overflow`` — the assignment's recorded contraction geometry leaves
  the design's accumulator envelope (:mod:`repro_torch.analysis.ranges`);
  for grid plans, per-shard entries check their shard-local K and aggregate
  entries check the geometry's ceil K split;
* ``invalid-stream`` / ``stream-guard`` — stream-length hygiene for the
  rate-coded ``ugemm_stochastic`` family: a stochastic entry must carry
  ``stream_len >= 1`` (and no count-exact design may carry one), and its
  analytic expected-error bound
  (:func:`repro_torch.analysis.ranges.stochastic_error_bound`) squared must stay
  within the plan's recorded ``max_rel_mse`` accuracy guard — the same
  pre-filter the planner applies, re-derived statically from the document;
* ``packed-width-mismatch`` — when the caller supplies the widths of a
  bit-packed weight store (``packed_bits``, site name -> stored bits, e.g.
  from :func:`repro_torch.core.packing.packed_widths`), every packed site must
  resolve to an entry assigning exactly that width: executing a 4-bit plan
  against an 8-bit store either re-rounds frozen codes or raises at trace
  time (``models/common``'s runtime guard) — the plan and the store were
  built from different planning runs.

Site inventories come from the plan's own evidence by default (entries
record ``k``/``n_out``), or from a model trace when the caller has one.

Known designs are the port's: ``core.gemm_sims`` designs, the ``*_cuda``
kernel mirrors and ``ugemm_stochastic``.  A plan naming a ``*_pallas`` mirror
of the JAX package gets ``unknown-design``: no kernel of that name exists
here, its ``*_cuda`` name is the counterpart.
"""

from __future__ import annotations

import fnmatch
import pathlib
from typing import Mapping, Sequence

from repro_torch.analysis import ranges
from repro_torch.analysis.findings import ERROR, WARNING, Finding
from repro_torch.backends.grid import GridPlan, load_plan
from repro_torch.backends.plan import BackendPlan, SiteAssignment, _specificity
from repro_torch.backends.registry import KERNEL_SIBLINGS
from repro_torch.core import gemm_sims

#: Bit-widths the quantized int8 code container supports (vmax needs >= 2,
#: vmax(8) = 127 is the container ceiling).
VALID_BITS = range(2, 9)
STOCHASTIC_DESIGN = ranges.STOCHASTIC_FAMILY


def _known_designs() -> set[str]:
    return (set(gemm_sims.DESIGNS) | set(KERNEL_SIBLINGS)
            | {STOCHASTIC_DESIGN})


def _stream_findings(entry: SiteAssignment, *, where: str,
                     max_rel_mse: float | None) -> list[Finding]:
    """``invalid-stream`` / ``stream-guard`` rules for one entry."""
    out: list[Finding] = []
    is_stochastic = ranges.design_family(entry.design) == STOCHASTIC_DESIGN
    if not is_stochastic:
        if entry.stream_len:
            out.append(Finding(
                pass_name="plan-lint", rule="invalid-stream", severity=ERROR,
                where=where,
                message=f"stream_len={entry.stream_len} on count-exact "
                        f"design {entry.design!r} — stream length is a "
                        f"{STOCHASTIC_DESIGN!r} knob"))
        return out
    if entry.stream_len < 1:
        out.append(Finding(
            pass_name="plan-lint", rule="invalid-stream", severity=ERROR,
            where=where,
            message=f"stochastic entry needs stream_len >= 1, got "
                    f"{entry.stream_len}"))
        return out
    if max_rel_mse is not None and not entry.guard_relaxed \
            and entry.bits in VALID_BITS:
        bound = ranges.stochastic_error_bound(entry.bits, entry.stream_len)
        if bound.expected_rel_mse > float(max_rel_mse):
            out.append(Finding(
                pass_name="plan-lint", rule="stream-guard", severity=ERROR,
                where=where,
                message=f"{bound.describe()} — expected stream error "
                        f"(rel MSE {bound.expected_rel_mse:.4f}) alone "
                        f"violates the plan's accuracy guard "
                        f"max_rel_mse={float(max_rel_mse)}; lengthen the "
                        f"stream or drop the entry"))
    return out


def _entry_findings(entry: SiteAssignment, *, where: str,
                    k_override: int | None = None,
                    max_rel_mse: float | None = None) -> list[Finding]:
    out: list[Finding] = []
    if entry.design not in _known_designs():
        out.append(Finding(
            pass_name="plan-lint", rule="unknown-design", severity=ERROR,
            where=where,
            message=f"design {entry.design!r} is not a registered design "
                    f"or kernel mirror ({sorted(_known_designs())})"))
    if entry.bits not in VALID_BITS:
        out.append(Finding(
            pass_name="plan-lint", rule="invalid-bits", severity=ERROR,
            where=where,
            message=f"bits={entry.bits} outside the int8 code container "
                    f"range [{VALID_BITS.start}, {VALID_BITS.stop - 1}]"))
    if entry.guard_relaxed:
        out.append(Finding(
            pass_name="plan-lint", rule="guard-relaxed", severity=WARNING,
            where=where,
            message=f"assignment shipped with the accuracy guard relaxed "
                    f"(rel_mse={entry.rel_mse:.4f}); quantization error "
                    f"exceeded the planning threshold at every bit-width"))
    out.extend(_stream_findings(entry, where=where, max_rel_mse=max_rel_mse))
    k = entry.k if k_override is None else k_override
    if k and entry.design in _known_designs() \
            and entry.bits in VALID_BITS:
        f = ranges.check_gemm(entry.design, entry.bits, int(k), where=where,
                              stream_len=entry.stream_len or None)
        if f is not None:
            out.append(f)
    return out


def _pattern_findings(plan: BackendPlan, *,
                      site_names: Sequence[str] | None,
                      where_prefix: str) -> list[Finding]:
    out: list[Finding] = []
    # Intrinsic shadowing: resolution is (specificity, earliest), so a
    # later entry with a pattern another entry already states can never
    # win any site the earlier one matches.
    seen: dict[str, int] = {}
    for i, entry in enumerate(plan.sites):
        if entry.pattern in seen:
            out.append(Finding(
                pass_name="plan-lint", rule="shadowed-pattern",
                severity=ERROR,
                where=f"{where_prefix}sites[{i}] {entry.pattern!r}",
                message=f"duplicate of sites[{seen[entry.pattern]}] — "
                        f"resolution always prefers the earlier entry, so "
                        f"this assignment ({entry.design}@{entry.bits}b) "
                        f"is unreachable"))
        else:
            seen[entry.pattern] = i
    if site_names is None:
        return out
    # Inventory-backed reachability: which entry wins each site?
    wins: dict[int, list[str]] = {i: [] for i in range(len(plan.sites))}
    matched: dict[str, bool] = {}
    for name in site_names:
        best, best_key = None, None
        for i, entry in enumerate(plan.sites):
            if not fnmatch.fnmatch(name, entry.pattern):
                continue
            key = (*_specificity(entry.pattern), -i)
            if best_key is None or key > best_key:
                best, best_key = i, key
        matched[name] = best is not None
        if best is not None:
            wins[best].append(name)
    for i, entry in enumerate(plan.sites):
        if entry.pattern in seen and seen[entry.pattern] != i:
            continue  # already reported as a duplicate
        matches = [n for n in site_names
                   if fnmatch.fnmatch(n, entry.pattern)]
        if not matches:
            out.append(Finding(
                pass_name="plan-lint", rule="dead-pattern", severity=ERROR,
                where=f"{where_prefix}sites[{i}] {entry.pattern!r}",
                message="pattern matches no site in the model — stale "
                        "entry or typo"))
        elif not wins[i]:
            losers = ", ".join(matches[:3])
            out.append(Finding(
                pass_name="plan-lint", rule="shadowed-pattern",
                severity=ERROR,
                where=f"{where_prefix}sites[{i}] {entry.pattern!r}",
                message=f"every matching site (e.g. {losers}) resolves to "
                        f"a more specific or earlier entry — this "
                        f"assignment is unreachable"))
    for name in site_names:
        if not matched[name]:
            out.append(Finding(
                pass_name="plan-lint", rule="unmatched-site",
                severity=WARNING, where=f"{where_prefix}{name}",
                message="no plan entry matches this site — it runs on the "
                        "float path"))
    return out


def _packed_findings(plan: BackendPlan, *,
                     packed_bits: Mapping[str, int] | None,
                     where_prefix: str) -> list[Finding]:
    """``packed-width-mismatch``: the store's frozen widths vs the plan's."""
    out: list[Finding] = []
    if not packed_bits:
        return out
    for name in sorted(packed_bits):
        entry = plan.assignment_for(name)
        if entry is None:
            continue  # unmatched sites run float (dequantized) — no conflict
        if int(entry.bits) != int(packed_bits[name]):
            out.append(Finding(
                pass_name="plan-lint", rule="packed-width-mismatch",
                severity=ERROR, where=f"{where_prefix}{name}",
                message=f"plan assigns {entry.design}@{entry.bits}b but the "
                        f"packed store holds {int(packed_bits[name])}-bit "
                        f"codes — repack from the float parameters with "
                        f"backends.pack_weights(cfg, params, plan)"))
    return out


def lint_backend_plan(plan: BackendPlan, *,
                      site_names: Sequence[str] | None = None,
                      where_prefix: str = "",
                      k_override: int | None = None,
                      packed_bits: Mapping[str, int] | None = None
                      ) -> list[Finding]:
    """All findings for one flat :class:`BackendPlan`."""
    out: list[Finding] = []
    max_rel_mse = plan.metadata().get("max_rel_mse")
    for i, entry in enumerate(plan.sites):
        where = (f"{where_prefix}sites[{i}] {entry.pattern!r} "
                 f"-> {entry.design}@{entry.bits}b")
        out.extend(_entry_findings(entry, where=where,
                                   k_override=k_override,
                                   max_rel_mse=max_rel_mse))
    out.extend(_pattern_findings(plan, site_names=site_names,
                                 where_prefix=where_prefix))
    out.extend(_packed_findings(plan, packed_bits=packed_bits,
                                where_prefix=where_prefix))
    return out


def lint_grid_plan(plan: GridPlan, *,
                   site_names: Sequence[str] | None = None,
                   packed_bits: Mapping[str, int] | None = None
                   ) -> list[Finding]:
    """Findings for a :class:`GridPlan`: per-shard plans check shard-local
    contraction lengths (their entries record the slice dims); the
    aggregate plan is checked at the geometry's ceil K split, which is what
    replay through ``GridBackend`` actually contracts per shard."""
    out: list[Finding] = []
    for key, shard_plan in plan.shards:
        out.extend(lint_backend_plan(shard_plan, site_names=None,
                                     where_prefix=f"shard {key}/"))
    agg = plan.aggregate
    max_rel_mse = agg.metadata().get("max_rel_mse")
    for i, entry in enumerate(agg.sites):
        where = (f"aggregate sites[{i}] {entry.pattern!r} "
                 f"-> {entry.design}@{entry.bits}b "
                 f"[grid {plan.units_x}x{plan.units_y}]")
        k_shard = -(-int(entry.k) // plan.units_x) if entry.k else 0
        out.extend(_entry_findings(entry, where=where, k_override=k_shard,
                                   max_rel_mse=max_rel_mse))
    out.extend(_pattern_findings(agg, site_names=site_names,
                                 where_prefix="aggregate "))
    out.extend(_packed_findings(agg, packed_bits=packed_bits,
                                where_prefix="aggregate "))
    return out


def lint_plan(plan, *, site_names: Sequence[str] | None = None,
              packed_bits: Mapping[str, int] | None = None) -> list[Finding]:
    """Dispatch on plan flavour."""
    if isinstance(plan, GridPlan):
        return lint_grid_plan(plan, site_names=site_names,
                              packed_bits=packed_bits)
    if isinstance(plan, BackendPlan):
        return lint_backend_plan(plan, site_names=site_names,
                                 packed_bits=packed_bits)
    raise TypeError(f"expected BackendPlan or GridPlan, got {type(plan)!r}")


def lint_plan_file(path, *, site_names: Sequence[str] | None = None
                   ) -> list[Finding]:
    """Load (schema-sniffing) and lint one plan JSON document."""
    path = pathlib.Path(path)
    try:
        plan = load_plan(path)
    except Exception as e:  # malformed JSON/schema is itself a finding
        return [Finding(pass_name="plan-lint", rule="unloadable-plan",
                        severity=ERROR, where=str(path),
                        message=f"{type(e).__name__}: {e}")]
    prefix = f"{path.name}: "
    return [Finding(f.pass_name, f.rule, f.severity,
                    f"{prefix}{f.where}", f.message)
            for f in lint_plan(plan, site_names=site_names)]
