"""Zero-FLOP GEMM discovery and model-graph cross-check for the range verifier.

Where the reference reads a jaxpr, this module reads the ATen operations
that one forward pass on the ``meta`` device dispatches, seen through a
``TorchDispatchMode``: every ``mm`` / ``bmm`` / ``addmm`` / ``baddbmm`` /
``_int_mm`` becomes a :class:`DotSite`.  Two independent views of a
model's GEMM population are reconciled here:

* the **planner's view** — ``repro_torch.backends.record_sites()`` over
  the same forward (what ``models/common.dense`` would contract on a
  backend), joined to the parameter tree by
  ``repro_torch.eval.planner.sites_from_calls``;
* the **graph's view** — every matrix product the forward dispatches.
  ``torch.matmul`` and ``torch.einsum`` reach dispatch as views and
  permutes around an ``mm`` or ``bmm``, so the products are read after
  PyTorch's own decomposition.

Parameter provenance is carried through view and copy operations (the
layer ``select`` / ``unbind`` of a stacked leaf, ``t``, ``transpose``,
``permute``, ``view``, ``reshape``, ``expand``, ``slice``, ``squeeze``,
``unsqueeze``, ``clone``, ``_to_copy``, ...), keyed by tensor object: on
``meta`` there is no storage, so no ``data_ptr`` to key by.  A product
whose operand traces back to a weight leaf is attributed to its parameter
path and normalised with the weight as the right-hand operand, so
``n_out`` is the weight's free size wherever the decomposition put it,
as the reference's ``(k, n_out)`` reads it.

The eager forward dispatches every layer (and for MoE every expert) where
the reference's jaxpr holds the scanned body once, so
``stats["dot_generals"]`` is the port's own count of dispatched products
and is not held equal to the reference's; the findings, ``sites`` and
``points_checked`` are.  Parameters are ``meta`` tensors built from
``model_defs`` (no generator exists on ``meta``), so the full published
configs scan without materialising a weight.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Sequence

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.analysis import ranges
from repro_torch.analysis.findings import ERROR, WARNING, Finding
from repro_torch.launch.hlo_cost import PRODUCTS

__all__ = ["DotSite", "abstract_params", "collect_dot_generals",
           "cross_check", "range_sweep", "check_model"]

#: Operations that carry their first input's identity through unchanged in
#: provenance terms — enough to follow a weight leaf into its product.
_PASS_THROUGH = frozenset({
    "select", "unbind", "split", "t", "transpose", "permute", "view",
    "_unsafe_view", "reshape", "expand", "slice", "squeeze", "unsqueeze",
    "clone", "_to_copy", "alias", "detach", "contiguous",
})


@dataclasses.dataclass(frozen=True)
class DotSite:
    """One matrix product, normalized to GEMM terms."""

    lhs_shape: tuple[int, ...]
    rhs_shape: tuple[int, ...]
    k: int                    # contracted size
    n_out: int                # rhs (weight) free size
    m: int                    # lhs free size
    batch: int                # product of batch-dim sizes (0 dims -> 1)
    param_path: str | None    # weight-leaf provenance, if either operand
                              # traces back to a parameter leaf

    @property
    def weight_like(self) -> bool:
        return self.param_path is not None


def _meta_tree(defs, dtype: torch.dtype):
    from repro_torch.models.common import ParamDef

    if isinstance(defs, ParamDef):
        return torch.empty(tuple(defs.shape), dtype=dtype, device="meta")
    return {k: _meta_tree(defs[k], dtype) for k in sorted(defs)}


def abstract_params(cfg):
    """The model's parameter tree as ``meta`` tensors built from
    ``model_defs`` (no FLOPs, no memory — works for the full published
    configs)."""
    from repro_torch.models import model as model_lib
    from repro_torch.models.common import dtype_of

    return _meta_tree(model_lib.model_defs(cfg), dtype_of(cfg.param_dtype))


def _dot_site(lhs: torch.Tensor, rhs: torch.Tensor, lhs_path: str | None,
              rhs_path: str | None) -> DotSite:
    batch = math.prod(rhs.shape[:-2])
    if rhs_path is None and lhs_path is not None:
        # the decomposition put the weight on the left: (n, k) @ (k, m)
        k, n_out, m, path = lhs.shape[-1], lhs.shape[-2], rhs.shape[-1], lhs_path
    else:
        k, n_out, m = rhs.shape[-2], rhs.shape[-1], lhs.shape[-2]
        path = rhs_path if rhs_path is not None else lhs_path
    return DotSite(lhs_shape=tuple(lhs.shape), rhs_shape=tuple(rhs.shape),
                   k=int(k), n_out=int(n_out), m=int(m), batch=int(batch),
                   param_path=path)


class _ProductRecorder(TorchDispatchMode):
    """Records every matrix product the wrapped code dispatches, with the
    parameter path its operands trace back to."""

    def __init__(self, params) -> None:
        from repro_torch.eval.planner import _walk

        super().__init__()
        # id -> (tensor, path); holding the tensor keeps its id unique
        self.labels: dict[int, tuple[torch.Tensor, str]] = {
            id(leaf): (leaf, path) for path, leaf in _walk(params)}
        self.dots: list[DotSite] = []

    def _path(self, t) -> str | None:
        hit = self.labels.get(id(t))
        return hit[1] if hit is not None and hit[0] is t else None

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func.overloadpacket.__name__
        if name in PRODUCTS:
            i, j = PRODUCTS[name]
            lhs, rhs = args[i], args[j]
            self.dots.append(_dot_site(lhs, rhs, self._path(lhs),
                                       self._path(rhs)))
        elif name in _PASS_THROUGH and args:
            path = self._path(args[0])
            if path is not None:
                for t in (out if isinstance(out, (tuple, list)) else (out,)):
                    if isinstance(t, torch.Tensor):
                        self.labels[id(t)] = (t, path)
        return out


def _scan(cfg, params, *, batch: int, seq_len: int, record_sites: bool):
    """One ``meta`` forward: the dispatched products and, with
    ``record_sites``, the planner's recorded calls of the same pass."""
    from repro_torch import backends
    from repro_torch.eval import planner

    meta = planner.meta_like(params)
    recorder = _ProductRecorder(meta)
    sites = backends.record_sites() if record_sites else contextlib.nullcontext()
    with torch.no_grad(), sites as rec, recorder:
        planner.meta_forward(cfg, meta, batch=batch, seq_len=seq_len)
    return recorder.dots, (rec.calls if record_sites else None)


def collect_dot_generals(cfg, params=None, *, batch: int = 1,
                         seq_len: int = 8) -> list[DotSite]:
    """Every matrix product one forward step dispatches, with provenance."""
    if params is None:
        params = abstract_params(cfg)
    return _scan(cfg, params, batch=batch, seq_len=seq_len,
                 record_sites=False)[0]


def cross_check(sites, dots: Sequence[DotSite], *,
                arch: str = "") -> list[Finding]:
    """Reconcile recorded GEMM sites against the dispatched products.

    * a recorded site with no product of matching (k, n_out) is an error —
      the site contract claims a contraction the model never runs;
    * a weight-consuming product that matches no recorded site is a
      warning — the planner cannot price or plan it, so it always runs on
      the float path (tied-embedding logits heads land here).
    """
    prefix = f"{arch}/" if arch else ""
    findings: list[Finding] = []
    shapes = {(d.k, d.n_out) for d in dots}
    for site in sites:
        if (site.k, site.n_out) not in shapes:
            findings.append(Finding(
                pass_name="ranges", rule="site-not-in-jaxpr",
                severity=ERROR, where=f"{prefix}{site.name}",
                message=f"recorded GEMM site (k={site.k}, "
                        f"n_out={site.n_out}) has no matching dot_general "
                        f"in the model jaxpr"))
    site_shapes = {(s.k, s.n_out) for s in sites}
    seen: set[str] = set()
    for dot in dots:
        if not dot.weight_like or (dot.k, dot.n_out) in site_shapes:
            continue
        if dot.k == 1 and dot.n_out == 1:
            continue  # degenerate rank-0 contraction (a scalar gate), not a GEMM
        if dot.param_path in seen:
            continue
        seen.add(dot.param_path)
        findings.append(Finding(
            pass_name="ranges", rule="planner-invisible-gemm",
            severity=WARNING, where=f"{prefix}{dot.param_path}",
            message=f"weight leaf contracts as (k={dot.k}, "
                    f"n_out={dot.n_out}) outside any dense site — the "
                    f"planner cannot assign it a backend, so it always "
                    f"runs on the float path"))
    return findings


def range_sweep(sites, *, designs: Sequence[str],
                bits_candidates: Sequence[int],
                grids: Sequence[tuple[int, int]] = ((1, 1),),
                arch: str = "") -> tuple[list[Finding], int]:
    """Prove every (site, design, bits, grid) point's accumulator safe.

    For each discovered site, every candidate design x bit-width is checked
    at the site's full contraction length and at each grid geometry's
    per-shard split (K ceil-split over ``units_x`` — the shard K that
    ``GridBackend.execute`` contracts at most).  An individually infeasible
    combination is a *warning* (the planner prunes it); a site where **no**
    candidate fits any envelope is an error — nothing could ever execute it
    exactly.

    Returns ``(findings, points_checked)``.
    """
    prefix = f"{arch}/" if arch else ""
    findings: list[Finding] = []
    checked = 0
    for site in sites:
        feasible = 0
        for design in designs:
            for bits in bits_candidates:
                for ux, uy in grids:
                    k_shard = -(-site.k // ux)
                    checked += 1
                    where = f"{prefix}{site.name}"
                    if (ux, uy) != (1, 1):
                        where += f" [grid {ux}x{uy}]"
                    f = ranges.check_gemm(design, bits, k_shard, where=where)
                    if f is None:
                        if (ux, uy) == grids[0]:
                            feasible += 1
                    elif f.rule == "acc-overflow":
                        findings.append(dataclasses.replace(
                            f, severity=WARNING,
                            message=f.message + " (planner prunes this "
                                    "candidate)"))
                    else:
                        findings.append(f)
        if not feasible:
            findings.append(Finding(
                pass_name="ranges", rule="no-feasible-design",
                severity=ERROR, where=f"{prefix}{site.name}",
                message=f"no (design, bits) candidate among "
                        f"{list(designs)} x {list(bits_candidates)} can "
                        f"contract K={site.k} inside its accumulator "
                        f"envelope"))
    return findings, checked


def check_model(cfg, *, arch: str = "",
                designs: Sequence[str] = ("bgemm", "ugemm", "tugemm",
                                          "tubgemm"),
                bits_candidates: Sequence[int] = (2, 4, 8),
                grids: Sequence[tuple[int, int]] = ((1, 1), (2, 2), (4, 1)),
                batch: int = 1, seq_len: int = 8,
                ) -> tuple[list[Finding], dict]:
    """Run the full numeric-range pass for one model config.

    Discovery and the product scan share one ``meta`` forward (the
    ``record_sites`` scope inside the dispatch mode), then the
    cross-check and the envelope sweep.  Returns ``(findings, stats)``
    where stats summarizes the coverage (sites, dispatched products,
    points checked).
    """
    from repro_torch.eval import planner

    params = abstract_params(cfg)
    dots, calls = _scan(cfg, params, batch=batch, seq_len=seq_len,
                        record_sites=True)
    sites = planner.sites_from_calls(cfg, params, calls, batch=batch)
    findings = cross_check(sites, dots, arch=arch)
    sweep, checked = range_sweep(sites, designs=designs,
                                 bits_candidates=bits_candidates,
                                 grids=grids, arch=arch)
    findings.extend(sweep)
    stats = {"arch": arch, "sites": len(sites), "dot_generals": len(dots),
             "points_checked": checked}
    return findings, stats
