"""Static analysis gating the backend/plan/grid stack.

Three passes, one CLI (``python -m repro_torch.analysis``, non-zero exit
on error findings):

* :mod:`repro_torch.analysis.ranges` + :mod:`repro_torch.analysis.jaxpr_scan`
  — the numeric-range verifier: interval arithmetic over worst-case
  accumulator magnitudes per design, applied to every GEMM site a
  ``meta``-device forward discovers, cross-checked against the matrix
  products that forward dispatches (the reference reads a jaxpr).
* :mod:`repro_torch.analysis.plan_lint` — static checks on ``BackendPlan`` /
  ``GridPlan`` JSON (unknown designs, dead/shadowed patterns, uncovered
  sites, guard relaxations, overflow-hazardous assignments).
* :mod:`repro_torch.analysis.source_lint` — the port's AST rules (registry
  mutation outside ``scoped_registry``, deprecated shim calls, samplers on
  the process-global generator in execute paths, float-accumulating
  exact-design functions, dequantize in the packed kernel module).

This package ``__init__`` stays import-light: ``repro_torch.backends.base``
imports :mod:`repro_torch.analysis.ranges` for its runtime envelope guard,
so eagerly importing the lint passes here (which import
``repro_torch.backends``) would create a cycle.  Submodules load lazily on
attribute access.
"""

from __future__ import annotations

import importlib

from repro_torch.analysis.findings import (  # noqa: F401  (re-export)
    ERROR, Finding, WARNING, errors, exit_code, verdict_line,
)

_SUBMODULES = ("findings", "ranges", "jaxpr_scan", "plan_lint",
               "source_lint")

__all__ = ["ERROR", "WARNING", "Finding", "errors", "exit_code",
           "verdict_line", *_SUBMODULES]


def __getattr__(name: str):
    if name in _SUBMODULES:
        return importlib.import_module(f"repro_torch.analysis.{name}")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
