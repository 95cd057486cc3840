"""Typed GEMM backend API: ``resolve`` a design into a :class:`GemmBackend`
and thread it into the model with :func:`use_backend`, or a per-site
:class:`BackendPlan` with :func:`use_plan`.

    from repro_torch import backends
    be = backends.resolve("tubgemm_cuda", bits=4)
    out = be.execute(a_codes, b_codes)          # int32, == binary GEMM
    with backends.use_backend("tubgemm_cuda", bits=4):
        logits = model.forward(params, cfg, tokens)

    plan = backends.load_plan("reports/plan.json")
    with backends.use_plan(plan):               # per-site mixed precision
        logits = model.forward(params, cfg, tokens)
    packed = backends.pack_weights(cfg, params, plan)   # frozen stores

PE-array grids (``GridPlan``, ``grid=``) are not ported yet: a grid plan
file makes :func:`load_plan` raise ``NotImplementedError``.
"""

import json
import os

from repro_torch.backends.base import GemmBackend
from repro_torch.backends.plan import SCHEMA as PLAN_SCHEMA
from repro_torch.backends.plan import BackendPlan, SiteAssignment
from repro_torch.backends.registry import (CUDA_SUFFIX, KERNEL_SIBLINGS,
                                           STOCHASTIC_DESIGN, available,
                                           mirror_design_spec, resolve)
from repro_torch.backends.runtime import (BackendExecution, ExecutedGemm,
                                          PlanExecution, SiteRecorder,
                                          active_backend, active_execution,
                                          current_site, measure_matrix_cycles,
                                          pack_weights, record_sites,
                                          site_scope, use_backend, use_plan)

__all__ = [
    "GemmBackend", "resolve", "available", "mirror_design_spec",
    "KERNEL_SIBLINGS", "CUDA_SUFFIX", "STOCHASTIC_DESIGN", "BackendPlan", "SiteAssignment",
    "GRID_SCHEMA", "GRID_PLAN_MSG", "load_plan",
    "BackendExecution", "PlanExecution", "SiteRecorder", "ExecutedGemm",
    "use_backend", "use_plan", "pack_weights", "record_sites",
    "measure_matrix_cycles", "active_backend", "active_execution",
    "site_scope", "current_site",
]

#: the per-shard grid plan schema, which waits for the grids slice
GRID_SCHEMA = "repro.backends.gridplan/v1"
GRID_PLAN_MSG = ("grid plans (schema repro.backends.gridplan/v1) need "
                 "backends/grid.py, which the grids slice of the port brings")


def load_plan(path: str | os.PathLike) -> BackendPlan:
    """Load a flat plan (``repro.backends.plan/v1``) saved by either package.

    A grid plan raises ``NotImplementedError``; any other schema is a
    ValueError naming the accepted one.
    """
    with open(os.fspath(path)) as fh:
        text = fh.read()
    schema = json.loads(text).get("schema")
    if schema == GRID_SCHEMA:
        raise NotImplementedError(f"{path}: {GRID_PLAN_MSG}")
    if schema == PLAN_SCHEMA:
        return BackendPlan.from_json(text)
    raise ValueError(f"{path}: unknown plan schema {schema!r} "
                     f"(expected {PLAN_SCHEMA!r})")
