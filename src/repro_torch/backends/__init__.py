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

    gplan = backends.load_plan("reports/grid_plan.json")  # either schema
    with backends.use_plan(gplan):              # sharded on a 2x2 unit grid
        logits = model.forward(params, cfg, tokens)
    grid = backends.as_grid(be, 2, 2)           # shards run one after another
    assert torch.equal(grid.execute(a_codes, b_codes), out)
"""

from repro_torch.backends.base import GemmBackend
from repro_torch.backends.grid import (GRID_SCHEMA, GridBackend, GridPlan,
                                       ShardedCodes, as_grid,
                                       grid_matrix_cycles, load_plan,
                                       parse_grid, shard_site, shard_slices)
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
    "GemmBackend", "GridBackend", "GridPlan", "ShardedCodes", "resolve",
    "available", "mirror_design_spec", "KERNEL_SIBLINGS", "CUDA_SUFFIX",
    "STOCHASTIC_DESIGN", "BackendPlan", "SiteAssignment", "GRID_SCHEMA",
    "as_grid", "grid_matrix_cycles", "load_plan", "parse_grid", "shard_site",
    "shard_slices",
    "BackendExecution", "PlanExecution", "SiteRecorder", "ExecutedGemm",
    "use_backend", "use_plan", "pack_weights", "record_sites",
    "measure_matrix_cycles", "active_backend", "active_execution",
    "site_scope", "current_site",
]
