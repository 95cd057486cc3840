"""Design-space evaluation layer: the paper's §IV sweet-spot analysis as code.

- sweetspot : sweeps bits x matrix size x design over the ``gemm_sims``
  registry, prices every point with ``core.ppa``, finds per-metric winners
  and crossover frontiers, and cross-checks the simulators' outputs and
  cycle models against the hand-written CUDA kernels (``*_cuda`` mirrors).
- planner   : the per-layer mixed-precision backend planner — profiles every
  dense GEMM site's weight sparsity, prices (design, bits) candidates with
  Eq. 1-scaled dynamic cycles under an accuracy guard, and emits a typed
  ``repro_torch.backends.BackendPlan`` that ``use_plan`` /
  ``serve --backend-plan`` execute; rate-coded ``ugemm_stochastic``
  candidates join with ``stream_lens``, and ``build_grid_plan`` plans a
  PE-array grid per shard (a ``GridPlan``).
- report    : serializes a sweep to machine-readable JSON and human-readable
  markdown tables.
"""

from repro_torch.eval import planner, report, sweetspot

__all__ = ["planner", "report", "sweetspot"]
