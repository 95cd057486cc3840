"""Design-space evaluation layer (the part the serving CLI needs).

- planner   : the per-layer mixed-precision backend planner — profiles every
  dense GEMM site's weight sparsity, prices (design, bits) candidates with
  Eq. 1-scaled dynamic cycles under an accuracy guard, and emits a typed
  ``repro_torch.backends.BackendPlan`` that ``use_plan`` /
  ``serve --backend-plan`` execute; rate-coded ``ugemm_stochastic``
  candidates join with ``stream_lens``.  Grid plans wait for their slice.
- sweetspot : ``recommend_backend`` only (the one-shot ``serve`` mode's
  verdict line); the sweep and its report wait for their slice.
"""

from repro_torch.eval import planner, sweetspot

__all__ = ["planner", "sweetspot"]
