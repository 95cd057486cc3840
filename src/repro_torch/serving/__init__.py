"""Continuous-batching serving on the unary backend stack.

A paged KV cache (``paged_kv``) read through the fused page-walk kernel or
the gather oracle (``kernels.paged_attention*``), a continuous-batching
scheduler with page-reservation admission control (``scheduler``), a seeded
synthetic traffic generator (``traffic``), Eq.-1 energy-per-token accounting
(``energy``), and the engine that advances the whole batch one ragged decode
step at a time under ``use_backend(...)`` or ``use_plan(...)``, from float or
bit-packed weights (``engine``).
"""

from repro_torch.serving.engine import (FUSED_LOGIT_TOL, ServingEngine,
                                        ServingReport, fused_vs_gather_probe,
                                        paged_vs_contiguous_probe)
from repro_torch.serving.paged_kv import OutOfPages, PageAllocator, PagedKVCache
from repro_torch.serving.scheduler import (ContinuousBatchingScheduler, Request,
                                           RequestState, StaticBatchingScheduler,
                                           make_scheduler)
from repro_torch.serving.traffic import TrafficConfig, TrafficRequest, generate_trace

__all__ = [
    "ServingEngine", "ServingReport", "paged_vs_contiguous_probe",
    "fused_vs_gather_probe", "FUSED_LOGIT_TOL",
    "OutOfPages", "PageAllocator", "PagedKVCache",
    "ContinuousBatchingScheduler", "StaticBatchingScheduler",
    "Request", "RequestState", "make_scheduler",
    "TrafficConfig", "TrafficRequest", "generate_trace",
]
