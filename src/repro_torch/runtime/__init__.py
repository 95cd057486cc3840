"""Runtime substrate: retries, stragglers, elastic re-meshing (framework-free,
the reference's module as it stands), and the port's host spans."""

from repro_torch.runtime import spans
from repro_torch.runtime.fault import (StepTimer, StragglerWatchdog, plan_mesh,
                                       retry_with_backoff)

__all__ = ["StepTimer", "StragglerWatchdog", "plan_mesh", "retry_with_backoff",
           "spans"]
