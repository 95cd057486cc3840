"""Runtime substrate: retries, stragglers, elastic re-meshing (framework-free,
the reference's module as it stands)."""

from repro_torch.runtime.fault import (StepTimer, StragglerWatchdog, plan_mesh,
                                       retry_with_backoff)

__all__ = ["StepTimer", "StragglerWatchdog", "plan_mesh", "retry_with_backoff"]
