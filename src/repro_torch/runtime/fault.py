"""Fault tolerance runtime: retries, straggler watchdog, elastic re-meshing.

At thousand-node scale three failure classes dominate; each has a handler:

* **transient step failure** (preemption, flaky ICI, data hiccup) —
  ``retry_with_backoff`` re-executes the part of the step that leaves the
  state untouched.  The training loop retries only the gradient
  computation: the AdamW update changes the state in place, leaf by leaf,
  so a failure there is not retried (a second pass would apply the early
  leaves' update twice); it ends the run, which resumes from the latest
  COMPLETE checkpoint.
* **stragglers** (slow host, thermal throttle) — ``StragglerWatchdog`` keeps a
  robust running median of step times and flags outliers; the training loop
  responds by checkpointing and (optionally) excluding the slow host via
  elastic re-mesh.  On single-process CPU we detect and log (tests inject
  synthetic delays).
* **node loss** (hard failure) — auto-resume from the latest COMPLETE
  checkpoint onto a *smaller* mesh: ``plan_mesh`` picks the largest valid
  (data, model) factorization of the surviving chip count and
  ``checkpoint.restore(shardings=...)`` re-lays-out the global arrays
  (elastic scaling).
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Callable

log = logging.getLogger("repro_torch.runtime")

__all__ = ["retry_with_backoff", "StragglerWatchdog", "plan_mesh", "StepTimer"]


def retry_with_backoff(fn: Callable, retries: int = 3, base_delay: float = 0.5,
                       on_retry: Callable[[int, Exception], None] | None = None):
    """Run ``fn()``; on exception retry with exponential backoff."""
    attempt = 0
    while True:
        try:
            return fn()
        except Exception as e:  # noqa: BLE001 — the point is to survive
            attempt += 1
            if attempt > retries:
                raise
            if on_retry is not None:
                on_retry(attempt, e)
            delay = base_delay * (2 ** (attempt - 1))
            log.warning("step failed (%s); retry %d/%d in %.1fs",
                        e, attempt, retries, delay)
            time.sleep(delay)


@dataclasses.dataclass
class StragglerWatchdog:
    """Flags steps slower than ``threshold`` x the running median."""

    threshold: float = 2.0
    window: int = 64
    warmup: int = 5
    _times: list = dataclasses.field(default_factory=list)
    slow_steps: int = 0

    def observe(self, seconds: float) -> bool:
        """Record a step time; returns True if this step is a straggler."""
        times = self._times
        is_slow = False
        if len(times) >= self.warmup:
            med = sorted(times)[len(times) // 2]
            if seconds > self.threshold * med:
                is_slow = True
                self.slow_steps += 1
                log.warning("straggler: step took %.3fs (median %.3fs)",
                            seconds, med)
        times.append(seconds)
        if len(times) > self.window:
            times.pop(0)
        return is_slow

    @property
    def median(self) -> float | None:
        if not self._times:
            return None
        return sorted(self._times)[len(self._times) // 2]


class StepTimer:
    """Context manager feeding the watchdog."""

    def __init__(self, watchdog: StragglerWatchdog):
        self.watchdog = watchdog
        self.was_slow = False

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self._t0
        self.was_slow = self.watchdog.observe(self.elapsed)
        return False


def plan_mesh(n_chips: int, model_parallel: int | None = None,
              pod_size: int = 256) -> tuple[tuple[int, ...], tuple[str, ...]]:
    """Largest valid mesh for a (possibly degraded) chip count.

    Elastic policy: keep model parallelism fixed (it must divide the model's
    sharded dims), shrink data parallelism; add a 'pod' axis above pod_size.
    """
    if model_parallel is None:
        model_parallel = 16 if n_chips % 16 == 0 and n_chips >= 16 else 1
    usable = (n_chips // model_parallel) * model_parallel
    data = usable // model_parallel
    if usable > pod_size and usable % pod_size == 0:
        pods = usable // pod_size
        data = pod_size // model_parallel
        return (pods, data, model_parallel), ("pod", "data", "model")
    return (data, model_parallel), ("data", "model")
