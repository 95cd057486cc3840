"""Request lifecycle + batching schedulers (continuous vs static).

A request moves ``WAITING -> RUNNING -> FINISHED``:

* WAITING — arrived (its ``arrival_step`` has passed) but not admitted;
* RUNNING — admitted: pages reserved, prompt prefilled, first token out,
  occupying one batch slot of the engine's fixed decode batch;
* FINISHED — produced its ``output_len``-th token; slot and pages freed at
  the step boundary (eviction happens mid-trace, not at end-of-batch).

Admission rule (both schedulers, documented in docs/SERVING.md): a request
is admitted only when a batch slot is free AND the allocator can reserve
``ceil((prompt_len + output_len) / page_size)`` pages up front — the full
worst-case footprint — so a running request can never hit an out-of-pages
fault mid-decode and no preemption/swapping machinery is needed.  Admission
is strict FIFO by arrival (head-of-line blocking is deterministic and fair;
no request can starve).

:class:`ContinuousBatchingScheduler` admits at every step boundary into any
freed slot; :class:`StaticBatchingScheduler` is the baseline the benchmark
gate compares against — it fills a batch, then admits nothing until *every*
request in the batch has finished (classic static batching; freed slots sit
idle, which is exactly the occupancy the continuous scheduler recovers).
"""

from __future__ import annotations

import dataclasses
import enum

from repro_torch.serving.paged_kv import PagedKVCache
from repro_torch.serving.traffic import TrafficRequest

__all__ = ["RequestState", "Request", "ContinuousBatchingScheduler",
           "StaticBatchingScheduler", "make_scheduler"]


class RequestState(enum.Enum):
    WAITING = "waiting"
    RUNNING = "running"
    FINISHED = "finished"


@dataclasses.dataclass
class Request:
    """Runtime state wrapped around one immutable trace entry."""
    spec: TrafficRequest
    state: RequestState = RequestState.WAITING
    admitted_step: int = -1
    finish_step: int = -1
    generated: int = 0
    slot: int = -1

    @property
    def req_id(self) -> int:
        return self.spec.req_id

    @property
    def latency(self) -> int:
        """Completion latency in decode steps (finish - arrival)."""
        assert self.state is RequestState.FINISHED
        return self.finish_step - self.spec.arrival_step

    @property
    def queue_delay(self) -> int:
        return self.admitted_step - self.spec.arrival_step


class _SchedulerBase:
    """Shared FIFO + page-reservation admission; subclasses gate *when*."""

    name = "base"

    def __init__(self, max_batch: int) -> None:
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        self.max_batch = max_batch

    def admissions(self, step: int, waiting: list[Request],
                   n_running: int, cache: PagedKVCache) -> list[Request]:
        """Requests to admit at this step boundary, in FIFO order.

        Callers admit each returned request (allocating its pages) before
        this is consulted again, so the free-page check here uses a running
        tally of what the earlier picks will consume.
        """
        if not self._may_admit(n_running):
            return []
        picked: list[Request] = []
        budget = cache.allocator.num_free
        for req in waiting:
            if req.spec.arrival_step > step:
                break  # FIFO by arrival; later entries arrived even later
            if n_running + len(picked) >= self.max_batch:
                break
            need = cache.pages_needed(req.spec.total_len)
            if need > budget:
                break  # strict FIFO: head-of-line blocks (deterministic)
            budget -= need
            picked.append(req)
        return picked

    def _may_admit(self, n_running: int) -> bool:
        raise NotImplementedError


class ContinuousBatchingScheduler(_SchedulerBase):
    """Join new requests at every step boundary, evict finished mid-decode."""

    name = "continuous"

    def _may_admit(self, n_running: int) -> bool:
        return True


class StaticBatchingScheduler(_SchedulerBase):
    """Baseline: admit a batch, then wait for ALL of it to finish.

    Admission is possible only while the batch is empty — once anything
    runs, freed slots stay idle until the whole batch drains (it does not
    wait for ``max_batch`` arrivals: at the end of a trace that would
    deadlock on a partial batch)."""

    name = "static"

    def _may_admit(self, n_running: int) -> bool:
        return n_running == 0


def make_scheduler(name: str, max_batch: int) -> _SchedulerBase:
    try:
        cls = {"continuous": ContinuousBatchingScheduler,
               "static": StaticBatchingScheduler}[name]
    except KeyError:
        raise ValueError(f"unknown scheduler {name!r}") from None
    return cls(max_batch)
