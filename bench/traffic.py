"""Request traffic for the benchmark's cells: one general generator.

A frozen copy, changed in two respects, of the port's
``repro_torch.serving.traffic.generate_trace``: arrivals are Poisson in
scheduler steps and lengths uniform over their ranges, but

* every trace holds the *same* multiset of inter-arrival gaps, prompt
  lengths and output lengths (the mid-quantiles of each distribution), in
  an order of its own, so every trace asks for the same work;
* the order of trace ``i`` is drawn from ``i`` alone, not from the run's
  seed: the scheduler's steps follow the order (which requests share a
  step, how long a slot waits), so runs whose orders differed did
  different work (PERF.md §2).  A run serves traces ``0, 1, ...``, each in
  another order; the seed changes the weights and the prompts' tokens.

A cell's ``traffic`` parameters (its workload file):

``requests``  requests in one trace; ``rate``  mean arrivals a scheduler
step; ``prompt``  ``[lo, hi]`` prompt tokens; ``output``  ``[lo, hi]``
generated tokens (first token included); ``trace_seconds``  the seconds one
trace took on the card when the cell was made, which fixes how many traces
a window of ``--seconds`` serves (``serve.trace_count``).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

__all__ = ["Request", "generate", "warmup_trace", "buckets", "ID_STRIDE"]

#: request ids of trace ``i`` are ``i * ID_STRIDE + j``: unique in a run
ID_STRIDE = 100_000


@dataclasses.dataclass(frozen=True)
class Request:
    req_id: int
    arrival_step: int
    prompt_len: int
    output_len: int

    @property
    def total_len(self) -> int:
        return self.prompt_len + self.output_len


def _mid_quantiles(n: int) -> np.ndarray:
    return (np.arange(n, dtype=np.float64) + 0.5) / n


def _uniform_ints(lo: int, hi: int, n: int) -> np.ndarray:
    """The ``n`` mid-quantiles of the uniform distribution over the integers
    ``lo..hi``."""
    return np.floor(lo + _mid_quantiles(n) * (hi - lo + 1)).astype(np.int64)


def _check(traffic: dict) -> tuple[int, float, tuple[int, int], tuple[int, int]]:
    n = int(traffic["requests"])
    rate = float(traffic["rate"])
    prompt = tuple(int(v) for v in traffic["prompt"])
    output = tuple(int(v) for v in traffic["output"])
    if n < 1 or rate <= 0:
        raise ValueError(f"traffic needs requests >= 1 and rate > 0: {traffic}")
    for name, (lo, hi) in (("prompt", prompt), ("output", output)):
        if not 1 <= lo <= hi:
            raise ValueError(f"traffic {name} range {lo}..{hi} is empty")
    return n, rate, prompt, output


def generate(traffic: dict, index: int) -> tuple[Request, ...]:
    """Trace ``index``: the cell's fixed multiset of gaps and lengths, each
    permuted by ``default_rng(index)``."""
    n, rate, prompt, output = _check(traffic)
    rng = np.random.default_rng(int(index))
    # the first request arrives at step 0, the others after n - 1 gaps: the
    # exponential distribution's n - 1 mid-quantiles
    gaps = -np.log1p(-_mid_quantiles(n - 1)) / rate
    gaps = gaps[rng.permutation(n - 1)]
    prompts = _uniform_ints(*prompt, n)[rng.permutation(n)]
    outputs = _uniform_ints(*output, n)[rng.permutation(n)]
    arrivals = np.floor(np.concatenate([[0.0], np.cumsum(gaps)])).astype(np.int64)
    return tuple(Request(req_id=index * ID_STRIDE + j,
                         arrival_step=int(arrivals[j]),
                         prompt_len=int(prompts[j]),
                         output_len=int(outputs[j]))
                 for j in range(n))


def warmup_trace(traffic: dict, first_id: int) -> tuple[Request, ...]:
    """One request for each prefill width the cell's prompts fall in (its
    longest prompt there), each arriving at its own step, so set-up meets
    every prefill shape and the decode step of the cell and no other."""
    _, _, (plo, phi), (olo, _) = _check(traffic)
    out = []
    for j, width in enumerate(buckets(traffic)):
        out.append(Request(req_id=first_id + j, arrival_step=2 * j,
                           prompt_len=max(plo, min(width, phi)),
                           output_len=max(2, min(olo, 4))))
    return tuple(out)


def buckets(traffic: dict, floor: int = 4) -> list[int]:
    """The prefill widths (next power of two at or above ``floor``) the
    cell's prompt lengths fall in."""
    _, _, (plo, phi), _ = _check(traffic)
    lo = max(floor, 1 << max(0, math.ceil(math.log2(plo))))
    hi = max(floor, 1 << max(0, math.ceil(math.log2(phi))))
    out, b = [], lo
    while b <= hi:
        out.append(b)
        b *= 2
    return out
