"""Seeded synthetic request traffic: Poisson arrivals, mixed length mixture.

All randomness flows from one ``np.random.default_rng(seed)`` — no module
state, no wall clock — so the same seed always produces the identical trace
(pinned by ``tests/test_serving.py``) and two engines can be compared on
byte-identical workloads.  Time is measured in *scheduler steps* (one decode
step per step), matching the engine's latency unit.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["TrafficConfig", "TrafficRequest", "generate_trace"]


@dataclasses.dataclass(frozen=True)
class TrafficRequest:
    """One synthetic request: arrives at ``arrival_step``, carries a
    ``prompt_len``-token prompt, and wants ``output_len`` generated tokens."""
    req_id: int
    arrival_step: int
    prompt_len: int
    output_len: int

    @property
    def total_len(self) -> int:
        return self.prompt_len + self.output_len


@dataclasses.dataclass(frozen=True)
class TrafficConfig:
    """Poisson arrivals at ``arrival_rate`` requests/step; prompt and output
    lengths drawn from a short/long mixture (``p_long`` weighs the long
    range) — the bimodal mix interactive serving actually sees."""
    num_requests: int = 16
    arrival_rate: float = 0.5
    prompt_short: tuple[int, int] = (2, 8)
    prompt_long: tuple[int, int] = (12, 24)
    output_short: tuple[int, int] = (2, 6)
    output_long: tuple[int, int] = (8, 16)
    p_long: float = 0.3
    seed: int = 0


def _mixture(rng: np.random.Generator, short: tuple[int, int],
             long: tuple[int, int], p_long: float) -> int:
    lo, hi = long if rng.random() < p_long else short
    return int(rng.integers(lo, hi + 1))


def generate_trace(tcfg: TrafficConfig) -> tuple[TrafficRequest, ...]:
    """Deterministic trace for ``tcfg`` — same config (incl. seed) ⇒ same
    trace, element for element."""
    if tcfg.num_requests < 1:
        raise ValueError("num_requests must be >= 1")
    if tcfg.arrival_rate <= 0:
        raise ValueError("arrival_rate must be > 0")
    rng = np.random.default_rng(tcfg.seed)
    inter = rng.exponential(1.0 / tcfg.arrival_rate, size=tcfg.num_requests)
    arrivals = np.floor(np.cumsum(inter)).astype(int)
    out = []
    for i in range(tcfg.num_requests):
        out.append(TrafficRequest(
            req_id=i,
            arrival_step=int(arrivals[i]),
            prompt_len=_mixture(rng, tcfg.prompt_short, tcfg.prompt_long,
                                tcfg.p_long),
            output_len=_mixture(rng, tcfg.output_short, tcfg.output_long,
                                tcfg.p_long),
        ))
    return tuple(out)
