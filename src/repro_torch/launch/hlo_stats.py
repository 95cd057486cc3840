"""Roofline terms for one step on an NVIDIA H100 SXM.

Where the reference reads the compiled XLA HLO, the port reads the
operations one eager step dispatches (:mod:`repro_torch.launch.hlo_cost`)
and turns their counts into the three roofline terms here.

``collective_bytes(hlo_text)`` is not ported, by design: it parses XLA's
partitioned HLO text, and eager PyTorch emits none.  A one-device step
runs no collective, so its collective term is 0 bytes; the multi-device
slice (ROADMAP Queue 1 item 6) brings a count of the
``torch.distributed`` traffic in its place.
"""

from __future__ import annotations

import dataclasses

__all__ = ["CollectiveStats", "RooflineTerms", "roofline", "HW",
           "COLLECTIVES", "no_collectives"]

# NVIDIA H100 SXM data sheet, per card: 989 TFLOP/s dense bf16, 3.35 TB/s
# HBM3, NVLink 4 at 900 GB/s both directions together (450 GB/s each way,
# the rate one card's outgoing traffic sees)
HW = dict(peak_flops=989e12, hbm_bw=3.35e12, link_bw=450e9)

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")


@dataclasses.dataclass
class CollectiveStats:
    total_bytes: float
    by_op: dict[str, float]
    counts: dict[str, int]


def no_collectives() -> CollectiveStats:
    """The collective traffic of a one-device step: none."""
    return CollectiveStats(total_bytes=0.0,
                           by_op={c: 0.0 for c in COLLECTIVES},
                           counts={c: 0 for c in COLLECTIVES})


@dataclasses.dataclass
class RooflineTerms:
    """The three roofline terms (seconds) for one (arch, shape, mesh) cell."""

    compute_s: float
    memory_s: float
    collective_s: float
    hlo_flops: float            # per device
    hlo_bytes: float            # per device
    coll_bytes: float           # per device
    chips: int
    model_flops: float = 0.0    # 6·N·D (or 6·N_active·D) for the whole step

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_time_s(self) -> float:
        """Optimistic (max-overlap) step time estimate."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / (counted FLOPs x chips) — remat/redundancy waste."""
        if self.hlo_flops <= 0:
            return 0.0
        return self.model_flops / (self.hlo_flops * self.chips)

    @property
    def roofline_fraction(self) -> float:
        """Useful-model-FLOPs throughput / peak, at the estimated step time."""
        if self.step_time_s <= 0:
            return 0.0
        return (self.model_flops / self.step_time_s) / (
            self.chips * HW["peak_flops"])


def roofline(cost_analysis: dict, coll: CollectiveStats, chips: int,
             model_flops: float = 0.0) -> RooflineTerms:
    """Terms from a step's counted ``flops`` / ``bytes accessed`` (per
    device) and its collective bytes."""
    flops = float(cost_analysis.get("flops", 0.0))
    byts = float(cost_analysis.get("bytes accessed", 0.0))
    return RooflineTerms(
        compute_s=flops / HW["peak_flops"],
        memory_s=byts / HW["hbm_bw"],
        collective_s=coll.total_bytes / HW["link_bw"],
        hlo_flops=flops, hlo_bytes=byts, coll_bytes=coll.total_bytes,
        chips=chips, model_flops=model_flops)
