"""Sweet-spot verdict for a model's actual GEMM workload.

Only the piece the one-shot ``serve`` mode prints is ported:
:data:`CALIBRATED_DESIGNS` and :func:`recommend_backend`.  The sweep over
bits x size x design, its winners, crossovers and report wait for their
slice of the port.
"""

from __future__ import annotations

from typing import Sequence

from repro_torch.configs import paper_gemm
from repro_torch.core.accounting import GemmCall

__all__ = ["CALIBRATED_DESIGNS", "recommend_backend"]

#: the four designs the paper synthesized (the only ones ppa can price)
CALIBRATED_DESIGNS: tuple[str, ...] = paper_gemm.DESIGNS


def recommend_backend(calls: list[GemmCall], *, bits: int, unit_n: int,
                      num_units: int = 1,
                      designs: Sequence[str] = CALIBRATED_DESIGNS,
                      costs: dict | None = None) -> dict[str, dict]:
    """Name the optimal PE-array design for a model's actual GEMM workload.

    Prices ``calls`` (recorded layer shapes + measured bit sparsity, see
    ``core.accounting``) on every design at the given ``bits`` / ``unit_n``
    and ranks them.  Callers that already priced the workload (serve's cost
    table) pass ``costs`` — ``{design: ModelCost}`` — to skip the
    re-pricing; ``calls``/``bits``/``unit_n`` are then unused.  Returns
    ``{objective: {"best": design, "ranking": [(design, value), ...]}}`` for
    the four serving objectives — ``dyn_energy_uj``, ``wc_energy_uj`` (uJ)
    and ``dyn_latency_us``, ``wc_latency_us`` (us); lower is better,
    rankings ascending.
    """
    if costs is None:
        from repro_torch import backends
        costs = {d: backends.resolve(d, bits=bits)
                 .price(calls, unit_n=unit_n, num_units=num_units)
                 for d in designs}
    out: dict[str, dict] = {}
    for objective in ("dyn_energy_uj", "wc_energy_uj",
                      "dyn_latency_us", "wc_latency_us"):
        ranking = sorted(((d, getattr(c, objective))
                          for d, c in costs.items()), key=lambda t: t[1])
        out[objective] = {"best": ranking[0][0], "ranking": ranking}
    return out
