"""Published peaks of the cards the benchmark runs on.

NVIDIA's data sheet, H100 SXM, dense rates (no structured sparsity), at the
card's full power limit of 700 W: a card set below it reaches less, so every
share of these peaks is reported with the card's name, and PERF.md gives
the power limit the runs read.
"""

from __future__ import annotations

__all__ = ["PEAKS", "peak"]

PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "int8_ops": 1979e12,        # int8 tensor-core operations a second
        "bf16_flops": 989e12,
        "fp32_flops": 67e12,        # outside the tensor cores
        "hbm_bytes": 3.35e12,       # HBM3 bytes a second
        "nvlink_bytes": 450e9,      # one direction
    },
}


def peak(kind: str, what: str) -> float:
    """The peak ``what`` of the card ``kind`` (its ``get_device_name()``)."""
    try:
        return PEAKS[kind][what]
    except KeyError:
        raise KeyError(f"no published peak {what!r} for {kind!r}") from None
