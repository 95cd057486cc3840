"""The paper's own experimental grid: GEMM designs x bit-widths x array sizes.

This is the configuration the benchmark harness sweeps to regenerate
Tables I-IV and Figures 2-3 (the paper has no model architecture of its own).
"""

import dataclasses

ARCH_ID = "paper-gemm"

DESIGNS = ("ugemm", "tugemm", "tubgemm", "bgemm")
BITS = (2, 4, 8)
SIZES = (16, 32)
TPU_SIZES = (64, 128)           # Table IV: EdgeTPU, CloudTPUv3 (4-bit only)
TPU_BITS = 4
CLOCK_MHZ = 400


@dataclasses.dataclass(frozen=True)
class SweepCell:
    design: str
    bits: int
    n: int


def table_grid() -> list[SweepCell]:
    return [SweepCell(d, b, n) for b in BITS for n in SIZES for d in DESIGNS]


def tpu_grid() -> list[SweepCell]:
    return [SweepCell(d, TPU_BITS, n) for n in TPU_SIZES for d in DESIGNS]
