"""Stream-faithful stochastic uGEMM: rate-coded bitstream compute.

The paper's uGEMM hardware is stochastic: operands become rate-coded
bitstreams, a multiply is a per-cycle AND/XNOR gate, and accuracy is bought
with stream length.  ``core.gemm_sims.ugemm_exact`` idealizes that to
closed-form slot counts; this package keeps the bitstreams, so *stream
length* joins bit-width as a plannable accuracy/energy knob.

Modules
-------
``gen``
    Bitstream generation (UnarySim's RNG / SourceGen / BSGen split):
    seeded Sobol and LFSR integer sequences (numpy, copied from the
    reference), threshold pre-scaling, unipolar + bipolar formats, and
    per-cycle loop references tested bit-identical to the vectorized forms.
``sgemm``
    The rate-coded GEMM engine (``stochastic_gemm``) with UnaryLinear
    scaled accumulation, and the pure ``DesignSpec`` factory behind
    ``repro_torch.backends.resolve("ugemm_stochastic", bits=...,
    stream_len=...)``.
``error``
    Measured per-site RMSE-vs-exact-uGEMM curves over stream length — the
    planner's stream-length accuracy statistic.
"""

from repro_torch.stochastic import error, gen, sgemm
from repro_torch.stochastic.sgemm import (STOCHASTIC_DESIGN, default_stream_len,
                                          stochastic_design_spec,
                                          stochastic_gemm)

__all__ = [
    "gen", "sgemm", "error",
    "STOCHASTIC_DESIGN", "default_stream_len", "stochastic_design_spec",
    "stochastic_gemm",
]
