"""dense_quant_pct.serve: the device time of the operations launched inside
the dense sites' ``dense.quantize`` (the activation's quantize) and
``dense.dequantize`` (the two scale multiplies and the cast) spans, as a
share of the device time of every operation launched inside a ``dense``
span (``models/common.py:_backend_matmul``; the GEMM kernel included), over
the traced trace, prefill and decode.

Operations are placed by their host-side launch events, as in
``decode_launches.serve``.  None where the port records no spans or the
profiler recorded no launch events.
"""

from bench import spantrace

spantrace.install()

PARTS = ("dense.quantize", "dense.dequantize")


def read(run):
    under = spantrace.launched_under(run, {"dense", *PARTS})
    if under is None:
        return None
    program = spantrace.program_of(run)
    parts = whole = 0
    for (_, a, b), i in zip(run.trace.ops, under):
        if i >= 0:
            whole += b - a
            if program[i][0] in PARTS:
                parts += b - a
    return 100.0 * parts / whole if whole else None
