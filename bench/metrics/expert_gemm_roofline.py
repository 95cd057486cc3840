"""expert_gemm_roofline: the routed experts' GEMMs' share of their roofline
in the traced trace, on the rank that reads the metrics.

The work is each local expert's ``w_gate``, ``w_up`` and ``w_down``
(``models/moe.py:moe_serve`` -> ``models/common.py:dense`` ->
``kernels/unary_gemm.py:tub_gemm``) at the rows routed to it.  The engine
counts them on the device, by phase (decode, prefill), layer and local
expert: the routed rows and the calls with a routed row
(``ServingEngine.expert_rows``, kept for the traced trace by the family's
``routed_rows``).  A call of ``r`` routed rows at a (K, N) site needs
``2 K N r`` operations and moves the weight codes and the rows' codes at
the cell's bits plus the int32 output (``tub_gemm_roofline.call_seconds``).
The least time of an expert's calls in one phase is the larger of their
operations over the int8 peak and their bytes over the HBM peak (no more
than the sum of each call's, so the share is a floor); padding rows and
calls with no routed row count nothing.  The share is the least time over
the device time of the unary GEMM kernels launched inside the port's
``moe.experts`` spans.  A decode step replayed from a CUDA graph launches
its kernels inside ``engine.decode.replay``, not ``moe.experts``: where
the trace holds a replay, the decode phase's count is left out with its
kernels.  None where the trace holds no such span or the family keeps no
count.
"""

from bench import peaks, spantrace

spantrace.install()

KERNELS = (("unary_mma_kernel<", "TubPulses"),)


def least_seconds(counts, gemms, bits: int, kind: str) -> float:
    """The floor of the time the expert GEMMs ``counts`` describes need:
    ``counts`` [phase][layer][expert] = (routed rows, calls with a routed
    row); ``gemms`` the (K, N) of an expert's sites."""
    int8, hbm = peaks.peak(kind, "int8_ops"), peaks.peak(kind, "hbm_bytes")
    total = 0.0
    for phase in counts:
        for layer in phase:
            for rows, calls in layer:
                for k, n in gemms:
                    ops = 2.0 * k * n * rows
                    nbytes = (calls * k * n + rows * k) * bits / 8.0 \
                        + rows * n * 4.0
                    total += max(ops / int8, nbytes / hbm)
    return total


def read(run):
    routed = getattr(run.family, "routed_rows", None)
    counts = routed(run.traced) if routed and run.traced else None
    under = spantrace.launched_under(run, {"moe.experts"})
    if counts is None or under is None:
        return None
    spent = sum(b - a for (name, a, b), i in zip(run.trace.ops, under)
                if i >= 0 and any(all(p in name for p in pat)
                                  for pat in KERNELS)) * 1e-9
    if spent <= 0:
        return None
    program = spantrace.program_of(run)
    if any(s[0] == "engine.decode.replay" for s in program):
        counts = counts[1:]                 # the prefill phase alone
    return 100.0 * least_seconds(counts, run.family.expert_gemms(run.sizes),
                                 run.bits, run.device_kind) / spent
