"""tub_gemm_roofline: the unary GEMM kernel's share of its roofline in
the traced trace.

The work is every dense site's contraction (``models/common.py:
_backend_matmul`` -> ``kernels/unary_gemm.py:tub_gemm`` ->
``csrc/unary_gemm.cu``) at the rows serving needs: a prefill call's prompt
tokens (not the padding of its width) at the layers' sites and each prompt's
last row at the head, since only that row's logits give a token; a decode
step's active slots at every site.  The cell's family module gives the
(K, N) of each GEMM a call contracts on the traced rank
(``gemm_calls``: under an engine grid, that rank's shards).  A call of
``rows`` rows at a (K, N) site needs ``2 K N rows`` operations and moves the
weight codes and the activation codes at the cell's bits plus the int32
output; its least time is the larger of operations over the int8 peak and
bytes over the HBM peak.  The share is the sum of the calls' least times
over the device time of the kernels named here.
"""

from bench import peaks

KERNELS = (("unary_mma_kernel<", "TubPulses"),)


def call_seconds(k: int, n: int, rows: int, bits: int, kind: str) -> float:
    ops = 2.0 * k * n * rows
    nbytes = (k * n + rows * k) * bits / 8.0 + rows * n * 4.0
    return max(ops / peaks.peak(kind, "int8_ops"),
               nbytes / peaks.peak(kind, "hbm_bytes"))


def least_seconds(run) -> float:
    sizes, bits, kind = run.sizes, run.bits, run.device_kind
    total = 0.0
    rec = run.traced
    # (rows at the layers' sites, rows at the head) of every call
    calls = [(sum(lens), len(lens)) for groups in rec.prefill_groups().values()
             for _, lens in groups]
    calls += [(len(rows), len(rows)) for rows in rec.decode_slots().values()]
    for rows, head_rows in calls:
        for times, gemms in run.family.gemm_calls(
                sizes, run.engine, rows, head_rows, rank=run.rank,
                world=run.chips):
            total += times * sum(call_seconds(k, n, r, bits, kind)
                                 for k, n, r in gemms)
    return total


def read(run):
    if run.trace is None:
        return None
    spent = run.trace.kernel_seconds(KERNELS)
    if spent <= 0:
        return None
    return 100.0 * least_seconds(run) / spent
