"""fused_decode_roofline: the fused paged decode attention's share of its
roofline in the traced trace (``kernels/paged_attention_fused.py`` ->
``csrc/fused_paged_decode.cu``).

A decode step reads, at every layer, each active slot's keys and values over
its real context (the positions written so far, the step's own included) and
its query, and writes its output, all in float32; the least time is those
bytes over the HBM peak.  The share is the sum over the traced trace's decode
steps over the device time of the kernels named here.
"""

from bench import peaks

KERNELS = (("fused_decode_split_kernel<",),)


def step_bytes(sizes: dict, contexts: list) -> float:
    hd, h, kvh = sizes["head_dim"], sizes["num_heads"], sizes["num_kv_heads"]
    per_layer = sum(2 * c * kvh * hd * 4 + 2 * h * hd * 4 for c in contexts)
    return float(sizes["num_layers"] * per_layer)


def least_seconds(run) -> float:
    hbm = peaks.peak(run.device_kind, "hbm_bytes")
    total = 0.0
    for rows in run.traced.decode_slots().values():
        # a slot fed the token at position p attends over p + 1 positions
        total += step_bytes(run.sizes, [pos + 1 for _, _, pos in rows]) / hbm
    return total


def read(run):
    if run.trace is None:
        return None
    spent = run.trace.kernel_seconds(KERNELS)
    if spent <= 0:
        return None
    return 100.0 * least_seconds(run) / spent
