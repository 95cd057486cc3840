"""The metric readers' operation and byte counts against hand counts."""

import pytest

from bench import manifest, serve, traffic

PHI3 = {"d_model": 3072, "d_ff": 8192, "num_layers": 32, "num_heads": 32,
        "num_kv_heads": 32, "head_dim": 96, "vocab_size": 32064,
        "rope_theta": 1e4, "rms_eps": 1e-5}
H100 = "NVIDIA H100 80GB HBM3"


def _record(index: int = 0, slow: float = 1.0):
    """One trace: two prompts (300 and 500 tokens, one prefill call of width
    512) admitted at step 0, one output of 3 tokens and one of 2; every
    time ``slow`` times longer."""
    reqs = (traffic.Request(0, 0, 300, 3), traffic.Request(1, 0, 500, 2))
    rec = serve.TraceRecord(index=index, requests=reqs, t_call=0.0,
                            t_return=4.0 * slow)
    rec.start = {0: 0.0, 1: 1.0 * slow, 2: 2.0 * slow}
    rec.dec_end = {1: 1.5 * slow, 2: 2.5 * slow}
    rec.admitted = {0: [0, 1]}
    rec.events = ((0, "admit", 0), (0, "admit", 1), (1, "evict", 1),
                  (2, "evict", 0))
    rec.tokens = {0: [5, 6, 7], 1: [8, 9]}
    return rec


def _view(trace=None):
    """Trace 0 untraced, trace 1 under the profiler and twice as slow."""
    window = serve.Window([_record(0), _record(1, slow=2.0)])
    return serve.RunView(setup_s=1.0, window=window, sizes=PHI3, bits=4,
                         device_kind=H100, trace=trace,
                         traced=window.traces[1])


def test_tub_call_at_a_prefill_and_a_decode_shape():
    tub = manifest.reader("tub_gemm_roofline")
    # prefill: K 3072, N 8192, 800 prompt rows -> compute bound
    ops = 2 * 3072 * 8192 * 800                        # 40,265,318,400
    assert tub.call_seconds(3072, 8192, 800, 4, H100) == pytest.approx(
        ops / 1979e12)
    # decode: 16 rows -> the weight codes bound it
    nbytes = (3072 * 8192 + 16 * 3072) * 0.5 + 16 * 8192 * 4  # 13,131,776
    assert tub.call_seconds(3072, 8192, 16, 4, H100) == pytest.approx(
        nbytes / 3.35e12)


def test_tub_least_time_of_a_trace():
    tub = manifest.reader("tub_gemm_roofline")
    view = _view()
    # calls: one prefill of 800 real rows, decode steps of 2 and 1 slots
    assert sorted(len(r) for r in view.traced.decode_slots().values()) == [1, 2]
    sites = [(3072, 3072)] * 4 + [(3072, 8192)] * 2 + [(8192, 3072)]
    want = 0.0
    # the head: each prompt's last row (2 in the prefill call), each slot
    for rows, head_rows in ((800, 2), (2, 2), (1, 1)):
        want += 32 * sum(tub.call_seconds(k, n, rows, 4, H100)
                         for k, n in sites)
        want += tub.call_seconds(3072, 32064, head_rows, 4, H100)
    assert tub.least_seconds(view) == pytest.approx(want)


def test_fused_decode_bytes():
    fused = manifest.reader("fused_decode_roofline")
    # per layer: K and V of 301 and 501 positions, 32 heads of 96, float32,
    # plus q and out of each slot
    per_layer = 2 * (301 + 501) * 32 * 96 * 4 + 2 * 2 * 32 * 96 * 4
    assert fused.step_bytes(PHI3, [301, 501]) == 32 * per_layer
    view = _view()
    # step 1: req 0 fed position 300, req 1 position 500; step 2: req 0 at 301
    want = (fused.step_bytes(PHI3, [301, 501])
            + fused.step_bytes(PHI3, [302])) / 3.35e12
    assert fused.least_seconds(view) == pytest.approx(want)


def test_mfu_operations():
    mfu = manifest.reader("mfu.serve")
    params = 32 * (4 * 3072 * 3072 + 3 * 3072 * 8192)
    assert mfu.layer_params(PHI3) == params
    assert mfu.token_ops(PHI3, 0) == 2 * params + 32 * 4 * 32 * 96
    assert mfu.head_ops(PHI3) == 2 * 3072 * 32064
    view = _view()
    # positions 0..301 of request 0, 0..500 of request 1 through the
    # layers; the head once for each of the 5 served tokens
    want = (sum(mfu.token_ops(PHI3, p) for p in range(302))
            + sum(mfu.token_ops(PHI3, p) for p in range(501))
            + 5 * 2 * 3072 * 32064)
    assert mfu.window_ops(view.untraced, PHI3) == pytest.approx(want)
    # over the untraced trace's 4 s; the profiled trace's 8 s left out
    assert mfu.read(view) == pytest.approx(100 * want / 4.0 / 1979e12)


def test_host_clock_metrics_of_a_trace():
    view = _view()
    w = serve.Window(view.window.traces[:1])
    assert w.tokens() == 5
    # the end-to-end rate: every trace, the profiled one too (12 s)
    assert manifest.reader("tokens_per_s").read(view) == pytest.approx(
        10 / 12.0)
    # first tokens at the start of step 1, both arrived at step 0
    assert sorted(w.ttft()) == [1.0, 1.0]
    # req 0: tokens at 1.0, 1.5, 2.5; req 1: 1.0, 1.5
    assert sorted(w.itl()) == [0.5, 0.5, 1.0]
    # steps 1 and 2 decoded and admitted nothing: 1.0 and 2.0 s long
    assert sorted(w.decode_only_steps()) == [1.0, 2.0]
    # the per-layer step wall leaves the profiled trace (2.0 and 4.0) out
    assert manifest.reader("decode_step_ms.serve").read(view) == 1500.0
    assert manifest.reader("device_idle_pct.serve").read(view) is None


def test_device_trace_reduction():
    from bench import devtrace
    tr = devtrace.DeviceTrace(
        ops=[("void (anonymous namespace)::unary_mma_kernel<(anonymous namespace)::TubPulses, 4>(int)", 10, 30),
             ("fused_decode_split_kernel<float>", 20, 40),
             ("memcpy", 60, 70)], t0=0, t1=100,
        spans=[(0, 50, "decode"), (50, 100, "admission"),
               (55, 65, "prefill")])
    assert tr.busy_s == pytest.approx(40e-9)
    assert tr.window_s == pytest.approx(100e-9)
    assert tr.kernel_seconds((("unary_mma_kernel<", "TubPulses"),)) == pytest.approx(20e-9)
    idle = dict(tr.idle_by_span())
    # gaps: [0, 10) in decode, [40, 60) starts in decode, [70, 100) admission
    assert idle == pytest.approx({"decode": 30e-9, "admission": 30e-9})
    assert tr.top_ops()[0][0] == "unary_mma_kernel<TubPulses, 4>"
