"""The readers of the port's spans against hand counts, on a hand-built run:
program spans on the profiler's clock beside device operations, each placed
by its host-side launch; and the idle gaps named after the program's spans.
"""

import numpy as np
import pytest

from bench import devtrace, manifest, serve, spantrace, traffic

H100 = "NVIDIA H100 80GB HBM3"

#: (name, t0, t1, parent, req) on the profiler's clock, in order of entry:
#: a decode-only step, a step that decodes and admits request 7 (waiting
#: since 40 ns) and 8 (since 100 ns), another decode-only step
PROGRAM = [
    ("engine.step", 0, 100, -1, -1),             # 0
    ("engine.decode", 0, 60, 0, -1),             # 1
    ("layer.attn", 5, 30, 1, -1),                # 2
    ("dense", 5, 25, 2, -1),                     # 3
    ("dense.quantize", 6, 10, 3, -1),            # 4
    ("dense.gemm", 10, 15, 3, -1),               # 5
    ("dense.dequantize", 15, 20, 3, -1),         # 6
    ("engine.decode.sync", 60, 80, 0, -1),       # 7
    ("engine.decode.bookkeep", 80, 85, 0, -1),   # 8
    ("engine.schedule", 85, 90, 0, -1),          # 9
    ("engine.step", 100, 200, -1, -1),           # 10
    ("engine.decode", 100, 130, 10, -1),         # 11
    ("engine.decode.sync", 130, 150, 10, -1),    # 12
    ("engine.schedule", 150, 155, 10, -1),       # 13
    ("engine.queue", 40, 156, -1, 7),            # 14
    ("engine.queue", 100, 156, -1, 8),           # 15
    ("engine.prefill", 156, 190, 10, -1),        # 16
    ("dense", 160, 180, 16, -1),                 # 17
    ("dense.quantize", 161, 165, 17, -1),        # 18
    ("dense.gemm", 165, 170, 17, -1),            # 19
    ("dense.dequantize", 170, 175, 17, -1),      # 20
    ("engine.admit", 190, 195, 10, 7),           # 21
    ("engine.admit", 195, 198, 10, 8),           # 22
    ("engine.step", 200, 300, -1, -1),           # 23
    ("engine.decode", 200, 240, 23, -1),         # 24
    ("engine.decode.sync", 240, 270, 23, -1),    # 25
]

#: (device op, its launch on the host): the step-0 site's quantize, GEMM
#: and dequantize, an attention kernel, a kernel of the decode's own, the
#: tokens' copy; the prefill's quantize and GEMM and a kernel outside the
#: sites; step 23's two kernels; one operation with no launch found
OPS = [
    (("q", 20, 24), 7), (("gemm", 24, 34), 12), (("dq", 34, 36), 16),
    (("attn", 36, 40), 27), (("argmax", 40, 45), 50),
    (("memcpy", 62, 63), 65),
    (("q", 162, 170), 162), (("gemm", 170, 190), 166),
    (("embed", 190, 192), 185),
    (("k1", 215, 218), 210), (("k2", 225, 230), 220),
    (("lost", 290, 295), None),
]

NEW = ["decode_issue_ms.serve", "decode_sync_ms.serve",
       "decode_launches.serve", "dense_quant_pct.serve",
       "queue_wait_p90_ms.serve"]


def _view(trace):
    reqs = (traffic.Request(0, 0, 30, 2),)
    rec = serve.TraceRecord(index=1, requests=reqs)
    return serve.RunView(setup_s=1.0, window=serve.Window([rec]), sizes={},
                         bits=4, device_kind=H100, trace=trace, traced=rec)


def _trace(launches=True, program=PROGRAM):
    return spantrace.SpannedTrace(
        ops=[op for op, _ in OPS], t0=0, t1=300, program=list(program),
        launched=[t if launches else None for _, t in OPS])


def _read(name, trace):
    return manifest.reader(name).read(_view(trace))


def test_decode_only_steps_leave_out_a_step_that_prefilled():
    assert spantrace.decode_only_steps(PROGRAM) == [(0, 1, 7), (23, 24, 25)]


# (metric, hand count): decode 60 and 40 ns; sync 20 and 30 ns; 5 and 2
# operations launched inside the two decode spans (the copy launched in
# the sync is not); dense device time 4 + 10 + 2 + 8 + 20 = 44 ns of which
# quantize and dequantize 4 + 2 + 8 = 14; waits 116 and 56 ns
HAND = {
    "decode_issue_ms.serve": 50e-6,
    "decode_sync_ms.serve": 25e-6,
    "decode_launches.serve": 3.5,
    "dense_quant_pct.serve": 100.0 * 14 / 44,
    "queue_wait_p90_ms.serve": float(np.percentile([116, 56], 90)) * 1e-6,
}


@pytest.mark.parametrize("name", NEW)
def test_reader_against_hand_count(name):
    assert _read(name, _trace()) == pytest.approx(HAND[name])


@pytest.mark.parametrize("name", NEW)
def test_reader_without_launch_events(name):
    got = _read(name, _trace(launches=False))
    if name in ("decode_launches.serve", "dense_quant_pct.serve"):
        assert got is None
    else:
        # the host's spans need no launch
        assert got == pytest.approx(HAND[name])


@pytest.mark.parametrize("name", NEW)
def test_reader_of_a_port_without_spans(name):
    plain = devtrace.DeviceTrace(ops=[op for op, _ in OPS], t0=0, t1=300)
    assert _read(name, plain) is None
    assert _read(name, _trace(program=[])) is None
    assert _read(name, None) is None


def test_innermost_span_of_each_launch():
    got = spantrace.innermost(PROGRAM, [t for _, t in OPS])
    # a launch at 65 lies in the sync; at 185 in the prefill outside its
    # site; the wait spans (engine.queue) hold none
    assert got == [4, 5, 6, 2, 1, 7, 18, 19, 16, 24, 24, -1]


def test_idle_gaps_named_after_program_spans_keep_the_idle_total():
    ops = [("a", 2, 5), ("b", 10, 20), ("c", 50, 60)]
    program = [("A", 0, 40, -1, -1), ("B", 5, 15, 0, -1),
               ("engine.queue", 0, 100, -1, 3)]
    harness = [(0, 100, "decode")]
    spanned = spantrace.SpannedTrace(ops=ops, t0=0, t1=100, spans=harness,
                                     program=program)
    plain = devtrace.DeviceTrace(ops=ops, t0=0, t1=100, spans=harness)
    idle = dict(spanned.idle_by_span())
    # gaps [0, 2) in A, [5, 10) in B, [20, 50) in A, [60, 100) outside
    # every program span: the harness's name
    assert idle == pytest.approx({"A": 32e-9, "B": 5e-9, "decode": 40e-9})
    assert sum(idle.values()) == pytest.approx(
        sum(v for _, v in plain.idle_by_span()))
    assert sum(idle.values()) == pytest.approx(
        spanned.window_s - spanned.busy_s)


def test_readers_put_the_spanned_profiler_in_place():
    manifest.reader("decode_launches.serve")
    assert devtrace.profiled is spantrace.profiled


def test_self_time_lines_count_spans_and_their_launches(capsys):
    from repro_torch.runtime.spans import Span, self_times
    own = self_times([Span(*s) for s in PROGRAM])
    # engine.decode 0-60 less layer.attn 5-30; 100-130; 200-240
    assert own["engine.decode"] == 35 + 30 + 40
    spantrace.print_self_times(_trace(), own)
    err = capsys.readouterr().err
    assert ("program span dense.gemm: 2 spans, self 0.000 ms, 2 operations "
            "launched, 0.000 device ms") in err
    assert ("program span (none): 1 operations launched outside every "
            "span") in err
