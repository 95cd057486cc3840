"""The traffic generator: the same work for every seed and trace, in
another order; the warm-up meets every prefill width of the cell."""

import json

import pytest

from bench import manifest, traffic


@pytest.mark.parametrize("cell", ["phi3-mini-3.8b.docqa",
                                  "internlm2-1.8b.longdoc"])
def test_every_trace_asks_for_the_same_work(cell):
    tr = json.loads((manifest.BENCH / "workloads" / f"{cell}.json")
                    .read_text())["traffic"]
    a = traffic.generate(tr, 0)
    b = traffic.generate(tr, 3)
    assert a == traffic.generate(tr, 0)
    assert a != b
    for attr in ("prompt_len", "output_len"):
        assert sorted(getattr(r, attr) for r in a) == \
            sorted(getattr(r, attr) for r in b)
    lo, hi = tr["prompt"]
    assert all(lo <= r.prompt_len <= hi for r in a)
    assert len({r.req_id for r in a + b}) == 2 * tr["requests"]
    # the same gaps: the last arrival lies within one step across traces
    assert abs(a[-1].arrival_step - b[-1].arrival_step) <= 1
    assert a[0].arrival_step == 0


def test_warmup_meets_each_prefill_width():
    tr = {"requests": 8, "rate": 1.0, "prompt": [512, 2015], "output": [8, 32]}
    assert traffic.buckets(tr) == [512, 1024, 2048]
    w = traffic.warmup_trace(tr, 100)
    assert [r.prompt_len for r in w] == [512, 1024, 2015]
    assert len({r.arrival_step for r in w}) == 3
