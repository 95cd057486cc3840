"""The port's host spans (``repro_torch.runtime.spans``): the recorder on its
own, and what ``ServingEngine.run`` records at smoke size on the CPU.

Contracts: off, nothing is recorded and :func:`spans.span` hands out one
shared do-nothing context; on, a run records one ``engine.step`` a step, one
``engine.decode``, ``engine.decode.sync`` and ``engine.decode.bookkeep`` a
decode step, ``layer.attn`` (with ``attn.kv_write`` and ``attn.attend``)
and ``layer.mlp`` a layer of each decode step, one ``dense`` with exactly
``dense.quantize``, ``dense.gemm`` and ``dense.dequantize`` under it at each
contracted site (seven a layer and the head, in prefill and decode), one
``engine.prefill`` a prefill call and one ``engine.queue`` and
``engine.admit`` a request with its id; every child lies inside its parent;
and the served tokens and events are the same with the recorder on and off.
"""

import pytest
import torch

from repro_torch import configs
from repro_torch.models import model as model_lib
from repro_torch.models.common import activation_scaling
from repro_torch.runtime import spans
from repro_torch.serving import ServingEngine, TrafficConfig, generate_trace

ENGINES = {
    "tub_fused": dict(backend="tubgemm_cuda", attention="fused"),
    "tub_gather_solo": dict(backend="tubgemm", attention="gather",
                            batched_prefill=False),
    "float": dict(backend=None, attention="fused"),
}


@pytest.fixture(scope="module")
def model():
    cfg = configs.get_smoke_config("llama3-8b").replace(
        compute_dtype="float32")
    gen = torch.Generator().manual_seed(0)
    return cfg, model_lib.init_params(cfg, gen, device="cpu")


@pytest.fixture(scope="module", params=list(ENGINES))
def served(request, model):
    """(engine kind, cfg, trace, report off, report on, records)."""
    cfg, params = model
    trace = generate_trace(TrafficConfig(num_requests=5, arrival_rate=1.5,
                                         seed=4))
    eng = ServingEngine(cfg, params, bits=4, max_batch=3, max_seq_len=64,
                        device="cpu", **ENGINES[request.param])
    spans.take()
    with activation_scaling("per-row"):
        off = eng.run(trace)
        left = spans.take()
        with spans.recording():
            on = eng.run(trace)
    records = spans.take()
    return request.param, cfg, trace, off, on, left, records


def _named(records, name):
    return [s for s in records if s.name == name]


CHECKS = ["off_records_nothing", "same_tokens_and_events", "steps", "decode",
          "layers", "dense", "prefill", "requests", "nesting", "queue"]


@pytest.mark.parametrize("check", CHECKS)
def test_engine_spans(served, check):
    kind, cfg, trace, off, on, left, rec = served
    assert rec, "nothing recorded with the recorder on"
    calls = on.decode_steps + on.prefill_calls
    if check == "off_records_nothing":
        assert left == []
    elif check == "same_tokens_and_events":
        assert on.request_tokens == off.request_tokens
        assert on.events == off.events and on.steps == off.steps
    elif check == "steps":
        assert len(_named(rec, "engine.step")) == on.steps
        assert len(_named(rec, "engine.schedule")) == on.steps
        assert all(s.parent == -1 for s in _named(rec, "engine.step"))
    elif check == "decode":
        for name in ("engine.decode", "engine.decode.sync",
                     "engine.decode.bookkeep"):
            got = _named(rec, name)
            assert len(got) == on.decode_steps
            assert all(rec[s.parent].name == "engine.step" for s in got)
    elif check == "layers":
        n = cfg.num_layers * on.decode_steps
        for name, parent in (("layer.attn", "engine.decode"),
                             ("layer.mlp", "engine.decode"),
                             ("attn.kv_write", "layer.attn"),
                             ("attn.attend", "layer.attn")):
            got = _named(rec, name)
            assert len(got) == n, name
            assert {rec[s.parent].name for s in got} == {parent}
    elif check == "dense":
        dense = [i for i, s in enumerate(rec) if s.name == "dense"]
        sites = 0 if kind == "float" else 7 * cfg.num_layers + 1
        assert len(dense) == sites * calls
        for i in dense:
            kids = [s.name for s in rec if s.parent == i]
            assert kids == ["dense.quantize", "dense.gemm", "dense.dequantize"]
        assert len(_named(rec, "dense.gemm")) == len(dense)
    elif check == "prefill":
        got = _named(rec, "engine.prefill")
        assert len(got) == on.prefill_calls
        assert {rec[s.parent].name for s in got} == {"engine.step"}
        if kind != "float":
            # the prompt's sites run under each prefill call
            under = [s for s in _named(rec, "dense")
                     if rec[s.parent].name == "engine.prefill"]
            assert len(under) == (7 * cfg.num_layers + 1) * on.prefill_calls
    elif check == "requests":
        ids = sorted(r.req_id for r in trace)
        for name in ("engine.queue", "engine.admit"):
            assert sorted(s.req for s in _named(rec, name)) == ids, name
        assert {s.req for s in rec if s.name not in (
            "engine.queue", "engine.admit")} == {-1}
    elif check == "nesting":
        for i, s in enumerate(rec):
            assert s.t0 <= s.t1
            if s.parent >= 0:
                p = rec[s.parent]
                assert s.parent < i
                assert p.t0 <= s.t0 and s.t1 <= p.t1, (s, p)
    elif check == "queue":
        steps = _named(rec, "engine.step")
        arrival = {r.req_id: r.arrival_step for r in trace}
        prefills = [(i, s) for i, s in enumerate(rec)
                    if s.name == "engine.prefill"]
        for i, q in ((i, s) for i, s in enumerate(rec)
                     if s.name == "engine.queue"):
            assert q.parent == -1
            # from the start of the arrival step to the start of the
            # prefill call recorded next
            assert q.t0 == steps[arrival[q.req]].t0
            nxt = next(s for j, s in prefills if j > i)
            assert q.t1 <= nxt.t0


def test_off_hands_out_one_shared_context():
    assert spans.span("a") is spans.span("b", req=3)
    with spans.span("a") as t0:
        assert t0 is None
    assert spans.take() == []
    with spans.recording():
        with spans.span("a") as t0:
            pass
    (rec,) = spans.take()
    assert rec.t0 == t0 and rec.t1 >= t0


@pytest.mark.parametrize("raise_inside", [False, True])
def test_recorder_nests_and_clears(raise_inside):
    with spans.recording():
        with spans.span("outer", req=5):
            with spans.span("inner"):
                pass
            try:
                with spans.span("second"):
                    if raise_inside:
                        raise KeyError("x")
            except KeyError:
                pass
        with spans.span("late", start=1):
            pass
    # recording is off again after the block
    with spans.span("after"):
        pass
    rec = spans.take()
    assert [(s.name, s.parent, s.req) for s in rec] == [
        ("outer", -1, 5), ("inner", 0, -1), ("second", 0, -1),
        ("late", -1, -1)]
    assert rec[3].t0 == 1 and rec[3].t1 > rec[0].t1
    assert spans.take() == []
    own = spans.self_times(rec)
    assert own["outer"] == (rec[0].t1 - rec[0].t0) - sum(
        s.t1 - s.t0 for s in rec[1:3])
    assert own["late"] == rec[3].t1 - 1


PLAN = (__import__("pathlib").Path(__file__).resolve().parents[1] / "examples"
        / "plans" / "llama3_8b_smoke.plan.json")


@pytest.mark.parametrize("scope", ["backend", "plan"])
def test_engine_scope_keeps_no_calls(model, scope):
    # nothing reads the sites the engine contracts; other scopes keep them
    from repro_torch import backends
    cfg, params = model
    kw = dict(backend="tubgemm") if scope == "backend" else dict(plan=PLAN)
    eng = ServingEngine(cfg, params, bits=4, max_batch=2, max_seq_len=32,
                        device="cpu", **kw)
    seen = []
    eng.on_gemm_output = lambda site, out: seen.append(site)
    tokens = torch.zeros((1, 8), dtype=torch.int32)
    with eng._scope() as ex, activation_scaling("per-row"):
        eng._prefill(tokens)
    assert ex.calls is None and seen
    with backends.use_backend("tubgemm", bits=4) as own:
        eng._prefill(tokens)
    assert [c.site for c in own.calls] == seen
