"""The serving engine's captured decode step, on the CPU.

A CUDA graph needs a card (``tests/test_torch_gpu.py`` replays one against
the eager body); here: a CPU engine stays eager and hands its sites to
``on_gemm_output`` in the eager body's order; the key a graph replays under
changes with the pools, the batch, the parameters, the activation scaling
and the scope; the dispatch runs a new key eagerly, captures it at its
second step and never replays a graph over other buffers; a process group
keeps the step eager; a replay copies its inputs in and hands the host the
captured sites and records; a run takes over the previous run's pools; and
the benchmark's ``decode_replay_pct.serve`` reader counts the replayed
steps.
"""

import pytest
import torch

from repro_torch import backends, configs
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import model as model_lib
from repro_torch.models.common import activation_scaling
from repro_torch.serving import (PagedKVCache, ServingEngine, TrafficConfig,
                                 generate_trace)
from repro_torch.serving import engine as engine_lib

TRACE = generate_trace(TrafficConfig(num_requests=5, arrival_rate=0.7, seed=3))


@pytest.fixture(scope="module")
def model():
    cfg = configs.get_smoke_config("llama3-8b").replace(compute_dtype="float32")
    gen = torch.Generator(device="cpu")
    gen.manual_seed(0)
    return cfg, model_lib.init_params(cfg, gen, device="cpu")


def _engine(model, **kw):
    cfg, params = model
    kw = {"backend": "tubgemm", "bits": 4, "max_batch": 3, "page_size": 4,
          "max_seq_len": 48, "device": "cpu", **kw}
    return ServingEngine(cfg, params, **kw)


def _step_inputs(eng, batch=None, cache=None):
    """(tokens, block tables, lengths, active) of a step over ``cache``."""
    b = eng.max_batch if batch is None else batch
    cache = cache or eng.new_cache()
    tables = torch.zeros((b, cache.max_blocks), dtype=torch.int32)
    for i in range(b):
        cache.allocate(i, 9)
        tables[i] = torch.from_numpy(cache.block_table_row(i))
    tokens = torch.arange(1, b + 1, dtype=torch.int32)[:, None]
    lengths = torch.full((b,), 5, dtype=torch.int32)
    return cache, (tokens, tables, lengths, torch.ones((b,), dtype=torch.bool))


def test_cpu_engine_stays_eager_over_a_trace(model):
    eng = _engine(model)
    seen = []
    eng.on_gemm_output = lambda site, out: seen.append(site)
    with activation_scaling("per-row"):
        rep = eng.run(TRACE)
    assert rep.decode_steps > 3
    assert (rep.decode_eager, rep.decode_replays, rep.decode_captures) == (
        rep.decode_steps, 0, 0)
    assert eng._graph is None
    per_call = 7 * eng.cfg.num_layers + 1
    assert len(seen) == per_call * (rep.decode_steps + rep.prefill_calls)


@pytest.mark.parametrize("attention", ["fused", "gather"])
def test_cpu_decode_hands_sites_as_the_eager_body(model, attention):
    # _decode on the CPU is the eager body: the same logits, pools and
    # lengths, and on_output sees every site, layers in order, with the
    # body's int32 outputs
    eng = _engine(model, attention=attention)
    cfg = eng.cfg
    got = {}
    for name in ("_decode", "_decode_step"):
        cache, (tokens, tables, lengths, active) = _step_inputs(eng)
        outs = []
        with backends.use_backend("tubgemm", bits=4,
                                  on_output=lambda s, o: outs.append((s, o))), \
                activation_scaling("per-row"):
            lg, k_pool, v_pool, new = getattr(eng, name)(
                eng.params, tokens, cache.k_pool, cache.v_pool, tables,
                lengths, active)
        got[name] = (lg, k_pool, v_pool, new, outs)
    (lg, kp, vp, new, outs), (lg2, kp2, vp2, new2, outs2) = got.values()
    assert torch.equal(lg, lg2) and torch.equal(kp, kp2)
    assert torch.equal(vp, vp2) and torch.equal(new, new2)
    leaves = ["attn/wq", "attn/wk", "attn/wv", "attn/wo", "mlp/w_gate",
              "mlp/w_up", "mlp/w_down"]
    want = [f"layers/{leaf}" for _ in range(cfg.num_layers)
            for leaf in leaves] + ["lm_head"]
    assert sorted(s for s, _ in outs) == sorted(want)
    assert [s for s, _ in outs] == [s for s, _ in outs2]
    assert all(torch.equal(a, b) for (_, a), (_, b) in zip(outs, outs2))
    # the sites come layer by layer: layer i's seven before layer i + 1's
    order = [s for s, _ in outs]
    assert order[-1] == "lm_head"
    assert all(sorted(order[7 * i: 7 * i + 7]) == sorted(
        f"layers/{leaf}" for leaf in leaves) for i in range(cfg.num_layers))
    assert eng.decode_counts == {"eager": 1, "replays": 0, "captures": 0}


def test_graph_key_follows_what_the_graph_is_bound_to(model):
    eng = _engine(model)
    cache, inputs = _step_inputs(eng)
    key = engine_lib.ServingEngine._graph_key

    def k(params=None, pools=None, inp=None, execution=None):
        pools = pools or (cache.k_pool, cache.v_pool)
        return key(params or eng.params, *pools, inp or inputs, execution)

    base = k()
    # fresh inputs of the same shapes and dtypes: the same key (copied in)
    assert k(inp=tuple(t.clone() for t in inputs)) == base
    other, other_inputs = _step_inputs(eng)
    assert k(pools=(other.k_pool, other.v_pool)) != base
    assert k(pools=(cache.v_pool, cache.k_pool)) != base
    _, small = _step_inputs(eng, batch=2)
    assert k(inp=small) != base
    assert k(inp=(inputs[0], inputs[1], inputs[2].long(), inputs[3])) != base
    assert k(params=dict(eng.params)) != base
    with activation_scaling("per-row"):
        assert k() != base
    with backends.use_backend("tubgemm", bits=4) as ex4:
        assert k(execution=ex4) != base
    with backends.use_backend("tubgemm", bits=8) as ex8:
        assert k(execution=ex8) != k(execution=ex4)
    with backends.use_backend("tubgemm", bits=4) as again:
        assert k(execution=again) == k(execution=ex4)


class _Fake:
    """Stands in for the CUDA graph on the CPU: a capture keeps the key and
    a replay runs the eager body, after checking that the step's buffers
    are the ones the graph was captured on."""

    def __init__(self, eng):
        self.eng = eng
        self.replayed_on = []

    def capture(self, key, execution, params, k_pool, v_pool, inputs):
        eng = self.eng
        eng._graph = engine_lib._DecodeGraph(
            key=key, graph=None, inputs=tuple(t.clone() for t in inputs),
            outputs=(), sites=[], calls=[], held=(params,))
        eng.decode_counts["captures"] += 1
        return eng._graph

    def replay(self, graph, execution, k_pool, v_pool, inputs):
        eng = self.eng
        assert graph is eng._graph
        assert graph.key == eng._graph_key(graph.held[0], k_pool, v_pool,
                                           inputs, execution)
        self.replayed_on.append((k_pool.data_ptr(), inputs[0].shape[0]))
        eng.decode_counts["replays"] += 1
        return eng._decode_step(graph.held[0], inputs[0], k_pool, v_pool,
                                *inputs[1:])


def test_dispatch_warms_captures_replays_and_recaptures(model, monkeypatch):
    eng = _engine(model, backend=None)
    fake = _Fake(eng)
    monkeypatch.setattr(eng, "_capturable", lambda device: True)
    monkeypatch.setattr(eng, "_capture", fake.capture)
    monkeypatch.setattr(eng, "_replay", fake.replay)
    cache, inputs = _step_inputs(eng)
    other, other_inputs = _step_inputs(eng)
    _, small = _step_inputs(eng, batch=2, cache=eng.new_cache())

    def step(c, inp):
        before = dict(eng.decode_counts)
        eng._decode(eng.params, inp[0], c.k_pool, c.v_pool, *inp[1:])
        return next(k for k in before if eng.decode_counts[k] != before[k])

    assert step(cache, inputs) == "eager"
    assert eng.decode_counts["captures"] == 0
    assert step(cache, inputs) == "replays"          # captured, then replayed
    assert eng.decode_counts["captures"] == 1
    assert step(cache, tuple(t.clone() for t in inputs)) == "replays"
    # other pools: a new key runs eagerly first, never the old graph
    assert step(other, other_inputs) == "eager"
    assert step(other, other_inputs) == "replays"
    assert eng.decode_counts["captures"] == 2
    # another batch: the same
    assert step(other, small) == "eager"
    assert step(other, small) == "replays"
    assert eng.decode_counts == {"eager": 3, "replays": 4, "captures": 3}
    mine, theirs = cache.k_pool.data_ptr(), other.k_pool.data_ptr()
    assert fake.replayed_on == [(mine, 3), (mine, 3), (theirs, 3), (theirs, 2)]


def test_dispatch_stays_eager_under_a_process_group(model, monkeypatch):
    # a grid engine's mesh, or a grid plan's backends, reduce with
    # collectives under a process group: never captured
    eng = _engine(model)
    monkeypatch.setattr(engine_lib.ServingEngine, "_capture", _refuse)
    monkeypatch.setattr(engine_lib.ServingEngine, "_replay", _refuse)
    real = engine_lib.ServingEngine._capturable
    cuda = torch.device("cuda", 0)
    # the CPU pools stand for a card's: only the process group decides
    monkeypatch.setattr(engine_lib.ServingEngine, "_capturable",
                        staticmethod(lambda device: real(cuda)))
    cache, inputs = _step_inputs(eng)

    def step():
        with backends.use_backend("tubgemm", bits=4):
            eng._decode(eng.params, inputs[0], cache.k_pool, cache.v_pool,
                        *inputs[1:])

    monkeypatch.setattr(mesh_lib, "distributed", lambda: True)
    for _ in range(3):
        step()
    assert eng.decode_counts == {"eager": 3, "replays": 0, "captures": 0}
    # without one the same steps go on to the graph
    monkeypatch.setattr(mesh_lib, "distributed", lambda: False)
    step()
    with pytest.raises(AssertionError, match="reached the graph"):
        step()


def _refuse(*_args, **_kw):
    raise AssertionError("an uncapturable step reached the graph")


def test_eligibility_reads_the_device_and_the_process_group(monkeypatch):
    cuda, cpu = torch.device("cuda", 0), torch.device("cpu")
    capturable = engine_lib.ServingEngine._capturable
    assert capturable(cuda) and not capturable(cpu)
    monkeypatch.setattr(mesh_lib, "distributed", lambda: True)
    assert not capturable(cuda) and not capturable(cpu)


class _Replayable:
    """Stands in for ``torch.cuda.CUDAGraph``: a replay writes what the
    captured step would, from the static inputs it was handed."""

    def __init__(self, static, logits, lengths):
        self.static, self.logits, self.lengths = static, logits, lengths
        self.replays = 0

    def replay(self):
        tokens, _tables, lengths, _active = self.static
        self.logits.copy_(tokens.float())
        self.lengths.copy_(lengths + 1)
        self.replays += 1


def test_replay_copies_inputs_and_hands_back_the_captured_step(model):
    eng = _engine(model)
    cache, inputs = _step_inputs(eng)
    static = tuple(torch.zeros_like(t) for t in inputs)
    logits, lengths = torch.zeros(3, 1), torch.zeros(3, dtype=torch.int32)
    fake = _Replayable(static, logits, lengths)
    outs = [("layers/attn/wq", torch.ones(3, 2, dtype=torch.int32)),
            ("lm_head", torch.full((3, 5), 2, dtype=torch.int32))]
    graph = engine_lib._DecodeGraph(
        key=(), graph=fake, inputs=static, outputs=(logits, lengths),
        sites=outs, calls=["wq", "head"], held=())
    seen = []
    with backends.use_backend("tubgemm", bits=4,
                              on_output=lambda s, o: seen.append((s, o))) as ex:
        ex.calls = []
        # a fresh token buffer is copied in; the static lengths are the
        # step's own and are not copied onto themselves
        step = (inputs[0] + 7, inputs[1], static[2], inputs[3])
        static[2].fill_(4)
        got = eng._replay(graph, ex, cache.k_pool, cache.v_pool, step)
    assert fake.replays == 1 and eng.decode_counts["replays"] == 1
    assert torch.equal(static[0], inputs[0] + 7)
    assert torch.equal(static[1], inputs[1])
    assert torch.equal(static[3], inputs[3])
    assert got[0] is logits and got[3] is lengths
    assert got[1] is cache.k_pool and got[2] is cache.v_pool
    assert torch.equal(logits, (inputs[0] + 7).float())
    assert torch.equal(lengths, torch.full((3,), 5, dtype=torch.int32))
    # the captured sites, in order, with the graph's own buffers
    assert [s for s, _ in seen] == ["layers/attn/wq", "lm_head"]
    assert all(a is b for (_, a), (_, b) in zip(seen, outs))
    assert ex.calls == ["wq", "head"]
    # with no scope the replay hands nothing over
    eng._replay(graph, None, cache.k_pool, cache.v_pool, step)
    assert fake.replays == 2 and len(seen) == 2


def test_run_takes_over_the_last_runs_pools(model):
    eng = _engine(model)
    ptrs = []
    decode = eng._decode

    def spy(params, tokens, k_pool, v_pool, *rest):
        ptrs.append((k_pool.data_ptr(), v_pool.data_ptr()))
        return decode(params, tokens, k_pool, v_pool, *rest)

    eng._decode = spy
    with activation_scaling("per-row"):
        first = eng.run(TRACE)
        n = len(ptrs)
        second = eng.run(TRACE)
    assert set(ptrs[:n]) == set(ptrs[n:]) and len(set(ptrs)) == 1
    # the pools start each run zeroed: the runs are the same
    assert first.request_tokens == second.request_tokens
    assert first.events == second.events


def test_paged_cache_takes_over_pools_zeroed():
    kw = dict(num_layers=2, num_kv_heads=2, head_dim=4, num_pages=5,
              page_size=4, max_seq_len=16, device="cpu")
    old = PagedKVCache(**kw)
    old.k_pool.fill_(3.0)
    old.v_pool.fill_(-1.0)
    new = PagedKVCache(**kw, pools=(old.k_pool, old.v_pool))
    assert new.k_pool is old.k_pool and new.v_pool is old.v_pool
    assert not new.k_pool.any() and not new.v_pool.any()
    assert new.allocator.num_free == 4 and not new.block_tables
    with pytest.raises(ValueError, match="cannot hold"):
        PagedKVCache(**{**kw, "num_pages": 6}, pools=(old.k_pool, old.v_pool))
    with pytest.raises(ValueError, match="cannot hold"):
        PagedKVCache(**kw, pools=(old.k_pool.double(), old.v_pool))


# -- the benchmark's reader of the replayed share -----------------------------

def _replay_share(program):
    from bench import manifest, serve, spantrace
    trace = spantrace.SpannedTrace(ops=[], t0=0, t1=100, program=program)
    view = serve.RunView(setup_s=1.0, window=serve.Window([]), sizes={},
                         bits=4, device_kind="cpu", trace=trace)
    return manifest.reader("decode_replay_pct.serve").read(view)


def _step(t, replay: bool, capture: bool = False):
    """The program spans of one step at ``t``: engine.step, engine.decode
    (with a capture and a replay under it), engine.decode.sync."""
    out = [("engine.step", t, t + 9, -1, -1), ("engine.decode", t, t + 5, 0, -1)]
    if capture:
        out.append(("engine.decode.capture", t, t + 2, 1, -1))
    if replay:
        out.append(("engine.decode.replay", t + 2, t + 4, 1, -1))
    out.append(("engine.decode.sync", t + 5, t + 8, 0, -1))
    return out


def _program(steps):
    program = []
    for spans in steps:
        base = len(program)
        program += [(n, a, b, p + base if p >= 0 else -1, r)
                    for n, a, b, p, r in spans]
    return program


def test_decode_replay_pct_reader_counts_replayed_steps():
    eager = _program([_step(0, False), _step(10, False)])
    assert _replay_share(eager) == 0.0
    mixed = _program([_step(0, False), _step(10, True, capture=True),
                      _step(20, True), _step(30, True)])
    assert _replay_share(mixed) == 75.0
    assert _replay_share(_program([_step(0, True)])) == 100.0
    # a step that admits: its prefill spans beside the decode's
    admit = _step(40, True) + [("engine.prefill", 45, 48, 0, -1)]
    assert _replay_share(_program([_step(0, True), admit])) == 100.0
    assert _replay_share([]) is None
    assert _replay_share(_program([[("engine.step", 0, 5, -1, -1)]])) is None
