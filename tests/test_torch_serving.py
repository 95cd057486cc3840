"""Port vs reference: paged KV cache, probes, and the serving slice as a whole.

The reference engine enters a device mesh; under the installed jax its
default mesh has Explicit axes, which its sharding helper rejects, so this
file patches — on the test's side only — ``single_device_mesh`` to the same
mesh with Auto axes.  Nothing in the reference package changes.

Contracts: allocator invariants hold; the probes return 0.0 and <=
FUSED_LOGIT_TOL; for a 6-request seeded trace the port's
``ServingEngine.run`` and the reference engine produce EQUAL events, steps
and per-request token streams, and ``energy_uj`` within rel 1e-6 (identical
Python pricing arithmetic fed float32-rounded sparsity statistics), on the
float path and under ``tubgemm``@4 with per-row activation scaling.
"""

import dataclasses
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.models import common as ref_common
from repro.models import model as ref_model
from repro.serving import engine as ref_engine_mod
from repro.serving import energy as ref_energy
from repro.serving import traffic as ref_traffic
from repro_torch import configs as port_configs
from repro_torch.models import common as port_common
from repro_torch.models import model as port_model
from repro_torch.serving import (FUSED_LOGIT_TOL, OutOfPages, PageAllocator,
                                 PagedKVCache, ServingEngine, TrafficConfig,
                                 fused_vs_gather_probe, generate_trace,
                                 paged_vs_contiguous_probe)
from repro_torch.serving import energy as port_energy


def _auto_mesh(model_axis: bool = True):
    auto = jax.sharding.AxisType.Auto
    if model_axis:
        return jax.make_mesh((1, 1), ("data", "model"), axis_types=(auto, auto))
    return jax.make_mesh((1,), ("data",), axis_types=(auto,))


@pytest.fixture(scope="module")
def setup():
    ref_cfg = ref_configs.get_smoke_config("llama3-8b").replace(
        compute_dtype="float32")
    port_cfg = port_configs.get_smoke_config("llama3-8b").replace(
        compute_dtype="float32")
    ref_params = ref_model.init_params(ref_cfg, jax.random.PRNGKey(0))
    port_params = port_model.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, ref_params), device="cpu")
    return ref_cfg, port_cfg, ref_params, port_params


# -- allocator / cache properties ---------------------------------------------

@pytest.mark.parametrize("seed", range(6))
def test_allocator_never_aliases_and_conserves_pages(seed):
    rng = np.random.default_rng(seed)
    alloc = PageAllocator(num_pages=17)
    owned: dict[int, list[int]] = {}
    for op in range(200):
        if owned and rng.random() < 0.4:
            rid = int(rng.choice(list(owned)))
            alloc.free(owned.pop(rid), rid)
        else:
            n = int(rng.integers(0, 5))
            if n > alloc.num_free:
                with pytest.raises(OutOfPages):
                    alloc.alloc(n, op)
                continue
            owned[op] = alloc.alloc(n, op)
        pages = [p for ps in owned.values() for p in ps]
        assert len(pages) == len(set(pages))                  # no aliasing
        assert 0 not in pages                                 # trash page reserved
        assert alloc.num_free + len(pages) == alloc.capacity == 16
        assert all(alloc.owner_of(p) == rid for rid, ps in owned.items() for p in ps)
    with pytest.raises(ValueError):
        PageAllocator(num_pages=1)
    with pytest.raises(ValueError):
        alloc.alloc(-1, "x")


@pytest.mark.parametrize("seed,page", [(0, 3), (1, 4), (2, 8)])
def test_paged_cache_reconstructs_contiguous_history(seed, page):
    rng = np.random.default_rng(seed)
    cache = PagedKVCache(num_layers=2, num_kv_heads=2, head_dim=4,
                         num_pages=20, page_size=page, max_seq_len=24,
                         device="cpu")
    truth = {}
    for rid in range(3):
        prompt = int(rng.integers(1, 9))
        total = prompt + int(rng.integers(1, 9))
        cache.allocate(rid, total)
        k = rng.standard_normal((2, prompt, 2, 4)).astype(np.float32)
        v = rng.standard_normal((2, prompt, 2, 4)).astype(np.float32)
        cache.write_prefill(rid, torch.from_numpy(k), torch.from_numpy(v))
        for _ in range(total - prompt):
            nk = rng.standard_normal((2, 1, 2, 4)).astype(np.float32)
            nv = rng.standard_normal((2, 1, 2, 4)).astype(np.float32)
            cache.append_token(rid, torch.from_numpy(nk[:, 0]), torch.from_numpy(nv[:, 0]))
            k, v = np.concatenate([k, nk], 1), np.concatenate([v, nv], 1)
        truth[rid] = (k, v)
    for rid, (k, v) in truth.items():
        gk, gv = cache.gather_request(rid)
        np.testing.assert_array_equal(gk, k)
        np.testing.assert_array_equal(gv, v)
    row = cache.block_table_row(1)
    assert row.dtype == np.int32 and row.shape == (cache.max_blocks,)
    assert (cache.block_table_row() == 0).all()
    free_before = cache.allocator.num_free
    cache.free_request(1)
    assert cache.allocator.num_free == free_before + len([p for p in row if p])
    with pytest.raises(ValueError):
        cache.allocate(0, 4)
    with pytest.raises(ValueError):
        cache.allocate(9, 10_000)
    assert float(cache.k_pool[:, 0].abs().max()) == 0.0      # trash page untouched


# -- probes ---------------------------------------------------------------------

@pytest.mark.parametrize("page", [3, 4, 8])
def test_probes(setup, page):
    _, port_cfg, _, port_params = setup
    assert paged_vs_contiguous_probe(port_cfg, port_params, page_size=page) == 0.0
    assert fused_vs_gather_probe(port_cfg, port_params, page_size=page) <= FUSED_LOGIT_TOL


# -- energy walk ------------------------------------------------------------------

def test_weight_walk_and_energy_model_equal(setup):
    ref_cfg, port_cfg, ref_params, port_params = setup
    ref_walk = list(ref_energy.iter_weight_matrices(ref_cfg, ref_params))
    port_walk = list(port_energy.iter_weight_matrices(port_cfg, port_params))
    assert [n for n, _ in ref_walk] == [n for n, _ in port_walk]
    assert "embed" not in [n for n, _ in port_walk]
    for (_, rw), (_, pw) in zip(ref_walk, port_walk):
        np.testing.assert_array_equal(rw, pw.numpy())
    for design, bits in (("tubgemm", 4), ("tugemm", 8), ("bgemm", 2)):
        rm = ref_energy.EnergyModel(ref_cfg, ref_params, design=design, bits=bits)
        pm = port_energy.EnergyModel(port_cfg, port_params, design=design, bits=bits)
        assert rm._shapes == pm._shapes
        for m in (1, 3, 17):
            assert dataclasses.asdict(rm.step_cost(m)) == dataclasses.asdict(pm.step_cost(m))
        assert rm.decode_energy_uj(0) == pm.decode_energy_uj(0) == 0.0
        assert rm.prefill_energy_uj(9) == pm.prefill_energy_uj(9)


# -- the slice as a whole -------------------------------------------------------------

@pytest.mark.parametrize("backend,scheduler", [
    (None, "continuous"), (None, "static"), ("tubgemm", "continuous")])
def test_engine_trace_equals_reference(setup, monkeypatch, backend, scheduler):
    ref_cfg, port_cfg, ref_params, port_params = setup
    monkeypatch.setattr(ref_engine_mod, "single_device_mesh", _auto_mesh)
    kw = dict(num_requests=6, arrival_rate=1.0, seed=0)
    ref_trace = ref_traffic.generate_trace(ref_traffic.TrafficConfig(**kw))
    trace = generate_trace(TrafficConfig(**kw))
    ekw = dict(max_batch=4, page_size=8, max_seq_len=64, backend=backend, bits=4)
    ref_eng = ref_engine_mod.ServingEngine(ref_cfg, ref_params, attention="gather", **ekw)
    with ref_common.activation_scaling("per-row"):
        ref_rep = ref_eng.run(ref_trace, scheduler)
    for attention in ("fused", "gather"):
        eng = ServingEngine(port_cfg, port_params, attention=attention,
                            device="cpu", **ekw)
        with port_common.activation_scaling("per-row"):
            rep = eng.run(trace, scheduler)
        assert rep.events == ref_rep.events
        assert rep.steps == ref_rep.steps
        assert rep.request_tokens == ref_rep.request_tokens
        assert rep.energy_uj == pytest.approx(ref_rep.energy_uj, rel=1e-6)
        assert (rep.requests, rep.tokens, rep.latencies, rep.occupancy) == \
            (ref_rep.requests, ref_rep.tokens, ref_rep.latencies, ref_rep.occupancy)
        assert (rep.design, rep.bits, rep.num_pages) == \
            (ref_rep.design, ref_rep.bits, ref_rep.num_pages)
        assert rep.prefill_calls > 0 and rep.decode_steps > 0
        assert rep.to_dict()["request_tokens"].keys() == \
            ref_rep.to_dict()["request_tokens"].keys()


def test_cuda_mirror_backend_and_prefill_grouping(setup):
    _, port_cfg, _, port_params = setup
    trace = generate_trace(TrafficConfig(num_requests=6, arrival_rate=2.0, seed=3))
    reps = {}
    for name, kw in (("sim", dict(backend="tubgemm")),
                     ("mirror", dict(backend="tubgemm_cuda")),
                     ("tu", dict(backend="tugemm_cuda")),
                     ("solo", dict(backend="tubgemm_cuda", batched_prefill=False))):
        eng = ServingEngine(port_cfg, port_params, bits=4, device="cpu", **kw)
        with port_common.activation_scaling("per-row"):
            reps[name] = eng.run(trace)
    for name in ("mirror", "tu", "solo"):
        assert reps[name].request_tokens == reps["sim"].request_tokens
        assert reps[name].events == reps["sim"].events
    assert reps["solo"].prefill_calls == 6 >= reps["mirror"].prefill_calls
    assert reps["mirror"].energy_uj == reps["sim"].energy_uj   # priced as sibling


def test_engines_share_weight_cache(setup):
    _, port_cfg, _, port_params = setup
    trace = generate_trace(TrafficConfig(num_requests=4, arrival_rate=2.0, seed=1))
    kw = dict(backend="tubgemm_cuda", bits=4, device="cpu")
    first = ServingEngine(port_cfg, port_params, attention="fused", **kw)
    with port_common.activation_scaling("per-row"):
        rep = first.run(trace)
    filled = dict(first.weight_cache)
    assert len(filled) == 7 * port_cfg.num_layers + 1
    second = ServingEngine(port_cfg, port_params, attention="gather",
                           weight_cache=first.weight_cache, **kw)
    own = ServingEngine(port_cfg, port_params, attention="gather", **kw)
    assert second.weight_cache is first.weight_cache is not own.weight_cache
    with port_common.activation_scaling("per-row"):
        assert second.run(trace).request_tokens == rep.request_tokens
        assert own.run(trace).request_tokens == rep.request_tokens
    # the shared run reused every entry and quantized nothing anew
    assert first.weight_cache.keys() == filled.keys()
    assert all(first.weight_cache[k][1] is filled[k][1] for k in filled)


def test_engine_argument_checks(setup):
    _, port_cfg, _, port_params = setup
    for kw in (dict(plan=object()), dict(grid=(2, 2)), dict(packed=True)):
        with pytest.raises(NotImplementedError):
            ServingEngine(port_cfg, port_params, device="cpu", **kw)
    with pytest.raises(ValueError):
        ServingEngine(port_cfg, port_params, attention="flash", device="cpu")
    with pytest.raises(ValueError):
        ServingEngine(port_cfg.replace(attention="mla"), port_params, device="cpu")
    eng = ServingEngine(port_cfg, port_params, device="cpu", max_seq_len=8)
    with pytest.raises(ValueError):
        eng.run(())
    with pytest.raises(ValueError, match="max_seq_len"):
        eng.run(generate_trace(TrafficConfig(num_requests=4, seed=0)))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            ServingEngine(port_cfg, port_params)            # default device


@pytest.mark.parametrize("extra,code", [
    ([], 0),
    (["--execute-backend", "tubgemm_cuda", "--act-scale", "per-row"], 0),
    (["--execute-backend", "nope"], 2)])
def test_serve_traffic_cli(extra, code):
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "traffic", "--smoke",
         "--device", "cpu", *extra],
        capture_output=True, text=True, timeout=600)
    assert proc.returncode == code, proc.stdout + proc.stderr
    if code == 0:
        assert "paged decode vs contiguous decode_step (fp32): exact" in proc.stdout
        assert "identical: True" in proc.stdout


def test_serve_cli_refuses_missing_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "traffic", "--smoke"],
        capture_output=True, text=True, timeout=600)
    assert proc.returncode == 2
    assert "no CUDA device" in proc.stdout
