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
float path, under ``tubgemm``@4, ``ugemm``@4 and ``ugemm_stochastic:16``@4
with per-row activation scaling, with ``cfg.quant_kernel`` at 4 bits (no
backend scope; the packed kernel, or uGEMM's multiplier under
``quant_backend="ugemm"``), and under the example
plan from float and from bit-packed weight stores (``packed=True``, whose
streams also equal the unpacked engine's).
"""

import dataclasses
import pathlib
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
from repro_torch.core import packing
from repro_torch.models import common as port_common
from repro_torch.models import model as port_model
from repro_torch.serving import (FUSED_LOGIT_TOL, OutOfPages, PageAllocator,
                                 PagedKVCache, ServingEngine, TrafficConfig,
                                 fused_vs_gather_probe, generate_trace,
                                 paged_vs_contiguous_probe)
from repro_torch.serving import energy as port_energy


PLAN = pathlib.Path(__file__).resolve().parents[1] / "examples" / "plans" \
    / "llama3_8b_smoke.plan.json"


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
    (None, "continuous"), (None, "static"), ("tubgemm", "continuous"),
    ("quant_kernel", "continuous"), ("ugemm", "continuous"),
    ("ugemm_stochastic:16", "continuous"), ("quant_kernel_ugemm", "continuous")])
def test_engine_trace_equals_reference(setup, monkeypatch, backend, scheduler):
    ref_cfg, port_cfg, ref_params, port_params = setup
    if backend in ("quant_kernel", "quant_kernel_ugemm"):
        # no backend scope: every dense site runs the packed quant_gemm
        # kernel path at 4 bits (activations per tensor at 8), or uGEMM's
        # multiplier (activations per tensor at 4)
        kw = dict(quant_bits=4, quant_kernel=True)
        if backend == "quant_kernel_ugemm":
            kw["quant_backend"] = "ugemm"
        ref_cfg = ref_cfg.replace(**kw)
        port_cfg = port_cfg.replace(**kw)
        backend = None
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


@pytest.mark.parametrize("packed", [False, True])
def test_engine_plan_trace_equals_reference(setup, monkeypatch, packed):
    """Under the example plan, from float or bit-packed weight stores, the
    port's engine serves the reference engine's events and token streams."""
    from repro.backends import BackendPlan as RefPlan
    ref_cfg, port_cfg, ref_params, port_params = setup
    monkeypatch.setattr(ref_engine_mod, "single_device_mesh", _auto_mesh)
    kw = dict(num_requests=6, arrival_rate=1.0, seed=0)
    ref_trace = ref_traffic.generate_trace(ref_traffic.TrafficConfig(**kw))
    trace = generate_trace(TrafficConfig(**kw))
    ekw = dict(max_batch=4, page_size=8, max_seq_len=64, bits=4, packed=packed)
    ref_eng = ref_engine_mod.ServingEngine(
        ref_cfg, ref_params, attention="gather", plan=RefPlan.load(PLAN), **ekw)
    with ref_common.activation_scaling("per-row"):
        ref_rep = ref_eng.run(ref_trace, "continuous")
    reps = {}
    for attention in ("fused", "gather"):
        eng = ServingEngine(port_cfg, port_params, attention=attention,
                            plan=PLAN, device="cpu", **ekw)
        assert any(packing.is_packed(leaf) for leaf in
                   eng._exec_params["layers"]["attn"].values()) == packed
        with port_common.activation_scaling("per-row"):
            reps[attention] = rep = eng.run(trace, "continuous")
        assert rep.events == ref_rep.events
        assert rep.request_tokens == ref_rep.request_tokens
        assert rep.energy_uj == pytest.approx(ref_rep.energy_uj, rel=1e-6)
    if packed:      # and the packed store serves what the float one does
        eng = ServingEngine(port_cfg, port_params, attention="fused",
                            plan=PLAN, device="cpu", **{**ekw, "packed": False})
        with port_common.activation_scaling("per-row"):
            assert eng.run(trace, "continuous").request_tokens == \
                reps["fused"].request_tokens


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
    ref_cfg, port_cfg, ref_params, port_params = setup
    # a grid engine builds; its energy model prices the 2x2 grid exactly as
    # the reference's does (a GridCost)
    grid_eng = ServingEngine(port_cfg, port_params, device="cpu", grid=(2, 2),
                             backend="tubgemm")
    assert grid_eng.grid == (2, 2)
    ref_cost = ref_energy.EnergyModel(ref_cfg, ref_params, design="tubgemm",
                                      bits=4, grid=(2, 2)).step_cost(3)
    cost = grid_eng.energy.step_cost(3)
    assert type(cost).__name__ == type(ref_cost).__name__ == "GridCost"
    assert (cost.units_x, cost.units_y, cost.total_macs) == \
        (ref_cost.units_x, ref_cost.units_y, ref_cost.total_macs)
    for field in ("dyn_energy_uj", "wc_energy_uj", "dyn_latency_us",
                  "hop_energy_uj", "hop_latency_us", "utilization"):
        assert getattr(cost, field) == pytest.approx(
            getattr(ref_cost, field), rel=1e-6), field
    for kw in (dict(packed=True), dict(backend="tubgemm", plan=PLAN)):
        with pytest.raises(ValueError):
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


# -- why the CLI serves in float32 (ROADMAP Queue 3) ----------------------------

def _teacher_forced_gap(cfg, params, *, steps=4, prompt_len=12, batch=4):
    """(max |dlogit|, smallest top-1/top-2 margin, argmax flips) over
    ``steps`` decode steps run through a fused and a gather engine from
    identical pools and tokens: both are fed the gather engine's argmax, and
    the fused pools are reset to the gather pools after every step."""
    engines = {a: ServingEngine(cfg, params, attention=a, device="cpu",
                                max_batch=batch, page_size=8, max_seq_len=64)
               for a in ("fused", "gather")}
    prompts = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (batch, prompt_len)).astype(np.int32))
    logits, k_l, v_l = engines["gather"]._prefill(prompts)
    tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
    caches = {name: eng.new_cache() for name, eng in engines.items()}
    for cache in caches.values():
        for i in range(batch):
            cache.allocate(i, prompt_len + steps + 1)
            cache.write_prefill(i, k_l[:, i], v_l[:, i])
    bt = torch.from_numpy(np.stack([caches["gather"].block_table_row(i)
                                    for i in range(batch)]))
    active = torch.ones((batch,), dtype=torch.bool)
    gap, margin, flips = 0.0, float("inf"), 0
    for step in range(steps):
        lengths = torch.full((batch,), prompt_len + step, dtype=torch.int32)
        out = {}
        for name, eng in engines.items():
            c = caches[name]
            lg, _, _, _ = eng._decode(eng.params, tok, c.k_pool, c.v_pool, bt,
                                      lengths, active)
            out[name] = lg[:, 0].float()
        gap = max(gap, float((out["fused"] - out["gather"]).abs().max()))
        top2 = out["gather"].topk(2, dim=-1).values
        margin = min(margin, float((top2[:, 0] - top2[:, 1]).min()))
        flips += int((out["fused"].argmax(-1) != out["gather"].argmax(-1)).sum())
        caches["fused"].k_pool.copy_(caches["gather"].k_pool)
        caches["fused"].v_pool.copy_(caches["gather"].v_pool)
        tok = out["gather"].argmax(-1).to(torch.int32)[:, None]
    return gap, margin, flips


def test_bf16_fused_vs_gather_cause(setup):
    """At bfloat16 the fused page walk and the gather oracle part by the
    oracle's own bfloat16 roundings, not by the walk: the walk scores and
    normalises in float32 (as the Pallas kernel and the CUDA kernel do),
    the oracle rounds q.k and the softmax weights to bfloat16 (as the
    reference's XLA lowering, its CPU serving default, mirrors).  That gap
    is ~100x FUSED_LOGIT_TOL on the logits, so the CLI's strict float-path
    fused==gather gate holds only in float32, where the CLI serves."""
    from repro_torch.kernels import paged_attention as paged_lib
    from repro_torch.kernels import paged_attention_fused as fused_lib
    rng = np.random.default_rng(11)
    batch, kvh, h, hd, page, blocks = 4, 2, 8, 16, 4, 6
    num_pages = 1 + batch * blocks
    bt = torch.from_numpy(rng.permutation(np.arange(1, num_pages)).astype(np.int32)
                          .reshape(batch, blocks))
    lens = torch.tensor([1, 5, 13, 24], dtype=torch.int32)
    pk, pv = (torch.from_numpy(rng.standard_normal((num_pages, page, kvh, hd))
                               .astype(np.float32)).to(torch.bfloat16)
              for _ in range(2))
    q = torch.from_numpy(rng.standard_normal((batch, 1, h, hd))
                         .astype(np.float32)).to(torch.bfloat16)
    args = (bt, lens)
    fused = fused_lib.fused_decode_plain(q, pk, pv, *args, num_heads=h)
    fused32 = fused_lib.fused_decode_plain(q.float(), pk.float(), pv.float(),
                                           *args, num_heads=h)
    gather = paged_lib.paged_decode_attention(q, pk, pv, *args, num_heads=h)
    gather32 = paged_lib.paged_decode_attention(q.float(), pk.float(), pv.float(),
                                                *args, num_heads=h)
    # the walk is float32 arithmetic on the bfloat16 values, rounded once
    assert torch.equal(fused, fused32.to(torch.bfloat16))
    assert float((fused32 - gather32).abs().max()) <= FUSED_LOGIT_TOL
    attn_gap = float((fused.float() - gather.float()).abs().max())
    assert attn_gap > 10 * FUSED_LOGIT_TOL
    # through the smoke model, teacher-forced
    _, port_cfg, _, port_params = setup
    gap32, margin32, flips32 = _teacher_forced_gap(port_cfg, port_params)
    gap16, margin16, flips16 = _teacher_forced_gap(
        port_cfg.replace(compute_dtype="bfloat16"), port_params)
    print(f"\nbf16 attention gap {attn_gap:.3e}; teacher-forced max |dlogit| "
          f"fp32 {gap32:.3e} (margin {margin32:.3e}, {flips32} flips), bf16 "
          f"{gap16:.3e} (margin {margin16:.3e}, {flips16} flips)")
    assert gap32 <= FUSED_LOGIT_TOL and flips32 == 0
    assert gap16 > 10 * FUSED_LOGIT_TOL
