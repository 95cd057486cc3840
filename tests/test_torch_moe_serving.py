"""The serving expert layer (``models/moe.py:moe_serve``) and the serving
engine on a mixture-of-experts model, on the CPU at a small size (d 64, 8
experts, top-2, expert width 64, 2 layers), against the plain reference
(``bench/reference_moe.py``: plain torch, no part of the port):

* sparsemixer on hand-built logits, its weights written out (the runner-up
  inside and outside the band of 2 eps, a tie);
* the layer within 1e-5 of the reference in float, and under
  ``tubgemm``@4 per-row every expert site's int32 products equal to the
  reference's, expert by expert, whether each expert contracts its routed
  rows (prefill) or the whole block with the others zeroed (decode);
* dropless: every token routed to one expert is computed;
* rows no request holds reach no expert;
* four shares of the experts, each computed alone, add up to the uncut
  layer; softmax routing, served dropless, equals ``moe_fwd`` with its
  capacity lifted;
* the engine's prefill (a padded group and a lone prompt) and its decode
  steps through the paged cache, an idle slot among them, against the
  reference's full forward logits, in one process with all 8 experts and
  on two ``gloo`` ranks with 4 each.
"""

from __future__ import annotations

import os
import tempfile
import time

import numpy as np
import pytest
import torch

from bench import reference_moe as ref
from repro_torch.backends import use_backend
from repro_torch.backends.runtime import site_scope
from repro_torch.models import moe as moe_lib
from repro_torch.models.common import activation_scaling
from repro_torch.models.config import (ModelConfig, MoEConfig,
                                       SparseMixerMoEConfig)
from repro_torch.serving.engine import ServingEngine

EPS = 0.01
E, D, F_EXPERT = 8, 64, 64
FLOAT_TOL = 1e-5
WORLD = 2
RANK_TIMEOUT_S = 240


def _cfg(**moe) -> ModelConfig:
    return ModelConfig(
        arch_id="moe-tiny", family="moe", num_layers=2, d_model=D,
        num_heads=4, num_kv_heads=2, d_ff=F_EXPERT, vocab_size=256,
        compute_dtype="float32", param_dtype="float32", remat=False,
        moe=SparseMixerMoEConfig(num_experts=E, top_k=2,
                                 d_ff_expert=F_EXPERT, router_noise=EPS,
                                 **moe))


SIZES = {"d_model": D, "num_heads": 4, "num_kv_heads": 2, "head_dim": 16,
         "num_layers": 2, "vocab_size": 256, "rope_theta": 10000.0,
         "rms_eps": 1e-5, "num_experts": E, "jitter_eps": EPS}


def _layer(seed: int = 0):
    """One layer's router and expert stacks, and 37 rows of input."""
    g = torch.Generator().manual_seed(seed)
    router = torch.randn((D, E), generator=g) / D ** 0.5
    wg = torch.randn((E, D, F_EXPERT), generator=g) / D ** 0.5
    wu = torch.randn((E, D, F_EXPERT), generator=g) / D ** 0.5
    wd = torch.randn((E, F_EXPERT, D), generator=g) / F_EXPERT ** 0.5
    h = torch.randn((37, D), generator=g)
    return {"router": router, "w_gate": wg, "w_up": wu, "w_down": wd}, h


def _serve(params, h, cfg, *, live=None, gather=True, mesh=None,
           counts=None):
    live = torch.ones(h.shape[0], dtype=torch.bool) if live is None else live
    with site_scope("layers"), site_scope("moe"):
        return moe_lib.moe_serve(params, h[None], cfg, moe_lib.Serving(
            live[None], counts, mesh, gather), 0)[0]


def _reference(params, h, bits=None, products=None, first=0):
    return ref.expert_layer(h, params["router"], (params["w_gate"],
                            params["w_up"], params["w_down"]), EPS, bits,
                            first, products=products)


# -- sparsemixer ----------------------------------------------------------------

# each case: logits, the experts picked, their weights written out
W_BAND = 1.0 / (1.0 + np.exp(-0.01))        # two logits 0.01 apart, in band
SPARSEMIXER_CASES = {
    "runner_up_outside": ([2.0, 1.0, 0.5, -1.0], [0, 1], [1.0, 1.0]),
    "runner_up_inside": ([2.0, 1.99, 0.0, -3.0], [0, 1], [W_BAND, 1.0]),
    "second_inside": ([3.0, 2.0, 1.99, -1.0], [0, 1], [1.0, W_BAND]),
    "tie": ([1.0, 3.0, 3.0, 0.0], [1, 2], [0.5, 1.0]),
}


@pytest.mark.parametrize("case", list(SPARSEMIXER_CASES))
@pytest.mark.parametrize("impl", ["port", "reference"])
def test_sparsemixer_written_cases(case, impl):
    logits, experts, weights = SPARSEMIXER_CASES[case]
    fn = moe_lib.sparsemixer if impl == "port" else ref.sparsemixer
    idx, w = fn(torch.tensor([logits]), EPS)
    assert idx.tolist() == [experts]
    np.testing.assert_allclose(w[0].numpy(), weights, rtol=0, atol=1e-6)


# -- the layer against the reference ------------------------------------------

@pytest.mark.parametrize("gather", [True, False], ids=["prefill", "decode"])
def test_serving_layer_matches_reference_in_float(gather):
    params, h = _layer()
    out = _serve(params, h, _cfg(), gather=gather)
    assert float((out - _reference(params, h)).abs().max()) <= FLOAT_TOL


@pytest.mark.parametrize("gather", [True, False], ids=["prefill", "decode"])
def test_expert_products_equal_reference_bit_for_bit(gather):
    params, h = _layer(1)
    seen: list = []
    with use_backend("tubgemm", bits=4,
                     on_output=lambda site, out: seen.append((site, out))), \
            activation_scaling("per-row"):
        out = _serve(params, h, _cfg(), gather=gather)
    products: dict = {}
    expect = _reference(params, h, bits=4, products=products)
    routed = sorted({e for e, _ in products})
    assert len(routed) >= 6
    # prefill: the routed experts in order; decode: every expert in order
    experts = routed if gather else list(range(E))
    assert [s for s, _ in seen] == [f"layers/moe/{n}" for _ in experts
                                    for n in ref.EXPERT_SITES]
    for j, (site, got) in enumerate(seen):
        assert got.dtype == torch.int32
        key = (experts[j // 3], site.rpartition("/")[2])
        if key not in products:            # a decode block no row routed to
            assert not got.any(), (site, j)
            continue
        rows, acc = products[key]
        if not gather:
            assert not got[~torch.isin(torch.arange(37), rows)].any()
            got = got[rows]
        assert torch.equal(got.to(torch.float32), acc), (site, j)
    assert float((out - expect).abs().max()) <= FLOAT_TOL


def test_dropless_every_token_routed_to_one_expert_is_computed():
    params, h = _layer(2)
    # expert 3 is every token's first choice: a capacity of 1.25 x the mean
    # would keep 12 of the 37
    h[:, 0] += 8.0
    params["router"][0, 3] = 10.0
    idx, _ = ref.sparsemixer(h @ params["router"], EPS)
    assert (idx[:, 0] == 3).all()
    counts = torch.zeros((1, E, 2), dtype=torch.int64)
    out = _serve(params, h, _cfg(), counts=counts)
    assert counts[0, 3].tolist() == [37, 1]
    assert int(counts[0, :, 0].sum()) == 2 * 37
    assert float((out - _reference(params, h)).abs().max()) <= FLOAT_TOL
    assert moe_lib._capacity(37, _cfg()) < 37


@pytest.mark.parametrize("gather", [True, False], ids=["prefill", "decode"])
def test_rows_no_request_holds_reach_no_expert(gather):
    params, h = _layer(3)
    live = torch.ones(37, dtype=torch.bool)
    live[[0, 5, 6, 30, 36]] = False
    counts = torch.zeros((1, E, 2), dtype=torch.int64)
    rows_in: list = []
    with use_backend("tubgemm", bits=4, on_output=lambda site, out:
                     rows_in.append(out.shape[0])), \
            activation_scaling("per-row"):
        out = _serve(params, h, _cfg(), live=live, gather=gather,
                     counts=counts)
    assert float(out[~live].abs().max()) == 0.0
    products: dict = {}
    expect = _reference(params, h[live], bits=4, products=products)
    assert float((out[live] - expect).abs().max()) <= FLOAT_TOL
    routed = {e: rows.numel() for (e, _), (rows, _) in products.items()}
    assert counts[0, :, 0].tolist() == [routed.get(e, 0) for e in range(E)]
    assert int(counts[0, :, 0].sum()) == 2 * int(live.sum())
    if gather:     # each expert's GEMMs at exactly its routed live rows
        assert rows_in == [routed[e] for e in sorted(routed) for _ in range(3)]


class _Share:
    """One rank's place on a ``model`` axis of four, computed alone (no
    process group: the exchange adds nothing)."""
    axes = ("model",)
    distributed = False

    def __init__(self, rank: int):
        self.rank = rank

    def axis_size(self, name):
        return 4

    def axis_index(self, name):
        return self.rank


@pytest.mark.parametrize("held", ["sliced", "whole"])
def test_four_shares_add_up_to_the_uncut_layer(held):
    params, h = _layer(4)
    parts = []
    for r in range(4):
        own = dict(params)
        if held == "sliced":
            for name in moe_lib.EXPERT_LEAVES:
                own[name] = params[name][2 * r: 2 * r + 2]
        parts.append(_serve(params if held == "whole" else own, h, _cfg(),
                            mesh=_Share(r)))
    whole = _reference(params, h)
    assert float((sum(parts) - whole).abs().max()) <= FLOAT_TOL
    # each share is the reference's part of its own two experts
    for r, part in enumerate(parts):
        stacks = {n: params[n][2 * r: 2 * r + 2] for n in moe_lib.EXPERT_LEAVES}
        mine = ref.expert_layer(h, params["router"], (
            stacks["w_gate"], stacks["w_up"], stacks["w_down"]), EPS, None,
            2 * r)
        assert float((part - mine).abs().max()) <= FLOAT_TOL


@pytest.mark.parametrize("gather", [True, False], ids=["prefill", "decode"])
def test_softmax_routing_equals_moe_fwd_with_the_capacity_lifted(gather):
    """The port's registered MoE configs route by softmax top-k: served
    dropless, the layer equals ``moe_fwd`` once no expert can drop."""
    params, h = _layer(5)
    cfg = _cfg().replace(moe=MoEConfig(num_experts=E, top_k=2,
                                       d_ff_expert=F_EXPERT,
                                       capacity_factor=E / 2))
    out = _serve(params, h, cfg, gather=gather)
    want, _ = moe_lib.moe_fwd(params, h[None], cfg)
    assert float((out - want[0]).abs().max()) <= FLOAT_TOL


def test_sparsemixer_needs_top_2():
    params, h = _layer()
    cfg = _cfg()
    cfg = cfg.replace(moe=SparseMixerMoEConfig(num_experts=E, top_k=3,
                                               d_ff_expert=F_EXPERT))
    with pytest.raises(ValueError, match="top-2"):
        _serve(params, h, cfg)


# -- the engine: prefill, then decode through the paged cache -----------------

def _params(rank: int = 0, world: int = 1) -> dict:
    """The tiny model's weights, rank ``rank``'s experts of ``world``: the
    moe family's draw (bench/families/moe.py) at these sizes."""
    from bench.families import moe as family
    sizes = dict(SIZES, d_ff_expert=F_EXPERT, top_k=2)
    return family.make_params(sizes, 2**31 + 9, torch.device("cpu"), rank,
                              world)


def _engine_vs_reference(rank: int = 0, world: int = 1) -> dict:
    """Prefill three prompts (two in one padded call), decode four steps of
    four slots (one idle) through the paged cache, and compare every
    logit row the engine gave with the reference's full forward."""
    params = _params(rank, world)
    engine = ServingEngine(_cfg(), params, max_batch=4, page_size=4,
                           max_seq_len=32, attention="fused",
                           device="cpu")
    rng = np.random.default_rng(5)
    lens = [11, 7, 9]
    prompts = [rng.integers(0, 256, n).astype(np.int64) for n in lens]
    cache = engine.new_cache()
    rows: list = [[] for _ in lens]                # logits per request
    padded = np.zeros((2, 16), np.int32)
    for i in (0, 1):
        padded[i, : lens[i]] = prompts[i]
    engine._prefill_lengths = lens[:2]
    lg, k, v = engine._prefill(torch.from_numpy(padded))
    engine._prefill_lengths = None
    lg3, k3, v3 = engine._prefill(torch.from_numpy(prompts[2][None]
                                                   .astype(np.int32)))
    firsts = [(lg[0], k[:, 0], v[:, 0]), (lg[1], k[:, 1], v[:, 1]),
              (lg3[0], k3[:, 0], v3[:, 0])]
    tables = torch.zeros((4, cache.max_blocks), dtype=torch.int32)
    tokens = torch.zeros((4, 1), dtype=torch.int32)
    lengths = torch.zeros((4,), dtype=torch.int32)
    for i, (logits, kk, vv) in enumerate(firsts):
        cache.allocate(i, lens[i] + 6)
        cache.write_prefill(i, kk[:, : lens[i]], vv[:, : lens[i]])
        tables[i] = torch.from_numpy(cache.block_table_row(i))
        rows[i].append(logits[lens[i] - 1])
        tokens[i, 0] = int(torch.argmax(logits[lens[i] - 1]))
        lengths[i] = lens[i]
    active = torch.tensor([True, True, True, False])
    fed = [[] for _ in lens]
    for _ in range(4):
        for i in range(3):
            fed[i].append(int(tokens[i, 0]))
        logits, k_pool, v_pool, lengths = engine._decode(
            params, tokens, cache.k_pool, cache.v_pool, tables, lengths,
            active)
        cache.sync_pools(k_pool, v_pool)
        for i in range(3):
            rows[i].append(logits[i, 0])
        tokens = torch.argmax(logits[:, 0], dim=-1).to(torch.int32)[:, None]
    model = ref.Reference(SIZES, params, None, rank=rank, world=world)
    seqs = [torch.from_numpy(np.concatenate([p, f])) for p, f in
            zip(prompts, fed)]
    want, _ = model.run(seqs, [torch.arange(n - 1, n + 4) for n in lens])
    worst = max(float((torch.stack(r) - w).abs().max())
                for r, w in zip(rows, want))
    counts = engine.expert_rows.tolist()
    return {"worst": worst, "counts": counts, "fed": fed,
            "scale": max(float(w.abs().max()) for w in want)}


def test_engine_prefill_and_decode_match_reference_one_process():
    out = _engine_vs_reference()
    assert out["worst"] <= 1e-4 * max(1.0, out["scale"]), out
    decode, prefill = np.array(out["counts"]).sum(axis=(1, 2))
    # three slots live in four decode steps and 11 + 7 + 9 prompt rows, each
    # routed to two experts; the idle slot and the padding to none
    assert decode[0] == 2 * 3 * 4 * 2        # two layers
    assert prefill[0] == 2 * 27 * 2


def _rank_main(rank: int, init_file: str, work: str) -> None:
    from repro_torch.launch import mesh as mesh_lib
    torch.set_num_threads(1)
    mesh_lib.init_distributed("cpu", init_method=f"file://{init_file}",
                              rank_=rank, world=WORLD, timeout_s=120)
    out = _engine_vs_reference(rank, WORLD)
    torch.distributed.destroy_process_group()
    np.savez(os.path.join(work, f"rank{rank}.npz"),
             worst=out["worst"], scale=out["scale"],
             counts=np.array(out["counts"]), fed=np.array(out["fed"]))


def test_engine_on_two_ranks_of_four_experts_matches_reference():
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory() as work:
        ctx = mp.start_processes(
            _rank_main, args=(os.path.join(work, "store"), work),
            nprocs=WORLD, join=False, start_method="spawn")
        try:
            deadline = time.monotonic() + RANK_TIMEOUT_S
            while not ctx.join(timeout=max(1.0, deadline - time.monotonic())):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"the ranks ran past {RANK_TIMEOUT_S} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
        ranks = [dict(np.load(os.path.join(work, f"rank{r}.npz")))
                 for r in range(WORLD)]
    one = _engine_vs_reference()
    for r, out in enumerate(ranks):
        assert float(out["worst"]) <= 1e-4 * max(1.0, float(out["scale"])), r
        # every rank fed the same tokens, the one-process engine's
        assert out["fed"].tolist() == one["fed"], r
    # each rank counted its own four experts' rows: together, the one
    # process's eight
    both = np.concatenate([out["counts"] for out in ranks], axis=2)
    assert both.tolist() == one["counts"]


def test_engine_refuses_what_the_layer_does_not_serve():
    params = _params()
    with pytest.raises(ValueError, match="routed experts"):
        ServingEngine(_cfg(), params, device="cpu", backend="tubgemm",
                      packed=True)
