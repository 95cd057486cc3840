"""The moe family (``bench/families/moe.py``), its reference and its readers,
on the CPU: each refused key of a configuration, the sizes of the
committed file, a rank's experts drawn as the whole tree's slice, the
counts of work, the three expert readers on a hand-built trace, and a
smoke cell of the MoE configuration on two ``gloo`` ranks through
``bench/control.py``: the program correct, both of the family's faults
not."""

import copy
import json
import subprocess
import sys

import pytest
import torch

from bench import manifest, serve, spantrace, traffic
from bench.families import moe
from bench.tests import smoke_cells

CELL = "phi3.5-moe-42b-a6.6b.ep4-chat"
COMMITTED = json.loads((smoke_cells.BENCH / "configs" /
                        "phi3.5-moe-42b-a6.6b.json").read_text())
LONGEST = 607
SEED = 2**31 + 71
H100 = "NVIDIA H100 80GB HBM3"


def test_sizes_of_the_committed_file():
    assert moe.sizes_of(COMMITTED, LONGEST) == {
        "d_model": 4096, "d_ff_expert": 6400, "num_layers": 32,
        "num_heads": 32, "num_kv_heads": 8, "head_dim": 128,
        "vocab_size": 32064, "rope_theta": 10000.0, "rms_eps": 1e-5,
        "num_experts": 16, "top_k": 2, "jitter_eps": 0.01}
    cell = manifest.cell(manifest.load(smoke_cells.BENCH.parent), CELL)
    assert serve.longest_positions(cell) == LONGEST
    assert manifest.family(cell).__file__.endswith("bench/families/moe.py")
    assert manifest.reference(cell).SITES == ("wq", "wk", "wv", "wo")


#: one refused change of the committed file a case, and the words naming it
REFUSED = {
    "hidden_act": ({"hidden_act": "gelu"}, "hidden_act 'gelu'"),
    "tie_word_embeddings": ({"tie_word_embeddings": True},
                            "tie_word_embeddings True"),
    "num_experts_per_tok": ({"num_experts_per_tok": 4},
                            "num_experts_per_tok 4"),
    "num_local_experts": ({"num_local_experts": None}, "no num_local_experts"),
    "n_shared_experts": ({"n_shared_experts": 1}, "n_shared_experts 1"),
    "kv_lora_rank": ({"kv_lora_rank": 512}, "kv_lora_rank 512"),
    "mlp_bias": ({"mlp_bias": True}, "mlp_bias True"),
    "attention_bias": ({"assumed": {}}, "attention_bias True, which"),
    "partial_rotary_factor": ({"partial_rotary_factor": 0.5},
                              "partial_rotary_factor 0.5"),
    "sliding_window": ({"sliding_window": 512}, "sliding_window 512"),
    "rope_scaling_long": ({"original_max_position_embeddings": 256,
                           "rope_scaling": {"type": "longrope",
                                            "original_max_position_embeddings":
                                                256}},
                          "rope_scaling 'longrope'"),
    "rope_scaling_kind": ({"rope_scaling": {"type": "yarn", "factor": 4.0}},
                          "rope_scaling 'yarn'"),
}


@pytest.mark.parametrize("case", list(REFUSED))
def test_the_family_refuses_what_it_does_not_serve(case):
    change, words = REFUSED[case]
    config = dict(copy.deepcopy(COMMITTED), **change)
    with pytest.raises(manifest.ManifestError, match="another model") as err:
        moe.sizes_of(config, LONGEST)
    assert words in str(err.value)


def test_lm_head_bias_is_settled_by_assumed_alone():
    config = copy.deepcopy(COMMITTED)
    del config["assumed"]["lm_head_bias"]
    with pytest.raises(manifest.ManifestError, match="lm_head_bias True"):
        moe.sizes_of(config, LONGEST)


SMALL = {"d_model": 32, "d_ff_expert": 16, "num_layers": 3, "num_heads": 4,
         "num_kv_heads": 2, "head_dim": 8, "vocab_size": 64,
         "num_experts": 8, "top_k": 2}


@pytest.mark.parametrize("world", [2, 4])
def test_a_ranks_experts_are_the_whole_draws_slice(world):
    whole = moe.make_params(SMALL, SEED, "cpu")
    local = 8 // world
    for rank in range(world):
        mine = moe.make_params(SMALL, SEED, "cpu", rank, world)
        for name in moe.EXPERT_LEAVES:
            assert mine["layers"]["moe"][name].shape[1] == local
            assert torch.equal(mine["layers"]["moe"][name],
                               whole["layers"]["moe"][name][
                                   :, rank * local:(rank + 1) * local])
        # the replicated rest is drawn alike on every rank
        for path in (("embed",), ("lm_head",), ("layers", "attn", "wo"),
                     ("layers", "moe", "router")):
            a, b = whole, mine
            for key in path:
                a, b = a[key], b[key]
            assert torch.equal(a, b), path
    other = moe.make_params(SMALL, SEED + 1, "cpu")
    assert not torch.equal(other["layers"]["moe"]["w_up"],
                           whole["layers"]["moe"]["w_up"])


def test_counts_of_work():
    sizes = moe.sizes_of(COMMITTED, LONGEST)
    # attention's four sites and two of three 4,096 x 6,400 expert matrices
    per = 2 * 4096 * 4096 + 2 * 4096 * 1024 + 2 * 3 * 4096 * 6400
    assert moe.layer_params(sizes) == 32 * per
    # with the head and the embedding, the published 6.6 B active parameters
    active = moe.layer_params(sizes) + 2 * 4096 * 32064
    assert 6.55e9 < active < 6.7e9
    assert moe.token_ops(sizes, 99) == 2.0 * 32 * per + 32 * 4 * 32 * 128 * 100
    assert moe.head_ops(sizes) == 2.0 * 4096 * 32064
    calls = moe.gemm_calls(sizes, {}, 10, 2, rank=3, world=4)
    assert calls == [(32, [(4096, 4096, 10), (4096, 1024, 10),
                           (4096, 1024, 10), (4096, 4096, 10)]),
                     (1, [(4096, 32064, 2)])]
    assert moe.expert_gemms(sizes) == [(4096, 6400), (4096, 6400),
                                       (6400, 4096)]


def _traced_run():
    """A RunView over a hand-built trace of one expert layer: a span of each
    kind, one operation launched in each (the experts' two), one outside
    every span; ns on the profiler's clock."""
    program = [("moe", 0, 1000, -1, -1), ("moe.route", 10, 100, 0, -1),
               ("moe.dispatch", 100, 200, 0, -1),
               ("moe.experts", 200, 600, 0, -1), ("dense", 210, 300, 3, -1),
               ("moe.combine", 600, 700, 0, -1),
               ("moe.exchange", 700, 900, 0, -1)]
    ops = [("void router_gemm(float)", 2000, 7000),              # route
           ("dispatch_kernel", 7000, 17000),                      # dispatch
           ("void unary_mma_kernel<TubPulses, 4, 4, 2, 2>(int)", 20000,
            120020000),                                           # experts
           ("elementwise_kernel", 120020000, 120040000),          # experts
           ("index_add_kernel", 120040000, 120047000),            # combine
           ("ncclDevKernel_AllReduce_Sum_f32", 120047000, 120077000),
           ("outside", 120077000, 120127000)]
    launched = [50, 150, 250, 400, 650, 800, 2000]
    trace = spantrace.SpannedTrace(ops=ops, t0=0, t1=200000000,
                                   program=program, launched=launched)
    rec = serve.TraceRecord(index=1, requests=(traffic.Request(7, 0, 3, 2),))
    rec.tokens = {7: [1, 2]}
    sizes = moe.sizes_of(COMMITTED, LONGEST)
    # decode: layer 0's expert 0 met 3 routed rows in 2 of its calls
    counts = [[[[0, 0] for _ in range(4)] for _ in range(32)] for _ in range(2)]
    counts[0][0][0] = [3, 2]
    moe.ROUTED.clear()
    moe.ROUTED[(7,)] = counts
    return serve.RunView(setup_s=1.0, window=serve.Window([rec]), sizes=sizes,
                         bits=4, device_kind=H100, trace=trace, traced=rec,
                         family=moe, engine={}, chips=4)


def test_the_expert_readers_on_a_hand_built_trace():
    run = _traced_run()
    moe_ns = 5000 + 10000 + 120000000 + 20000 + 7000 + 30000
    exchange = manifest.reader("expert_exchange_pct.serve").read(run)
    assert exchange == pytest.approx(100.0 * 30000 / moe_ns)
    route = manifest.reader("expert_route_pct.serve").read(run)
    assert route == pytest.approx(100.0 * (5000 + 10000 + 7000) / moe_ns)
    # two calls at 3 rows: each site's weight codes twice at 4 bits and the
    # rows' codes, plus the int32 output, at 3.35 TB/s (fewer than the int8
    # peak's operations take)
    gate = ((2 * 4096 * 6400 + 3 * 4096) * 0.5 + 3 * 6400 * 4) / 3.35e12
    down = ((2 * 6400 * 4096 + 3 * 6400) * 0.5 + 3 * 4096 * 4) / 3.35e12
    roof = manifest.reader("expert_gemm_roofline").read(run)
    assert roof == pytest.approx(100.0 * (2 * gate + down) / 0.12)
    # a replayed decode step's kernels sit outside moe.experts: its count
    # goes with them, and the prefill's (none here) is left
    run.trace.program.append(("engine.decode.replay", 950, 990, -1, -1))
    assert manifest.reader("expert_gemm_roofline").read(run) == 0.0
    # the parent's port: no spans, nothing read; no count, no roofline
    bare = _traced_run()
    bare.trace.program = []
    for name in ("expert_exchange_pct.serve", "expert_route_pct.serve",
                 "expert_gemm_roofline"):
        assert manifest.reader(name).read(bare) is None
    moe.ROUTED.clear()
    assert manifest.reader("expert_gemm_roofline").read(run) is None


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """``bench/control.py`` on a smoke cell of the MoE configuration over
    two ``gloo`` ranks (4 experts each), both family faults planted."""
    root = tmp_path_factory.mktemp("checkout")
    config = dict(COMMITTED, hidden_size=128, intermediate_size=128,
                  num_hidden_layers=2, num_attention_heads=4,
                  num_key_value_heads=2, vocab_size=512, num_local_experts=8)
    wl = dict(smoke_cells.workload(CELL, "moe-smoke"), limit_s=200.0)
    # admissions enough for the check's default picks (bench/control.py)
    wl["traffic"].update(requests=16, rate=0.5)
    # the cell's gap of 3 logits is set for the full model's logits; this
    # one's are a few tenths wide, so it is judged as the dense cells are
    wl["check"] = json.loads((smoke_cells.BENCH / "workloads" /
                              "phi3-mini-3.8b.docqa.json").read_text())["check"]
    smoke_cells.checkout(root, configs={"moe-smoke": config},
                         workloads={"moe-smoke.two": (wl, 2)})
    out = subprocess.run(
        [sys.executable, "bench/control.py", "--workload", "moe-smoke.two",
         "--seeds", str(SEED), "--faults",
         ",".join(moe.FAULTS), "--device", "cpu"],
        cwd=root, capture_output=True, text=True, timeout=600)
    return out


def test_a_two_rank_smoke_cell_is_correct_and_its_faults_are_not(two_ranks):
    assert two_ranks.returncode == 0, two_ranks.stderr[-3000:]
    lines = {ln["side"]: ln for ln in map(json.loads,
                                          two_ranks.stdout.splitlines())}
    assert list(lines) == ["program", "control", *moe.FAULTS]
    assert lines["program"]["correct"], lines["program"]
    # (the TF32 control is read at the cell's own size on the card: at this
    # width its emulation flips too few layer-0 codes to mean anything)
    for side in moe.FAULTS:
        assert not lines[side]["correct"], lines[side]
