"""The moe family: a mixture-of-experts decoder served with expert
parallelism, Phi-3.5-MoE's layer (GQA attention, sparsemixer top-2 over
SwiGLU experts on silu, no shared expert, RMSNorm, full RoPE, an untied
head, no biases), every dense site on the unary GEMM, the routed experts'
included.

A cell of ``chips`` cards serves ``E / chips`` experts of every layer on
each card (``ServingEngine`` under a process group: one ``all_reduce`` a
layer), the attention, router, embedding and head replicated.  The weights
are made on the device from the run's seed, in float32, the type they are
served in: the replicated leaves by one ``torch.Generator`` in sorted-key
order, one call a leaf, as the dense family draws them; each expert's
``w_down`` / ``w_gate`` / ``w_up`` (all layers, one call) by a generator of
its own, seeded by (seed, leaf, global expert), so that a rank draws only
its own experts and its slices equal those of the tree drawn whole.  The
rules are a fresh model's: embeddings N(0, 0.02^2), matrices LeCun-normal
(N(0, 1 / fan_in)), norm gains 1.

What the readers count: ``token_ops`` and ``head_ops`` the integer sites'
operations (attention's, the head's, and 3 matmuls of each of a token's
top-2 experts; the float router is not counted); ``gemm_calls`` the
attention sites and the head, the same on every rank; the routed experts'
rows are the engine's to count (``routed_rows``), and
``expert_gemm_roofline`` reads them.
"""

from __future__ import annotations

import math
from unittest import mock

import numpy as np
import torch

from bench.families import dense

__all__ = ["UNSERVED", "SETTLED", "refuse_unserved", "sizes_of",
           "port_config", "shapes", "make_params", "build", "routed_rows",
           "expert_gemms", "layer_params", "token_ops", "head_ops",
           "gemm_calls", "FAULTS"]

#: published keys that change the model when they are set: each must be
#: absent, null or false
UNSERVED = ("mlp_bias", "bias", "qkv_bias", "use_bias", "n_shared_experts",
            "num_shared_experts", "shared_expert_intermediate_size",
            "kv_lora_rank", "q_lora_rank", "layer_types",
            "use_sliding_window", "use_qk_norm", "qk_layernorm")
#: published keys the port departs from, accepted only where the file's
#: ``assumed`` names them (the departure is then the file's statement)
SETTLED = ("attention_bias", "lm_head_bias")
#: the expert leaves, in the order they are drawn
EXPERT_LEAVES = ("w_down", "w_gate", "w_up")


def refuse_unserved(config: dict, longest: int | None) -> None:
    """Raise ``ManifestError`` where a published key or value asks for what
    the port's serving expert layer and ``bench/reference_moe.py`` do not
    implement: top-k other than 2, a shared expert, ``hidden_act`` other
    than silu, a tied head, a window or a RoPE scaling acting within the
    ``longest`` positions a request holds (None: any), biases the file's
    ``assumed`` does not settle."""
    from bench.manifest import ManifestError
    name = config.get("name", "?")
    assumed = config.get("assumed", {})

    def no(why: str):
        raise ManifestError(f"configuration {name!r}: {why}; the port's "
                            f"serving expert layer and its reference serve "
                            f"another model")

    if config.get("hidden_act") != "silu":
        no(f"hidden_act {config.get('hidden_act')!r}, not 'silu'")
    if config.get("tie_word_embeddings") is not False:
        no(f"tie_word_embeddings {config.get('tie_word_embeddings')!r}, not "
           f"false (the head is a matrix of its own)")
    if not config.get("num_local_experts"):
        no("no num_local_experts")
    if config.get("num_experts_per_tok") != 2:
        no(f"num_experts_per_tok {config.get('num_experts_per_tok')!r}, not "
           f"2 (sparsemixer routes top-2)")
    for key in UNSERVED:
        if config.get(key):
            no(f"{key} {config[key]!r}")
    for key in SETTLED:
        if config.get(key) and key not in assumed:
            no(f"{key} {config[key]!r}, which the file's assumed does not "
               f"settle")
    if float(config.get("partial_rotary_factor", 1.0)) != 1.0:
        no(f"partial_rotary_factor {config['partial_rotary_factor']!r}")
    window = config.get("sliding_window")
    if window is not None and (longest is None or int(window) < longest):
        no(f"sliding_window {window} under the {longest} positions a "
           f"request holds")
    scaling = config.get("rope_scaling")
    if scaling is not None:
        kind = scaling.get("rope_type", scaling.get("type"))
        short = int(scaling.get("original_max_position_embeddings", 0))
        # LongRoPE's long factors act above its original positions; below,
        # the file's assumed puts plain RoPE in place of the short factors
        if kind != "longrope" or "rope_scaling" not in assumed \
                or longest is None or longest > short:
            no(f"rope_scaling {kind!r} acting within the {longest} positions "
               f"a request holds")


def sizes_of(config: dict, longest: int | None = None) -> dict:
    """The model sizes of a configuration file's published keys, once
    :func:`refuse_unserved` has passed them."""
    refuse_unserved(config, longest)
    d, h = int(config["hidden_size"]), int(config["num_attention_heads"])
    return {
        "d_model": d,
        "d_ff_expert": int(config["intermediate_size"]),
        "num_layers": int(config["num_hidden_layers"]),
        "num_heads": h,
        "num_kv_heads": int(config["num_key_value_heads"]),
        "head_dim": int(config.get("head_dim", d // h)),
        "vocab_size": int(config["vocab_size"]),
        "rope_theta": float(config["rope_theta"]),
        "rms_eps": float(config["rms_norm_eps"]),
        "num_experts": int(config["num_local_experts"]),
        "top_k": int(config["num_experts_per_tok"]),
        "jitter_eps": float(config["router_jitter_noise"]),
    }


def port_config(name: str, sizes: dict):
    """The port's ``ModelConfig`` of these sizes, computing in float32 and
    routing by sparsemixer."""
    from repro_torch.models.config import ModelConfig, SparseMixerMoEConfig
    return ModelConfig(
        arch_id=name, family="moe", num_layers=sizes["num_layers"],
        d_model=sizes["d_model"], num_heads=sizes["num_heads"],
        num_kv_heads=sizes["num_kv_heads"], head_dim=sizes["head_dim"],
        d_ff=sizes["d_ff_expert"], vocab_size=sizes["vocab_size"],
        activation="swiglu", rope_theta=sizes["rope_theta"],
        rms_eps=sizes["rms_eps"], compute_dtype="float32",
        param_dtype="float32", remat=False,
        moe=SparseMixerMoEConfig(num_experts=sizes["num_experts"],
                                 top_k=sizes["top_k"],
                                 d_ff_expert=sizes["d_ff_expert"],
                                 router_noise=sizes["jitter_eps"]))


# -- weights ------------------------------------------------------------------

def shapes(sizes: dict) -> dict:
    """The tree of the replicated leaves' shapes, with each leaf's fan-in
    (None: not drawn), and under ``layers/moe`` the shape of one expert's
    leaf over every layer."""
    d, f, v = sizes["d_model"], sizes["d_ff_expert"], sizes["vocab_size"]
    h, kvh, hd = sizes["num_heads"], sizes["num_kv_heads"], sizes["head_dim"]
    n = sizes["num_layers"]
    return {
        "embed": ((v, d), "embed"),
        "final_norm": ((d,), None),
        "lm_head": ((d, v), d),
        "layers": {
            "ln1": ((n, d), None),
            "ln2": ((n, d), None),
            "attn": {
                "wq": ((n, d, h, hd), d),
                "wk": ((n, d, kvh, hd), d),
                "wv": ((n, d, kvh, hd), d),
                "wo": ((n, h, hd, d), h * hd),
            },
            "moe": {
                "router": ((n, d, sizes["num_experts"]), d),
                "w_down": ((n, f, d), f),
                "w_gate": ((n, d, f), d),
                "w_up": ((n, d, f), d),
            },
        },
    }


def _expert_seed(seed: int, leaf: str, expert: int) -> int:
    """The seed of one expert's leaf: (seed, leaf, global expert) mixed."""
    state = np.random.SeedSequence(
        [int(seed), EXPERT_LEAVES.index(leaf), int(expert)]).generate_state(
            2, np.uint32)
    return (int(state[0]) << 31) ^ int(state[1])


def _draw(shape, gen, fan_in, device) -> torch.Tensor:
    if fan_in is None:
        return torch.ones(shape, dtype=torch.float32, device=device)
    out = torch.randn(shape, generator=gen, dtype=torch.float32,
                      device=device)
    return out.mul_(0.02 if fan_in == "embed" else 1.0 / math.sqrt(fan_in))


def make_params(sizes: dict, seed: int, device, rank: int = 0,
                world: int = 1) -> dict:
    """The float32 weight tree of rank ``rank`` of ``world`` for ``seed``
    on ``device``: every replicated leaf, and the rank's ``E / world``
    experts (global ``rank * E / world`` onwards) stacked as ``(L,
    E / world, ...)`` under ``layers/moe``."""
    e = sizes["num_experts"]
    if e % world:
        raise ValueError(f"{e} experts do not split over {world} ranks")
    local = e // world
    tree = shapes(sizes)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))

    def draw(node, path=()):
        if isinstance(node, dict):
            return {k: draw(node[k], path + (k,)) for k in sorted(node)}
        shape, fan_in = node
        if path[-2:-1] != ("moe",) or path[-1] == "router":
            return _draw(shape, gen, fan_in, device)
        out = torch.empty((shape[0], local, *shape[1:]), dtype=torch.float32,
                          device=device)
        for j in range(local):
            own = torch.Generator(device=device)
            own.manual_seed(_expert_seed(seed, path[-1], rank * local + j))
            out[:, j] = _draw(shape, own, fan_in, device)
        return out

    return draw(tree)


#: the engine's ``expert_rows`` of each trace it served, by the trace's
#: request ids (``routed_rows``); emptied by every ``build``
ROUTED: dict = {}


def build(cell: dict, sizes: dict, seed: int, device, rank: int = 0,
          world: int = 1):
    """(weights, engine) of a cell for ``seed``: rank ``rank``'s experts,
    the engine serving them with expert parallelism over ``world`` ranks
    (its process group up).  The engine's counter of routed rows is kept
    for each trace it serves (:func:`routed_rows`)."""
    from repro_torch.serving.engine import ServingEngine
    from bench.manifest import ManifestError
    eng = cell["engine"]
    if eng.get("grid") is not None:
        raise ManifestError("an moe cell's cards hold experts, not a grid "
                            f"(got engine grid {eng['grid']})")
    params = make_params(sizes, seed, device, rank, world)
    engine = ServingEngine(
        port_config(cell["config"], sizes), params,
        max_batch=eng["max_batch"], page_size=eng["page_size"],
        num_pages=eng["num_pages"], max_seq_len=eng["max_seq_len"],
        backend=eng["backend"], bits=eng["bits"], packed=eng["packed"],
        attention=eng["attention"], prompt_seed=int(seed), device=device)
    ROUTED.clear()
    run = engine.run

    def counted(trace, scheduler="continuous"):
        report = run(trace, scheduler)
        ROUTED[tuple(r.req_id for r in trace)] = report.expert_rows
        return report

    engine.run = counted
    return params, engine


def routed_rows(record):
    """The engine's ``expert_rows`` of the served trace ``record`` (a
    ``serve.TraceRecord``): [decode, prefill] x layer x local expert x
    (routed rows, calls with a routed row); None where it kept none."""
    return ROUTED.get(tuple(r.req_id for r in record.requests)) or None


# -- the work the readers count -----------------------------------------------

def expert_gemms(sizes: dict) -> list:
    """(K, N) of an expert's three sites: ``w_gate``, ``w_up``, ``w_down``."""
    d, f = sizes["d_model"], sizes["d_ff_expert"]
    return [(d, f), (d, f), (f, d)]


def _attention_sites(sizes: dict) -> list:
    d = sizes["d_model"]
    q = sizes["num_heads"] * sizes["head_dim"]
    kv = sizes["num_kv_heads"] * sizes["head_dim"]
    return [(d, q), (d, kv), (d, kv), (q, d)]


def layer_params(sizes: dict) -> int:
    """The integer sites' parameters a token meets in every layer (the
    head's apart): attention's and its top-k experts'."""
    per = sum(k * n for k, n in _attention_sites(sizes))
    per += sizes["top_k"] * sum(k * n for k, n in expert_gemms(sizes))
    return sizes["num_layers"] * per


def token_ops(sizes: dict, position: int) -> float:
    """A token's operations through the layers at ``position``: 2 x the
    sites' parameters it meets, plus QK and PV over the positions it
    attends."""
    attn = 4.0 * sizes["num_heads"] * sizes["head_dim"] * (position + 1)
    return 2.0 * layer_params(sizes) + sizes["num_layers"] * attn


def head_ops(sizes: dict) -> float:
    return dense.head_ops(sizes)


def gemm_calls(sizes: dict, engine: dict, rows: int, head_rows: int,
               rank: int = 0, world: int = 1) -> list:
    """``[(times, [(K, N, rows), ...])]``: the attention sites of every
    layer at ``rows`` rows and the head at ``head_rows``, the same on every
    rank; the experts' rows depend on the routing (:func:`routed_rows`)."""
    layer = [(k, n, rows) for k, n in _attention_sites(sizes)]
    return [(sizes["num_layers"], layer),
            (1, [(sizes["d_model"], sizes["vocab_size"], head_rows)])]


# -- faults of the expert layer (bench/control.py --faults) -------------------

def exchange_broadcast():
    """The exchange replaced by a broadcast of rank 0's part: the ranks
    agree, and each token lacks the experts the other ranks hold."""
    from repro_torch.launch import collectives as coll
    from repro_torch.models import moe as moe_lib

    def broadcast(out, mesh):
        group = coll.axis_group(mesh, "model")
        if group is not None:
            torch.distributed.broadcast(out, src=0, group=group)
        return out

    return mock.patch.object(moe_lib, "_exchange", broadcast)


def softmax_routing():
    """Softmax top-2, renormalized, in place of sparsemixer: the same
    experts, other weights."""
    from repro_torch.models import moe as moe_lib

    def route(logits, eps):
        probs = torch.softmax(logits, dim=-1)
        w, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
        w, idx = w[:, :2], idx[:, :2]
        return idx, w / w.sum(dim=-1, keepdim=True)

    return mock.patch.object(moe_lib, "sparsemixer", route)


FAULTS = {f.__name__: f for f in (exchange_broadcast, softmax_routing)}
