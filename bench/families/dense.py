"""The dense family: the port's dense GQA decoder (SwiGLU on silu, RMSNorm,
full RoPE, an untied head, no biases), every dense site on the unary GEMM.

The weights are made on the device from the run's seed, and the same
tensors go to the program and to the plain reference.  One
``torch.Generator`` on the device draws every leaf in sorted-key order, one
call a leaf (the stacked layers are one leaf each), in float32, the type
they are served in.  The rules are the usual ones of a fresh model:
embeddings N(0, 0.02^2), matrices LeCun-normal (N(0, 1 / fan_in)), norm
gains 1.  Every rank of a cell on several cards holds the whole tree: the
engine's grid (the workload's ``engine.grid``, one unit a card) shards the
weight codes, not the float weights.
"""

from __future__ import annotations

import math

import torch

__all__ = ["UNSERVED", "refuse_unserved", "sizes_of", "port_config",
           "shapes", "make_params", "build", "layer_params", "token_ops",
           "head_ops", "gemm_calls"]

#: published keys that change the model when they are set: each must be
#: absent, null or false, or the port and the reference would serve another
#: model than the file describes
UNSERVED = ("attention_bias", "mlp_bias", "bias", "qkv_bias", "use_bias",
            "num_local_experts", "num_experts", "n_routed_experts",
            "kv_lora_rank", "q_lora_rank", "layer_types", "use_sliding_window",
            "use_qk_norm", "qk_layernorm")


def refuse_unserved(config: dict, longest: int | None) -> None:
    """Raise ``ManifestError`` where a published key or value asks for what
    the port's dense serve path and the plain reference do not implement
    (both: SwiGLU on silu, an untied head, no biases, full RoPE, full causal
    attention).  ``longest``: the most positions a request holds (None: any
    sliding window or RoPE scaling is refused)."""
    from bench.manifest import ManifestError
    name = config.get("name", "?")

    def no(why: str):
        raise ManifestError(f"configuration {name!r}: {why}; the port's "
                            f"serve path and bench/reference.py serve "
                            f"another model")

    if config.get("hidden_act") != "silu":
        no(f"hidden_act {config.get('hidden_act')!r}, not 'silu'")
    if config.get("tie_word_embeddings") is not False:
        no(f"tie_word_embeddings {config.get('tie_word_embeddings')!r}, not "
           f"false (the head is a matrix of its own)")
    for key in UNSERVED:
        if config.get(key):
            no(f"{key} {config[key]!r}")
    if float(config.get("partial_rotary_factor", 1.0)) != 1.0:
        no(f"partial_rotary_factor {config['partial_rotary_factor']!r}")
    window = config.get("sliding_window")
    if window is not None and (longest is None or int(window) < longest):
        no(f"sliding_window {window} under the {longest} positions a "
           f"request holds")
    scaling = config.get("rope_scaling")
    if scaling is not None:
        kind = scaling.get("rope_type", scaling.get("type"))
        reach = int(config.get("max_position_embeddings", 0))
        # dynamic NTK scaling starts above max_position_embeddings
        if kind != "dynamic" or longest is None or longest > reach:
            no(f"rope_scaling {scaling!r} acting within the {longest} "
               f"positions a request holds")


def sizes_of(config: dict, longest: int | None = None) -> dict:
    """The model sizes of a configuration file's published keys, once
    :func:`refuse_unserved` has passed them."""
    refuse_unserved(config, longest)
    d, h = int(config["hidden_size"]), int(config["num_attention_heads"])
    return {
        "d_model": d,
        "d_ff": int(config["intermediate_size"]),
        "num_layers": int(config["num_hidden_layers"]),
        "num_heads": h,
        "num_kv_heads": int(config["num_key_value_heads"]),
        "head_dim": int(config.get("head_dim", d // h)),
        "vocab_size": int(config["vocab_size"]),
        "rope_theta": float(config["rope_theta"]),
        "rms_eps": float(config["rms_norm_eps"]),
    }


def port_config(name: str, sizes: dict):
    """The port's ``ModelConfig`` of these sizes, computing in float32."""
    from repro_torch.models.config import ModelConfig
    return ModelConfig(
        arch_id=name, family="dense", num_layers=sizes["num_layers"],
        d_model=sizes["d_model"], num_heads=sizes["num_heads"],
        num_kv_heads=sizes["num_kv_heads"], head_dim=sizes["head_dim"],
        d_ff=sizes["d_ff"], vocab_size=sizes["vocab_size"],
        activation="swiglu", rope_theta=sizes["rope_theta"],
        rms_eps=sizes["rms_eps"], compute_dtype="float32",
        param_dtype="float32", remat=False)


# -- weights ------------------------------------------------------------------

def shapes(sizes: dict) -> dict:
    """The tree of leaf shapes, with each leaf's fan-in (None: not drawn)."""
    d, f, v = sizes["d_model"], sizes["d_ff"], sizes["vocab_size"]
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
            "mlp": {
                "w_gate": ((n, d, f), d),
                "w_up": ((n, d, f), d),
                "w_down": ((n, f, d), f),
            },
        },
    }


def make_params(sizes: dict, seed: int, device, rank: int = 0,
                world: int = 1) -> dict:
    """The float32 weight tree for ``seed`` on ``device``: the whole tree
    on every rank."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))

    def draw(node):
        if isinstance(node, dict):
            return {k: draw(node[k]) for k in sorted(node)}
        shape, fan_in = node
        if fan_in is None:
            return torch.ones(shape, dtype=torch.float32, device=device)
        out = torch.randn(shape, generator=gen, dtype=torch.float32,
                          device=device)
        std = 0.02 if fan_in == "embed" else 1.0 / math.sqrt(fan_in)
        return out.mul_(std)

    return draw(shapes(sizes))


def _grid(engine: dict, world: int) -> tuple | None:
    """The engine's ``(units_x, units_y)`` grid, None for none; on several
    ranks a grid of one unit a rank is required."""
    grid = engine.get("grid")
    if grid is not None:
        grid = (int(grid[0]), int(grid[1]))
    if world > 1 and (grid is None or grid[0] * grid[1] != world):
        from bench.manifest import ManifestError
        raise ManifestError(f"a dense cell on {world} cards needs an engine "
                            f"grid of {world} units, one a card (got "
                            f"{grid})")
    return grid


def build(cell: dict, sizes: dict, seed: int, device, rank: int = 0,
          world: int = 1):
    """(weights, engine) of a cell for ``seed``."""
    from repro_torch.serving.engine import ServingEngine
    eng = cell["engine"]
    grid = _grid(eng, world)
    params = make_params(sizes, seed, device, rank, world)
    engine = ServingEngine(
        port_config(cell["config"], sizes), params,
        max_batch=eng["max_batch"], page_size=eng["page_size"],
        num_pages=eng["num_pages"], max_seq_len=eng["max_seq_len"],
        backend=eng["backend"], bits=eng["bits"], packed=eng["packed"],
        attention=eng["attention"], grid=grid, prompt_seed=int(seed),
        device=device)
    return params, engine


# -- the work the readers count -----------------------------------------------

def layer_params(sizes: dict) -> int:
    """The dense sites' parameters of every layer (the head's apart)."""
    d, f = sizes["d_model"], sizes["d_ff"]
    q = sizes["num_heads"] * sizes["head_dim"]
    kv = sizes["num_kv_heads"] * sizes["head_dim"]
    return sizes["num_layers"] * (d * q + 2 * d * kv + q * d + 3 * d * f)


def token_ops(sizes: dict, position: int) -> float:
    """A token's operations through the layers at ``position``: 2 x the
    dense sites' parameters, plus QK and PV over the positions it attends."""
    attn = 4.0 * sizes["num_heads"] * sizes["head_dim"] * (position + 1)
    return 2.0 * layer_params(sizes) + sizes["num_layers"] * attn


def head_ops(sizes: dict) -> float:
    return 2.0 * sizes["d_model"] * sizes["vocab_size"]


def _shards(k: int, n: int, grid: tuple | None, rank: int,
            world: int) -> list:
    """(K, N) of the blocks of a (K, N) site that one process contracts:
    the whole site without a grid; with one, the grid's ceil split of K over
    ``gx`` and N over ``gy`` (``backends/grid.py:shard_slices``), every
    block on one process and the rank's own (row-major) on several."""
    if grid is None:
        return [(k, n)]
    gx, gy = grid
    ks, ns = -(-k // gx), -(-n // gy)
    coords = ([divmod(rank, gy)] if world > 1
              else [(i, j) for i in range(gx) for j in range(gy)])
    out = []
    for i, j in coords:
        kk = min((i + 1) * ks, k) - i * ks
        nn = min((j + 1) * ns, n) - j * ns
        if kk > 0 and nn > 0:
            out.append((kk, nn))
    return out


def gemm_calls(sizes: dict, engine: dict, rows: int, head_rows: int,
               rank: int = 0, world: int = 1) -> list:
    """``[(times, [(K, N, rows), ...])]``: one serve call's integer GEMMs on
    rank ``rank``: every layer's seven dense sites at ``rows`` rows, the
    head at ``head_rows``."""
    d, f = sizes["d_model"], sizes["d_ff"]
    q = sizes["num_heads"] * sizes["head_dim"]
    kv = sizes["num_kv_heads"] * sizes["head_dim"]
    grid = _grid(engine, world)
    layer = [(kk, nn, rows)
             for k, n in ((d, q), (d, kv), (d, kv), (q, d), (d, f), (d, f),
                          (f, d))
             for kk, nn in _shards(k, n, grid, rank, world)]
    head = [(kk, nn, head_rows) for kk, nn in
            _shards(d, sizes["vocab_size"], grid, rank, world)]
    return [(sizes["num_layers"], layer), (1, head)]
