"""Weights of a configuration, made on the device from the run's seed.

The benchmark makes the weights and hands the same tensors to the program
and to the plain reference.  One ``torch.Generator`` on the device draws
every leaf in sorted-key order, one call a leaf (the stacked layers are one
leaf each), in float32, the type they are served in.  The rules are the
usual ones of a fresh model: embeddings N(0, 0.02^2), matrices LeCun-normal
(N(0, 1 / fan_in)), norm gains 1.
"""

from __future__ import annotations

import math

import torch

__all__ = ["shapes", "make_params"]


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


def make_params(sizes: dict, seed: int, device) -> dict:
    """The float32 weight tree for ``seed`` on ``device``."""
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

