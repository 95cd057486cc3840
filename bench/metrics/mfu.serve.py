"""mfu.serve: the whole serve step's share of the card's int8 peak over the
window: the model's operations on the window's real tokens over the wall
time of the traces that ran without the profiler, against 1,979 TOP/s.

Each prompt token and each decoded token fed back costs 2 x the dense
sites' parameters, plus QK and PV over the positions it attends: 4 x heads
x head_dim x (position + 1).  The head costs 2 x its parameters once a
served token: at a prompt's last row and at each decode row, since no
other row's logits give a token.  Padding, masked positions, idle slots
and the head at other prompt rows count nothing, so no implementation can
read over 100 %.
"""

from bench import peaks


def layer_params(sizes: dict) -> int:
    """The dense sites' parameters of every layer (the head's apart)."""
    d, f = sizes["d_model"], sizes["d_ff"]
    q = sizes["num_heads"] * sizes["head_dim"]
    kv = sizes["num_kv_heads"] * sizes["head_dim"]
    return sizes["num_layers"] * (d * q + 2 * d * kv + q * d + 3 * d * f)


def token_ops(sizes: dict, position: int) -> float:
    """A token's operations through the layers at ``position``."""
    attn = 4.0 * sizes["num_heads"] * sizes["head_dim"] * (position + 1)
    return 2.0 * layer_params(sizes) + sizes["num_layers"] * attn


def head_ops(sizes: dict) -> float:
    return 2.0 * sizes["d_model"] * sizes["vocab_size"]


def window_ops(window, sizes: dict) -> float:
    total = 0.0
    for rec in window.traces:
        for r in rec.requests:
            n = len(rec.tokens[r.req_id])
            # the prompt's positions, then the n - 1 decoded tokens fed back
            for p in range(r.prompt_len + n - 1):
                total += token_ops(sizes, p)
            total += n * head_ops(sizes)
    return total


def read(run):
    window = run.untraced
    if not window.traces:
        return None
    return 100.0 * window_ops(window, run.sizes) / window.wall / peaks.peak(
        run.device_kind, "int8_ops")
