"""mfu.serve: the whole serve step's share of the cards' int8 peak over the
window: the model's operations on the window's real tokens over the wall
time of the traces that ran without the profiler, against 1,979 TOP/s a
card times the cards the cell holds.

The cell's family module counts the work (``bench/families/``): each
prompt token and each decoded token fed back costs ``token_ops`` at its
position (the dense family: 2 x the dense sites' parameters, plus QK and
PV over the positions it attends, 4 x heads x head_dim x (position + 1)).
The head costs ``head_ops`` once a served token: at a prompt's last row
and at each decode row, since no other row's logits give a token.
Padding, masked positions, idle slots and the head at other prompt rows
count nothing, so no implementation can read over 100 %.
"""

from bench import peaks
from bench.families import dense


def layer_params(sizes: dict, family=dense) -> int:
    """The dense sites' parameters of every layer (the head's apart)."""
    return family.layer_params(sizes)


def token_ops(sizes: dict, position: int, family=dense) -> float:
    """A token's operations through the layers at ``position``."""
    return family.token_ops(sizes, position)


def head_ops(sizes: dict, family=dense) -> float:
    return family.head_ops(sizes)


def window_ops(window, sizes: dict, family=dense) -> float:
    total = 0.0
    for rec in window.traces:
        for r in rec.requests:
            n = len(rec.tokens[r.req_id])
            # the prompt's positions, then the n - 1 decoded tokens fed back
            for p in range(r.prompt_len + n - 1):
                total += family.token_ops(sizes, p)
            total += n * family.head_ops(sizes)
    return total


def read(run):
    window = run.untraced
    if not window.traces:
        return None
    return 100.0 * window_ops(window, run.sizes, run.family) / window.wall / (
        run.chips * peaks.peak(run.device_kind, "int8_ops"))
