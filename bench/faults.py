"""Faults planted under the timed path of a served cell.

Each entry of :data:`FAULTS` returns a context manager that, while it is
open, breaks the port's engine where a served cell can break: a token or
an answer altered where it is produced, the step's state left unchanged,
half of the batch left out.  The fault test (``bench/tests/
test_bench_faults.py``) runs a whole run under each and sees ``correct``
come out false; ``bench/control.py --faults`` reads them at a cell's own
size on the card.  A cell on one card has no exchange between chips.
"""

from __future__ import annotations

from unittest import mock

import torch

__all__ = ["FAULTS"]


def _engine():
    from repro_torch.serving.engine import ServingEngine
    return ServingEngine


def altered_tokens():
    """Every decoded token one id off where it is produced."""
    engine = _engine()
    inner = engine._decode

    def decode(self, *args):
        logits, *rest = inner(self, *args)
        return (torch.roll(logits, 1, dims=-1), *rest)

    return mock.patch.object(engine, "_decode", decode)


def altered_first_tokens():
    """Every request's first token (the prefill's) one id off where it is
    produced."""
    engine = _engine()
    inner = engine._prefill

    def prefill(self, tokens):
        logits, k, v = inner(self, tokens)
        return torch.roll(logits, 1, dims=-1), k, v

    return mock.patch.object(engine, "_prefill", prefill)


def state_unchanged():
    """The decode step leaves the paged cache as it was (no K/V written)."""
    from repro_torch.kernels import paged_attention
    return mock.patch.object(paged_attention, "write_kv_token",
                             lambda *args, **kw: None)


def half_batch():
    """Half of each decode step's live slots left out: the upper half (in
    slot order) take the logits of the lower half."""
    engine = _engine()
    inner = engine._decode

    def decode(self, params, tokens, k_pool, v_pool, tables, lengths, active):
        logits, *rest = inner(self, params, tokens, k_pool, v_pool, tables,
                              lengths, active)
        live = torch.nonzero(active).flatten()
        lost = live[(live.numel() + 1) // 2:]
        logits = logits.clone()
        logits[lost] = logits[live[: lost.numel()]]
        return (logits, *rest)

    return mock.patch.object(engine, "_decode", decode)


FAULTS = {f.__name__: f for f in (altered_tokens, altered_first_tokens,
                                  state_unchanged, half_batch)}
