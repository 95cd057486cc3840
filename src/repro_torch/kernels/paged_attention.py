"""Gather-based paged-KV decode attention (the oracle of the fused kernel).

The serving engine keeps each request's KV history in fixed-size *pages* of
a preallocated pool — ``(num_pages, page_size, KVH, head_dim)`` per layer —
indexed through a per-request *block table* (a row of page ids).  This module
is the device-side read/write path over that layout:

* :func:`write_kv_token` scatters one new K (or V) vector per request into
  the page/slot its current length maps to — **in place** (the reference
  returns a new pool; here the pool that was passed in is updated and
  returned);
* :func:`gather_kv` materializes the per-request view ``(B, max_blocks *
  page_size, KVH, head_dim)`` by gathering pool pages through the block table;
* :func:`paged_decode_attention` runs the gathered view through the exact
  same ``naive_attention`` math as the contiguous decode path (K/V cast to
  ``q.dtype``, fp32 scores, softmax weights cast to ``v.dtype`` before the V
  product), so paged decode equals the contiguous reference exactly at fp32.
"""

from __future__ import annotations

import torch

from repro_torch.models.attention import _repeat_kv, naive_attention

__all__ = ["write_kv_token", "gather_kv", "paged_decode_attention"]


def write_kv_token(pool: torch.Tensor, block_table: torch.Tensor,
                   lengths: torch.Tensor, new: torch.Tensor,
                   page_size: int) -> torch.Tensor:
    """Scatter one new KV vector per request into its page pool, in place.

    ``pool``: (num_pages, page_size, KVH, hd); ``block_table``: (B,
    max_blocks) int32 page ids; ``lengths``: (B,) int32 — the position the
    new token lands at; ``new``: (B, KVH, hd).  Requests that should not
    write (evicted slots) must point their block-table row at the reserved
    trash page (page 0, never allocated), which absorbs their scatter
    without aliasing any live request's pages.
    """
    lengths = lengths.long()
    pages = torch.gather(block_table.long(), 1,
                         (lengths // page_size)[:, None])[:, 0]
    slots = lengths % page_size
    pool[pages, slots] = new.to(pool.dtype)
    return pool


def gather_kv(pool: torch.Tensor, block_table: torch.Tensor) -> torch.Tensor:
    """(num_pages, page_size, ...) gathered to (B, max_blocks * page_size, ...)."""
    b, max_blocks = block_table.shape
    gathered = pool[block_table.long()]    # (B, max_blocks, page_size, ...)
    return gathered.reshape(b, max_blocks * pool.shape[1], *pool.shape[2:])


def paged_decode_attention(q: torch.Tensor, pool_k: torch.Tensor,
                           pool_v: torch.Tensor, block_table: torch.Tensor,
                           kv_valid_len: torch.Tensor, *,
                           num_heads: int) -> torch.Tensor:
    """Single-token GQA decode attention over the paged KV pool.

    ``q``: (B, 1, H, hd); ``kv_valid_len``: (B,) — per-request valid history
    *including* the token written this step.  Positions past a request's
    valid length are masked to the same -1e30 the contiguous path uses.
    """
    kc = gather_kv(pool_k, block_table)
    vc = gather_kv(pool_v, block_table)
    k_full = _repeat_kv(kc.to(q.dtype), num_heads)
    v_full = _repeat_kv(vc.to(q.dtype), num_heads)
    return naive_attention(q, k_full, v_full, causal=False,
                           kv_valid_len=kv_valid_len)
