"""Paged KV cache: fixed-size pages in a preallocated pool + block tables.

Layout (vLLM-style, one logical page id spanning every layer):

* two device pools of shape ``(L, num_pages, page_size, KVH, head_dim)``
  (K and V), allocated once at engine start;
* a free-list :class:`PageAllocator` over page ids ``1..num_pages-1`` —
  **page 0 is reserved as the trash page**: it is never handed out, and
  evicted batch slots point their block-table row at it so the decode
  step's scatter (which always writes all B rows) can never alias a live
  request's pages;
* per-request block tables (``list[int]`` of page ids, host side) padded
  with the trash page to the engine's static ``max_blocks`` width when
  shipped to the device.

Invariants (property-tested in ``tests/test_torch_serving.py``):

* no page id is ever owned by two live requests (no aliasing);
* ``free + sum(owned)`` is conserved at ``num_pages - 1`` across any
  alloc/free/append sequence;
* reconstructing a request's KV by walking its block table is
  element-identical to an append-only contiguous cache fed the same
  values.
"""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["OutOfPages", "PageAllocator", "PagedKVCache"]


class OutOfPages(RuntimeError):
    """Raised when an allocation asks for more pages than are free."""


class PageAllocator:
    """Free-list allocator over page ids, with ownership tracking.

    Page ids ``reserved..num_pages-1`` are allocatable; ids below
    ``reserved`` (the trash page) are never handed out.  Ownership is
    tracked per page so aliasing is an *assertion failure*, not a silent
    corruption.
    """

    def __init__(self, num_pages: int, reserved: int = 1) -> None:
        if num_pages <= reserved:
            raise ValueError(f"need more than {reserved} pages, got {num_pages}")
        self.num_pages = num_pages
        self.reserved = reserved
        self._free = list(range(num_pages - 1, reserved - 1, -1))  # pop() -> low ids first
        self._owner: dict[int, object] = {}

    @property
    def capacity(self) -> int:
        return self.num_pages - self.reserved

    @property
    def num_free(self) -> int:
        return len(self._free)

    def alloc(self, n: int, owner: object) -> list[int]:
        """Allocate ``n`` pages for ``owner``; raises :class:`OutOfPages`."""
        if n < 0:
            raise ValueError(f"cannot allocate {n} pages")
        if n > len(self._free):
            raise OutOfPages(f"requested {n} pages, {len(self._free)} free")
        pages = [self._free.pop() for _ in range(n)]
        for p in pages:
            assert p not in self._owner, f"page {p} double-allocated"
            self._owner[p] = owner
        return pages

    def free(self, pages: list[int], owner: object) -> None:
        for p in pages:
            assert self._owner.get(p) == owner, \
                f"page {p} freed by {owner!r} but owned by {self._owner.get(p)!r}"
            del self._owner[p]
            self._free.append(p)

    def owner_of(self, page: int):
        return self._owner.get(page)


class PagedKVCache:
    """Preallocated paged KV pools + per-request block tables.

    ``k_pool`` / ``v_pool`` are tensors ``(L, num_pages, page_size, KVH,
    head_dim)`` on ``device``, allocated once.  Every write — prefill,
    append, the decode step's scatter — updates them **in place** (the
    reference threads functional copies through its jitted step;
    ``sync_pools`` is kept for that call shape and adopts whatever it is
    handed).  Host-side bookkeeping (block tables, lengths, the allocator)
    stays in plain Python — the device never sees a page id that the
    allocator has not handed out.

    ``pools`` — the ``(k_pool, v_pool)`` of an earlier cache of the same
    shape and dtype on ``device``, zeroed in place and taken over instead of
    allocating new ones (the serving engine keeps one pair across its runs,
    so that a decode step captured against them stays valid).
    """

    def __init__(self, *, num_layers: int, num_kv_heads: int, head_dim: int,
                 num_pages: int, page_size: int, max_seq_len: int,
                 dtype: torch.dtype = torch.float32, device="cuda",
                 pools: tuple[torch.Tensor, torch.Tensor] | None = None) -> None:
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        self.num_layers = num_layers
        self.num_pages = num_pages
        self.page_size = page_size
        self.max_blocks = max(1, math.ceil(max_seq_len / page_size))
        self.max_seq_len = self.max_blocks * page_size
        shape = (num_layers, num_pages, page_size, num_kv_heads, head_dim)
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("PagedKVCache(device='cuda') needs a CUDA "
                               "device; pass device='cpu' to run on the CPU")
        self.device = device
        if pools is None:
            self.k_pool = torch.zeros(shape, dtype=dtype, device=device)
            self.v_pool = torch.zeros(shape, dtype=dtype, device=device)
        else:
            for pool in pools:
                if tuple(pool.shape) != shape or pool.dtype != dtype:
                    raise ValueError(f"pools of {tuple(pool.shape)} "
                                     f"{pool.dtype} cannot hold a {shape} "
                                     f"{dtype} cache")
            self.k_pool, self.v_pool = (pool.zero_() for pool in pools)
        self.allocator = PageAllocator(num_pages)
        self.block_tables: dict[object, list[int]] = {}
        self.lengths: dict[object, int] = {}

    # -- allocation ---------------------------------------------------------

    def pages_needed(self, total_len: int) -> int:
        return math.ceil(total_len / self.page_size)

    def can_allocate(self, total_len: int) -> bool:
        return self.pages_needed(total_len) <= self.allocator.num_free

    def allocate(self, req_id, total_len: int) -> list[int]:
        """Reserve pages covering ``total_len`` positions for ``req_id``."""
        if req_id in self.block_tables:
            raise ValueError(f"request {req_id!r} already has pages")
        if total_len > self.max_seq_len:
            raise ValueError(f"request {req_id!r} needs {total_len} positions, "
                             f"cache max_seq_len is {self.max_seq_len}")
        pages = self.allocator.alloc(self.pages_needed(total_len), req_id)
        self.block_tables[req_id] = pages
        self.lengths[req_id] = 0
        return pages

    def free_request(self, req_id) -> None:
        self.allocator.free(self.block_tables.pop(req_id), req_id)
        del self.lengths[req_id]

    # -- device views -------------------------------------------------------

    def block_table_row(self, req_id=None) -> np.ndarray:
        """(max_blocks,) int32 row — trash-page padded; all-trash if None."""
        row = np.zeros(self.max_blocks, np.int32)
        if req_id is not None:
            pages = self.block_tables[req_id]
            row[: len(pages)] = pages
        return row

    def sync_pools(self, k_pool, v_pool) -> None:
        """Adopt the pools a decode step returned (the same tensors, since
        the step scatters in place)."""
        self.k_pool = k_pool
        self.v_pool = v_pool

    # -- host-side writes (prefill, property tests) --------------------------

    def write_prefill(self, req_id, k: torch.Tensor, v: torch.Tensor) -> None:
        """Write a prompt's KV — ``k``/``v``: (L, S, KVH, hd) — into pages."""
        k, v = torch.as_tensor(k), torch.as_tensor(v)
        s = int(k.shape[1])
        pages = self.block_tables[req_id]
        ps = self.page_size
        assert s <= len(pages) * ps, "prefill longer than the reservation"
        for j in range(math.ceil(s / ps)):
            lo, hi = j * ps, min((j + 1) * ps, s)
            self.k_pool[:, pages[j], : hi - lo] = k[:, lo:hi].to(self.k_pool.dtype)
            self.v_pool[:, pages[j], : hi - lo] = v[:, lo:hi].to(self.v_pool.dtype)
        self.lengths[req_id] = s

    def append_token(self, req_id, k: torch.Tensor, v: torch.Tensor) -> None:
        """Append one position — ``k``/``v``: (L, KVH, hd) — host-side.

        The decode step performs the same page/slot scatter on
        device (``kernels.paged_attention.write_kv_token``); this method is
        the host mirror the property tests drive.
        """
        pos = self.lengths[req_id]
        pages = self.block_tables[req_id]
        assert pos < len(pages) * self.page_size, "append past the reservation"
        page, slot = pages[pos // self.page_size], pos % self.page_size
        self.k_pool[:, page, slot] = torch.as_tensor(k).to(self.k_pool)
        self.v_pool[:, page, slot] = torch.as_tensor(v).to(self.v_pool)
        self.lengths[req_id] = pos + 1

    def gather_request(self, req_id) -> tuple[np.ndarray, np.ndarray]:
        """Reconstruct (L, len, KVH, hd) K/V by walking the block table."""
        n = self.lengths[req_id]
        pages = self.block_tables[req_id]
        kp = self.k_pool[:, pages].float().cpu().numpy()  # (L, blocks, page, KVH, hd)
        vp = self.v_pool[:, pages].float().cpu().numpy()
        flat = kp.reshape(kp.shape[0], -1, *kp.shape[3:])
        flatv = vp.reshape(vp.shape[0], -1, *vp.shape[3:])
        return flat[:, :n], flatv[:, :n]
