"""Fused block-table paged-decode GQA attention (flash-style page walk).

Replaces the TPU kernel
``repro/kernels/paged_attention_fused.py:_fused_decode_kernel`` with
``csrc/fused_paged_decode.cu``.  The gather path
(:mod:`repro_torch.kernels.paged_attention`) materializes the whole padded
per-request KV view every decode step and repeats it H/KVH-fold; the fused
kernel walks each request's block table page by page with an online softmax
(fp32 running max / denominator / accumulator), groups the H query heads per
KV head so pages are contracted as stored, masks past the valid length with
``-1e30``, and never dereferences a page past ``ceil(len / page_size)``.

Bound on an H100: the live K/V bytes, read once (memory) —
:func:`fused_decode_bytes_moved`.  The design gives one block to each
(request, KV head) pair, which loops over that request's pages and stages
them through shared memory; splitting the context across blocks is later
work.

Beside the kernel wrapper sits the plain version
(:func:`fused_decode_plain`): the same page walk written with tensor ops.
The wrapper takes it only for CPU tensors; a CUDA tensor launches the kernel
or raises.  Online softmax re-associates the reduction, so the contract
against the gather oracle is a gated max |Δ|, not bit-exactness.
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build

__all__ = ["fused_paged_decode_attention", "fused_decode_plain",
           "fused_decode_bytes_moved", "gather_decode_bytes_moved",
           "LAUNCHES", "reset_launches"]

#: kernel launches since the last :func:`reset_launches`
LAUNCHES = {"fused_paged_decode": 0}

_MASK = -1e30  # same fill as models.attention.naive_attention
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def reset_launches() -> None:
    LAUNCHES["fused_paged_decode"] = 0


def _check_shapes(q, pool_k, pool_v, block_table, kv_valid_len, num_heads):
    if q.ndim != 4 or q.shape[1] != 1:
        raise ValueError(f"q must be (B, 1, H, hd), got {tuple(q.shape)}")
    if pool_k.shape != pool_v.shape or pool_k.ndim != 4:
        raise ValueError(f"pools must share (P, page, KVH, hd): "
                         f"{tuple(pool_k.shape)} vs {tuple(pool_v.shape)}")
    kvh = pool_k.shape[2]
    if q.shape[2] != num_heads or num_heads % kvh:
        raise ValueError(f"num_heads {num_heads} must match q heads "
                         f"{q.shape[2]} and divide by KV heads {kvh}")
    if q.shape[3] != pool_k.shape[3]:
        raise ValueError(f"head_dim mismatch: q {q.shape[3]} vs pools "
                         f"{pool_k.shape[3]}")
    if block_table.ndim != 2 or block_table.shape[0] != q.shape[0]:
        raise ValueError(f"block_table batch {tuple(block_table.shape)} != "
                         f"q batch {q.shape[0]}")
    if kv_valid_len.shape != (q.shape[0],):
        raise ValueError(f"kv_valid_len must be (B,), got "
                         f"{tuple(kv_valid_len.shape)}")


def fused_decode_plain(q, pool_k, pool_v, block_table, kv_valid_len, *,
                       num_heads: int) -> torch.Tensor:
    """The kernel's page walk as plain tensor ops (any device).

    Steps ``j = 0 .. max(ceil(len / page)) - 1`` over the batch; at each step
    every request still inside its history reads page ``block_table[b, j]``
    (requests past their last page read nothing — their slot is redirected
    to a page they own and their update is discarded), scores it in fp32 at
    KV-head width, and folds it into the running max / denominator /
    accumulator exactly as the kernel does.
    """
    batch, _, h, hd = q.shape
    _, page, kvh, _ = pool_k.shape
    g = h // kvh
    dev = q.device
    valid = kv_valid_len.to(device=dev, dtype=torch.long)
    n_blocks = (valid + page - 1) // page
    bt = block_table.to(device=dev, dtype=torch.long)
    qg = q[:, 0].to(torch.float32).reshape(batch, kvh, g, hd)
    m = torch.full((batch, kvh, g), -math.inf, dtype=torch.float32, device=dev)
    l = torch.zeros((batch, kvh, g), dtype=torch.float32, device=dev)
    acc = torch.zeros((batch, kvh, g, hd), dtype=torch.float32, device=dev)
    tok = torch.arange(page, device=dev)
    rows = torch.arange(batch, device=dev)
    mask_fill = torch.full((), _MASK, dtype=torch.float32, device=dev)
    for j in range(int(n_blocks.max()) if batch else 0):
        live = j < n_blocks                                       # (B,)
        jj = torch.minimum(torch.full_like(n_blocks, j), n_blocks - 1)
        pid = bt[rows, jj]                                        # live pages only
        k = pool_k[pid].to(torch.float32)                         # (B,page,KVH,hd)
        v = pool_v[pid].to(torch.float32)
        in_len = (j * page + tok)[None, :] < valid[:, None]       # (B,page)
        v = torch.where(in_len[:, :, None, None], v, torch.zeros_like(v))
        s = torch.einsum("bkgd,btkd->bkgt", qg, k) / math.sqrt(hd)
        s = torch.where(in_len[:, None, None, :], s, mask_fill)
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l_new = alpha * l + p.sum(dim=-1)
        acc_new = alpha[..., None] * acc + torch.einsum("bkgt,btkd->bkgd", p, v)
        keep = live[:, None, None]
        m = torch.where(keep, m_new, m)
        l = torch.where(keep, l_new, l)
        acc = torch.where(keep[..., None], acc_new, acc)
    out = acc / l[..., None]
    return out.reshape(batch, 1, h, hd).to(q.dtype)


def _launch(q, pool_k, pool_v, block_table, kv_valid_len, num_heads):
    for name, t in (("q", q), ("pool_k", pool_k), ("pool_v", pool_v)):
        if t.dtype not in _DTYPE_CODE:
            raise TypeError(f"fused decode kernel takes float32 or bfloat16 "
                            f"{name}, got {t.dtype}")
    if pool_k.dtype != pool_v.dtype:
        raise TypeError("pool_k and pool_v must share a dtype")
    tensors = (q, pool_k, pool_v, block_table, kv_valid_len)
    if any(t.device != q.device for t in tensors):
        raise ValueError("fused decode kernel wants every operand on q's device")
    for name, t in (("q", q), ("pool_k", pool_k), ("pool_v", pool_v)):
        if not t.is_contiguous():
            raise ValueError(f"fused decode kernel wants a contiguous {name}")
    bt = block_table.to(torch.int32).contiguous()
    ln = kv_valid_len.to(torch.int32).contiguous()
    batch, _, h, hd = q.shape
    _, page, kvh, _ = pool_k.shape
    out = torch.empty_like(q)
    if batch == 0:
        return out
    lib = _build.load_library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.fused_paged_decode_launch(
            q.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(), bt.data_ptr(),
            ln.data_ptr(), out.data_ptr(), batch, h, kvh, hd, page,
            bt.shape[1], _DTYPE_CODE[q.dtype], _DTYPE_CODE[pool_k.dtype],
            stream)
    _build.check_launch(code, "fused_paged_decode")
    LAUNCHES["fused_paged_decode"] += 1
    return out


def fused_paged_decode_attention(q, pool_k, pool_v, block_table,
                                 kv_valid_len, *, num_heads: int) -> torch.Tensor:
    """Single-token fused GQA decode attention over the paged KV pool.

    Drop-in for :func:`repro_torch.kernels.paged_attention.paged_decode_attention`
    (same signature and masking semantics) minus its materialization:
    ``q`` (B, 1, H, hd); pools (P, page_size, KVH, hd), float32 or bfloat16;
    ``block_table`` (B, max_blocks) page ids; ``kv_valid_len`` (B,) valid
    history *including* the token written this step (must be >= 1 per
    request — evicted slots point at the trash page with length 0, so the
    engine passes ``lengths + 1``).  Output (B, 1, H, hd) in ``q.dtype``.

    CUDA tensors launch the hand-written kernel (or raise); CPU tensors run
    :func:`fused_decode_plain`.
    """
    _check_shapes(q, pool_k, pool_v, block_table, kv_valid_len, num_heads)
    if q.device.type == "cuda":
        return _launch(q, pool_k, pool_v, block_table, kv_valid_len, num_heads)
    return fused_decode_plain(q, pool_k, pool_v, block_table, kv_valid_len,
                              num_heads=num_heads)


def gather_decode_bytes_moved(*, batch: int, max_blocks: int, page_size: int,
                              num_kv_heads: int, num_heads: int,
                              head_dim: int, dtype_bytes: int = 4) -> int:
    """Modeled KV bytes one gather-path decode step moves per layer.

    ``gather_kv`` reads every block-table page (live or trash) for K and V
    and ``_repeat_kv`` expands the gathered view to all H query heads, so
    the traffic scales with the pool's padded width and the *query* head
    count: O(max_blocks · page_size · H).
    """
    return (2 * batch * max_blocks * page_size * num_heads * head_dim
            * dtype_bytes)


def fused_decode_bytes_moved(lengths, *, page_size: int, num_kv_heads: int,
                             head_dim: int, dtype_bytes: int = 4) -> int:
    """Modeled KV bytes one fused decode step moves per layer.

    The page walk reads only ``ceil(len / page_size)`` pages per request,
    at KV-head width (queries are grouped, pages never repeated):
    O(len · KVH) per request.
    """
    pages = sum(-(-int(n) // page_size) for n in lengths)
    return 2 * pages * page_size * num_kv_heads * head_dim * dtype_bytes
