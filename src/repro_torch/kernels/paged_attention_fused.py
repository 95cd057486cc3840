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
:func:`fused_decode_bytes_moved`.  The kernel splits each request's page
axis over ``S`` blocks (:func:`plan_decode_splits`: the most splits that
fit one wave of resident blocks, planned from shapes alone, so the wrapper
never reads ``kv_valid_len`` on the host), streams K/V rows in 16-byte
loads with the queries and accumulators in registers, and merges the live
splits' partial states by log-sum-exp in split order in the block that
finishes last (a ticket counter per row), all in one launch.  It allocates
its workspace with ``torch.empty`` and keeps one zeroed counter buffer per
device, so a call neither syncs nor fills memory.

Beside the kernel wrapper sits the plain version
(:func:`fused_decode_plain`): the same page walk written with tensor ops,
over the same split ranges and with the same merge when asked for splits.
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
           "plan_decode_splits", "split_geometry", "decode_geometry",
           "MAX_HEAD_DIM", "LAUNCHES", "reset_launches"]

#: kernel launches since the last :func:`reset_launches`
LAUNCHES = {"fused_paged_decode": 0}

_MASK = -1e30  # same fill as models.attention.naive_attention
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

#: the widest head the kernel's instances cover (8 16-byte chunks a lane
#: of fp32, 4 of bf16, 32 lanes a row)
MAX_HEAD_DIM = 1024

#: per device: the kernel's split-merge ticket counters, zeroed once, grown
#: on demand; every launch leaves them zeroed.  One buffer a device, so the
#: calls on a device must be ordered on one stream
_COUNTERS: dict[int, torch.Tensor] = {}
#: the buffers growth replaced, kept (zeroed) because a captured CUDA graph
#: may still launch the kernel on them
_RETIRED: list[torch.Tensor] = []


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
    if block_table.shape[1] == 0:
        raise ValueError("block_table has no page column")
    if kv_valid_len.shape != (q.shape[0],):
        raise ValueError(f"kv_valid_len must be (B,), got "
                         f"{tuple(kv_valid_len.shape)}")


def decode_geometry(head_dim: int, elem_bytes: int) -> tuple[int, int, int]:
    """``(lanes, chunks, gtile)`` of the kernel instance for a head dim and
    pool elements of ``elem_bytes`` (4 or 2): ``lanes`` threads of a warp
    share one K/V row, each holding ``chunks`` 16-byte chunks of it, and a
    block takes ``gtile`` query heads of its KV head's group
    (``ceil(H / KVH / gtile)`` blocks share a KV head; a tile past the group
    repeats its last head).  A row of at most 32 chunks takes the least of
    8, 16 or 32 lanes that covers it, one chunk a lane, and tiles of 4
    heads; so does an fp32 row of at most 64 chunks, at two chunks a lane;
    any wider row to :data:`MAX_HEAD_DIM` takes 32 lanes, one head a block
    and as many chunks as that width needs (8 fp32, 4 bf16).  These are the
    kernel's instances; raises past :data:`MAX_HEAD_DIM`."""
    if head_dim < 1 or head_dim > MAX_HEAD_DIM:
        raise ValueError(f"fused decode kernel takes head dims 1..{MAX_HEAD_DIM}, "
                         f"got {head_dim}")
    vec = 16 // elem_bytes
    need = -(-head_dim // vec)
    if need <= 32:
        return min(lanes for lanes in (8, 16, 32) if lanes >= need), 1, 4
    if elem_bytes == 4 and need <= 64:
        return 32, 2, 4
    return 32, MAX_HEAD_DIM // (32 * vec), 1


def split_geometry(max_blocks: int, splits: int) -> tuple[int, int]:
    """``(pages_per_split, n_splits)`` of a walk over ``max_blocks`` pages
    cut ``splits`` ways (clamped to ``1..max_blocks``): ``ceil(max_blocks /
    splits)`` pages a split, and as many splits as that takes."""
    splits = max(1, min(splits, max_blocks))
    pps = -(-max_blocks // splits)
    return pps, -(-max_blocks // pps)


def plan_decode_splits(batch: int, kvh: int, max_blocks: int, sm_count: int,
                       resident: int) -> int:
    """How many ways the fused decode kernel splits each request's page axis.

    ``batch * kvh`` blocks share the page axis (``kvh``: the block rows of a
    request, its KV heads times query-head tiles) and ``resident`` blocks of
    the instance fit an SM at once (:func:`repro_torch.kernels._build.resident_blocks`).
    The plan takes the most splits that keep the grid within one wave, at
    most ``max_blocks`` (one page a split), from shapes alone: it never reads
    the valid lengths, which live on the device.  The count is normalized so
    that no split is empty (``split_geometry``); 1 means no split.
    """
    fit = resident * sm_count // max(batch * kvh, 1)
    return split_geometry(max_blocks, max(1, fit))[1]


def fused_decode_plain(q, pool_k, pool_v, block_table, kv_valid_len, *,
                       num_heads: int, splits: int = 1) -> torch.Tensor:
    """The kernel's page walk as plain tensor ops (any device).

    Steps ``j = 0 .. max(ceil(len / page)) - 1`` over the batch; at each step
    every request still inside its history reads page ``block_table[b, j]``
    (requests past their last page read nothing — their slot is redirected
    to a page they own and their update is discarded), scores it in fp32 at
    KV-head width, and folds it into the running max / denominator /
    accumulator exactly as the kernel does.

    With ``splits`` > 1 the page axis is cut into the kernel's ranges
    (:func:`split_geometry`); each range starts from a fresh state, and the
    states merge in split order as the kernel merges them: ``m = max m_s``,
    ``l = sum e^(m_s - m) l_s`` and the accumulator likewise, a split that
    holds none of a request's pages weighing 0.  One split (the default) is
    the plain walk.
    """
    batch, _, h, hd = q.shape
    _, page, kvh, _ = pool_k.shape
    g = h // kvh
    dev = q.device
    valid = kv_valid_len.to(device=dev, dtype=torch.long)
    n_blocks = (valid + page - 1) // page
    bt = block_table.to(device=dev, dtype=torch.long)
    qg = q[:, 0].to(torch.float32).reshape(batch, kvh, g, hd)
    tok = torch.arange(page, device=dev)
    rows = torch.arange(batch, device=dev)
    mask_fill = torch.full((), _MASK, dtype=torch.float32, device=dev)
    walk_end = int(n_blocks.max()) if batch else 0
    pps, n_splits = split_geometry(bt.shape[1], splits)
    states = []
    for s in range(n_splits):
        if s and s * pps >= walk_end:
            break                           # no request has a page here
        m = torch.full((batch, kvh, g), -math.inf, dtype=torch.float32, device=dev)
        l = torch.zeros((batch, kvh, g), dtype=torch.float32, device=dev)
        acc = torch.zeros((batch, kvh, g, hd), dtype=torch.float32, device=dev)
        for j in range(s * pps, min((s + 1) * pps, walk_end)):
            live = j < n_blocks                                   # (B,)
            jj = torch.minimum(torch.full_like(n_blocks, j), n_blocks - 1)
            pid = bt[rows, jj]                                    # live pages only
            k = pool_k[pid].to(torch.float32)                     # (B,page,KVH,hd)
            v = pool_v[pid].to(torch.float32)
            in_len = (j * page + tok)[None, :] < valid[:, None]   # (B,page)
            v = torch.where(in_len[:, :, None, None], v, torch.zeros_like(v))
            sc = torch.einsum("bkgd,btkd->bkgt", qg, k) / math.sqrt(hd)
            sc = torch.where(in_len[:, None, None, :], sc, mask_fill)
            m_new = torch.maximum(m, sc.amax(dim=-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(sc - m_new[..., None])
            l_new = alpha * l + p.sum(dim=-1)
            acc_new = alpha[..., None] * acc + torch.einsum("bkgt,btkd->bkgd", p, v)
            keep = live[:, None, None]
            m = torch.where(keep, m_new, m)
            l = torch.where(keep, l_new, l)
            acc = torch.where(keep[..., None], acc_new, acc)
        states.append((m, l, acc))
    if len(states) == 1:
        m, l, acc = states[0]
        out = acc / l[..., None]
    else:
        m_all = torch.stack([st[0] for st in states]).amax(dim=0)
        l_sum = torch.zeros_like(m_all)
        a_sum = torch.zeros_like(states[0][2])
        for m_s, l_s, a_s in states:
            sc = torch.where(m_s == -math.inf, torch.zeros_like(m_s),
                             torch.exp(m_s - m_all))
            l_sum = l_sum + sc * l_s
            a_sum = a_sum + sc[..., None] * a_s
        out = a_sum / l_sum[..., None]
    return out.reshape(batch, 1, h, hd).to(q.dtype)


def _counters(device: torch.device, rows: int) -> torch.Tensor:
    """The device's zeroed ticket counters, at least ``rows`` of them."""
    buf = _COUNTERS.get(device.index)
    if buf is None or buf.numel() < rows:
        if buf is not None:
            _RETIRED.append(buf)
        buf = torch.zeros(max(rows, 2 * (0 if buf is None else buf.numel())),
                          dtype=torch.int32, device=device)
        _COUNTERS[device.index] = buf
    return buf


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
    max_blocks = bt.shape[1]
    lanes, chunks, gtile = decode_geometry(hd, pool_k.element_size())
    out = torch.empty_like(q)
    if batch == 0:
        return out
    rows = batch * kvh * -(-(h // kvh) // gtile)
    dev = q.device
    pool_code = _DTYPE_CODE[pool_k.dtype]
    sm_count = torch.cuda.get_device_properties(dev).multi_processor_count
    resident = _build.resident_blocks("fused_paged_decode_resident_blocks",
                                      dev.index, hd, lanes, chunks, gtile, pool_code)
    pps, n_splits = split_geometry(max_blocks, plan_decode_splits(
        batch, rows // batch, max_blocks, sm_count, resident))
    ws = counters = None
    if n_splits > 1:
        ws = torch.empty(rows * n_splits * gtile * (hd + 2), dtype=torch.float32,
                         device=dev)
        counters = _counters(dev, rows)
    lib = _build.load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.fused_paged_decode_launch(
            q.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(), bt.data_ptr(),
            ln.data_ptr(), out.data_ptr(),
            None if ws is None else ws.data_ptr(),
            None if counters is None else counters.data_ptr(),
            batch, h, kvh, hd, page, max_blocks, pps, n_splits, lanes, chunks,
            gtile, _DTYPE_CODE[q.dtype], pool_code, stream)
    try:
        _build.check_launch(code, "fused_paged_decode")
    except RuntimeError:
        if counters is not None:    # the next call must find them zeroed
            counters[:rows].zero_()
        raise
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

    CUDA tensors launch the hand-written kernel (or raise), its page axis
    split as :func:`plan_decode_splits` plans.  The kernel's ticket counters
    are one buffer a device: calls on one device must be ordered on one
    stream.  CPU tensors run :func:`fused_decode_plain` in one split.
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
