"""Flash attention (forward + backward): CUDA kernel wrappers + plain versions.

Replaces the TPU kernels of ``repro/kernels/flash_attention.py`` —
``_fwd_kernel`` (forward: output + logsumexp), ``_dq_kernel`` and
``_dkv_kernel`` (the two-kernel backward with in-kernel recompute of P from
the saved logsumexp and ``delta = rowsum(dO * O)``) — with
``csrc/flash_attention.cu``: one block per (slab, 64-row tile) looping over
the other axis with fp32 online-softmax state in registers, causal tiles
above the diagonal never visited.

Bound on an H100: the score and product operations (4, 6 and 8 x BH x Sq x
Skv x D, halved when causal) against the bf16 tensor cores — see
:func:`flash_ops`.  In bfloat16 all three kernels run on the tensor cores
(``csrc/mma_bf16.cuh``): bf16 tiles filled by 16-byte ``cp.async`` through
a two-stage ring, ``ldmatrix`` fragments, ``mma.sync.m16n8k16`` with fp32
accumulators, and P (dS) handed from one product's accumulators to the
next product's operands in registers.  Those copies need each slab 16-byte
aligned, so a bf16 tensor that is not raises ``ValueError`` rather than
falling back.  Every float32 kernel multiplies on the CUDA cores in fp32
(tensor cores would take fp32 only as TF32).  Head dims: :data:`HEAD_DIMS`.
Above 128 (192, 256) the bf16 kernels give each pair of warps 16 rows and
each warp half of D's output columns (registers), and at 256 the fp32 dQ
and dK/dV kernels stage K and V (Q and dO) in one shared buffer in turn
(shared memory); all keep the 64-wide tiles.

:func:`flash_attention` takes a V narrower than Q and K (MLA: q/k head dim
192, V 128): it zero-pads V to Q's width for the kernels and slices the
output.  That is exact: the padded columns of O are 0, their dO is 0, so
dQ, dK and V's real columns of dV do not change.  The kernel wrappers
themselves take one head dim for all of Q, K and V.

Beside each kernel sits its plain PyTorch version with the reference's
rounding points: scores in fp32, times the scale, ``-1e30`` where masked; P
rounded to V's type before P.V and to dO's before P^T.dO; dS rounded to K's
(Q's) type before dS.K (dS^T.Q); ``max(l, 1e-30)``.  The plain versions walk
the same 64-wide tiles as the kernels (keys for the forward and dQ, query
rows for dK/dV), so the online softmax rounds alike.  A CPU tensor runs the
plain version; a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build

__all__ = ["flash_attention", "flash_fwd", "flash_bwd_dq", "flash_bwd_dkv",
           "flash_fwd_plain", "flash_bwd_dq_plain", "flash_bwd_dkv_plain",
           "flash_ops", "LAUNCHES", "reset_launches", "HEAD_DIMS", "NEG_INF"]

#: kernel launches per wrapper since the last :func:`reset_launches`
LAUNCHES = {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}

NEG_INF = -1e30
BQ = BK = 64                     # the kernels' query-row and key tiles
HEAD_DIMS = (16, 32, 64, 96, 128, 192, 256)  # head dims the kernels are built for
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _scale(d: int) -> float:
    # the reference's float(1 / sqrt(d)), applied to float32 scores
    return float(torch.tensor(1.0 / (d ** 0.5), dtype=torch.float32))


def _masked(q0: int, nq: int, k0: int, nk: int, causal: bool, device):
    """(nq, nk) bool: True where query q0+i may not see key k0+j."""
    if not causal:
        return None
    qpos = torch.arange(q0, q0 + nq, device=device)[:, None]
    kpos = torch.arange(k0, k0 + nk, device=device)[None, :]
    return qpos < kpos


def _scores(q, k, scale, mask):
    s = torch.matmul(q.float(), k.float().transpose(1, 2)) * scale
    if mask is not None:
        s = s.masked_fill(mask, NEG_INF)
    return s


# ---------------------------------------------------------------------------
# Plain versions (any device)
# ---------------------------------------------------------------------------

def flash_fwd_plain(q, k, v, *, causal: bool):
    """(BH,Sq,D), (BH,Skv,D), (BH,Skv,Dv) -> (o (BH,Sq,Dv) in q's type, lse
    (BH,Sq) fp32).  The plain versions take any Dv, the kernels Dv = D.

    Online softmax over the kernel's 64-wide key tiles, every query row at
    once.  The
    first tile holds key 0, which every row sees, so a causal row that sees
    no key of a later tile keeps its state exactly (p = 0, corr = 1).
    """
    bh, sq, d = q.shape
    skv = k.shape[1]
    scale = _scale(d)
    dev = q.device
    m = torch.full((bh, sq, 1), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((bh, sq, 1), dtype=torch.float32, device=dev)
    acc = torch.zeros((bh, sq, v.shape[2]), dtype=torch.float32, device=dev)
    kend = min(skv, sq) if causal else skv
    for k0 in range(0, kend, BK):
        kt, vt = k[:, k0:k0 + BK], v[:, k0:k0 + BK]
        s = _scores(q, kt, scale, _masked(0, sq, k0, kt.shape[1], causal, dev))
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1, keepdim=True)
        m = m_new
        pv = torch.matmul(p.to(v.dtype).float(), vt.float())
        acc = acc * corr + pv
    l = torch.clamp(l, min=1e-30)
    return (acc / l).to(q.dtype), (m + torch.log(l))[..., 0]


def flash_bwd_dq_plain(q, k, v, do, lse, delta, *, causal: bool):
    """dQ from the saved ``lse`` and ``delta = rowsum(dO * O)`` (fp32)."""
    bh, sq, d = q.shape
    skv = k.shape[1]
    scale = _scale(d)
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    kend = min(skv, sq) if causal else skv
    for k0 in range(0, kend, BK):
        kt, vt = k[:, k0:k0 + BK], v[:, k0:k0 + BK]
        s = _scores(q, kt, scale, _masked(0, sq, k0, kt.shape[1], causal, q.device))
        p = torch.exp(s - lse[..., None])
        dov = torch.matmul(do.float(), vt.float().transpose(1, 2))
        ds = p * (dov - delta[..., None]) * scale
        dq = dq + torch.matmul(ds.to(k.dtype).float(), kt.float())
    return dq.to(q.dtype)


def flash_bwd_dkv_plain(q, k, v, do, lse, delta, *, causal: bool):
    """(dK, dV), walking the kernel's 64-row tiles of Q and dO."""
    bh, sq, d = q.shape
    scale = _scale(d)
    dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
    dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
    vf = v.float()
    for q0 in range(0, sq, BQ):
        qt, dot = q[:, q0:q0 + BQ], do[:, q0:q0 + BQ]
        s = _scores(qt, k, scale,
                    _masked(q0, qt.shape[1], 0, k.shape[1], causal, q.device))
        p = torch.exp(s - lse[:, q0:q0 + BQ, None])
        dv = dv + torch.matmul(p.to(do.dtype).float().transpose(1, 2), dot.float())
        dov = torch.matmul(dot.float(), vf.transpose(1, 2))
        ds = p * (dov - delta[:, q0:q0 + BQ, None]) * scale
        dk = dk + torch.matmul(ds.to(q.dtype).float().transpose(1, 2), qt.float())
    return dk.to(k.dtype), dv.to(v.dtype)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def _check(name, q, k, v, *extra):
    for t_name, t in (("q", q), ("k", k), ("v", v)) + extra:
        if t.dtype not in _DTYPE_CODE:
            raise TypeError(f"{name} takes float32 or bfloat16 {t_name}, got {t.dtype}")
        if t.dtype != q.dtype:
            raise TypeError(f"{name}: {t_name} is {t.dtype}, q is {q.dtype}")
        if t.device != q.device:
            raise ValueError(f"{name}: {t_name} on {t.device}, q on {q.device}")
        if t.ndim != 3 or t.shape[2] != q.shape[2]:
            raise ValueError(f"{name}: {t_name} must be (BH, S, {q.shape[2]}), "
                             f"got {tuple(t.shape)}")
        if t.stride(2) != 1 or t.stride(1) != t.shape[2]:
            raise ValueError(f"{name}: the rows of {t_name} must be contiguous "
                             f"(strides {t.stride()})")
    bh, sq, d = q.shape
    if k.shape[0] != bh or v.shape[0] != bh or k.shape[1] != v.shape[1]:
        raise ValueError(f"{name}: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not match")
    if d not in HEAD_DIMS:
        raise ValueError(f"{name}: the kernel is built for head dims "
                         f"{HEAD_DIMS}, got {d}")
    if not (0 < bh <= 65535 and sq > 0 and k.shape[1] > 0):
        raise ValueError(f"{name}: empty or too many slabs: {tuple(q.shape)}, "
                         f"{tuple(k.shape)}")


def _check_cp_async(name, *tensors):
    """The bf16 tensor-core kernels copy 16-byte chunks with ``cp.async``:
    every slab must start 16-byte aligned (data_ptr, and a slab stride that
    is a multiple of 8 elements)."""
    for t_name, t in tensors:
        if t.data_ptr() % 16 or t.stride(0) % 8:
            raise ValueError(
                f"{name}: bf16 {t_name} must start 16-byte aligned with a slab "
                f"stride that is a multiple of 8 elements (data_ptr "
                f"{t.data_ptr():#x}, strides {t.stride()})")


def _stats(name, t, bh, sq):
    if t.dtype != torch.float32 or t.shape != (bh, sq) or not t.is_contiguous():
        raise ValueError(f"{name} wants a contiguous float32 ({bh}, {sq}) tensor")


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def flash_fwd(q, k, v, *, causal: bool):
    """Forward on (BH,S,D) slabs -> (o, lse).  CUDA: the kernel; CPU: plain."""
    if q.device.type != "cuda":
        return flash_fwd_plain(q, k, v, causal=causal)
    _check("flash_fwd", q, k, v)
    if q.dtype == torch.bfloat16:
        _check_cp_async("flash_fwd", ("q", q), ("k", k), ("v", v))
    bh, sq, d = q.shape
    o = torch.empty((bh, sq, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((bh, sq), dtype=torch.float32, device=q.device)
    lib = _build.load_library()
    with torch.cuda.device(q.device):
        code = lib.flash_fwd_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
            bh, sq, k.shape[1], d, q.stride(0), k.stride(0), v.stride(0),
            _scale(d), int(causal), _DTYPE_CODE[q.dtype], _stream(q))
    _build.check_launch(code, "flash_fwd")
    LAUNCHES["flash_fwd"] += 1
    return o, lse


def flash_bwd_dq(q, k, v, do, lse, delta, *, causal: bool):
    """dQ (BH,Sq,D) in q's type.  CUDA: the kernel; CPU: plain."""
    if q.device.type != "cuda":
        return flash_bwd_dq_plain(q, k, v, do, lse, delta, causal=causal)
    _check("flash_bwd_dq", q, k, v, ("do", do))
    bh, sq, d = q.shape
    if do.shape != q.shape:
        raise ValueError(f"flash_bwd_dq: do {tuple(do.shape)} != q {tuple(q.shape)}")
    _stats("flash_bwd_dq: lse", lse, bh, sq)
    _stats("flash_bwd_dq: delta", delta, bh, sq)
    if q.dtype == torch.bfloat16:
        _check_cp_async("flash_bwd_dq", ("q", q), ("k", k), ("v", v), ("do", do))
    dq = torch.empty((bh, sq, d), dtype=q.dtype, device=q.device)
    lib = _build.load_library()
    with torch.cuda.device(q.device):
        code = lib.flash_bwd_dq_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), bh, sq, k.shape[1],
            d, q.stride(0), k.stride(0), v.stride(0), do.stride(0), _scale(d),
            int(causal), _DTYPE_CODE[q.dtype], _stream(q))
    _build.check_launch(code, "flash_bwd_dq")
    LAUNCHES["flash_bwd_dq"] += 1
    return dq


def flash_bwd_dkv(q, k, v, do, lse, delta, *, causal: bool):
    """(dK, dV), each (BH,Skv,D) in k's type.  CUDA: the kernel; CPU: plain."""
    if q.device.type != "cuda":
        return flash_bwd_dkv_plain(q, k, v, do, lse, delta, causal=causal)
    _check("flash_bwd_dkv", q, k, v, ("do", do))
    bh, sq, d = q.shape
    if do.shape != q.shape:
        raise ValueError(f"flash_bwd_dkv: do {tuple(do.shape)} != q {tuple(q.shape)}")
    _stats("flash_bwd_dkv: lse", lse, bh, sq)
    _stats("flash_bwd_dkv: delta", delta, bh, sq)
    if q.dtype == torch.bfloat16:
        _check_cp_async("flash_bwd_dkv", ("q", q), ("k", k), ("v", v), ("do", do))
    skv = k.shape[1]
    dk = torch.empty((bh, skv, d), dtype=k.dtype, device=k.device)
    dv = torch.empty((bh, skv, d), dtype=v.dtype, device=v.device)
    lib = _build.load_library()
    with torch.cuda.device(q.device):
        code = lib.flash_bwd_dkv_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), bh,
            sq, skv, d, q.stride(0), k.stride(0), v.stride(0), do.stride(0),
            _scale(d), int(causal), _DTYPE_CODE[q.dtype], _stream(q))
    _build.check_launch(code, "flash_bwd_dkv")
    LAUNCHES["flash_bwd_dkv"] += 1
    return dk, dv


class _Flash(torch.autograd.Function):
    """Flash attention on (BH,S,D) slabs; saves (q, k, v, o, lse)."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        o, lse = flash_fwd(q, k, v, causal=causal)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal = causal
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        do = do.contiguous()
        # rowsum(dO * O) in fp32 with tensor ops, outside the kernels, as
        # the reference computes it outside Pallas
        delta = torch.sum(do.float() * o.float(), dim=-1)
        dq = flash_bwd_dq(q, k, v, do, lse, delta, causal=ctx.causal)
        dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, causal=ctx.causal)
        return dq, dk, dv, None


def flash_attention(q, k, v, *, causal: bool = True):
    """q/k: (B, S, H, D), v: (B, Skv, H, Dv) with Dv <= D -> (B, Sq, H, Dv).
    Differentiable flash attention.

    The reference's semantics at any length: a key at or past Skv is never
    attended (its gradients are zero), causal means ``qpos >= kpos`` with
    both counted from 0 (not SDPA's bottom-right alignment when Sq != Skv).
    The kernels mask by the true lengths instead of padding to the tile.  A
    narrower V is zero-padded to D and the output sliced back (exact, see
    the module docstring).
    """
    b, sq, h, d = q.shape
    skv, dv = k.shape[1], v.shape[3]
    if dv > d:
        raise ValueError(f"flash_attention: V's head dim {dv} exceeds Q's {d}")
    if dv < d:
        v = torch.nn.functional.pad(v, (0, d - dv))
    # (BH, S, D) slabs with contiguous rows: at B = 1 the reshape is a view
    # whose rows sit H * D apart, which the kernels do not take
    qf = q.transpose(1, 2).reshape(b * h, sq, d).contiguous()
    kf = k.transpose(1, 2).reshape(b * h, skv, d).contiguous()
    vf = v.transpose(1, 2).reshape(b * h, skv, d).contiguous()
    of = _Flash.apply(qf, kf, vf, causal)
    return of.reshape(b, h, sq, d)[..., :dv].transpose(1, 2)


def flash_ops(bh: int, sq: int, skv: int, d: int, *, causal: bool,
              dv: int | None = None) -> dict:
    """Floating-point operations each kernel's function needs (a multiply-add
    counts 2), with Q and K at head dim ``d`` and V at ``dv`` (default
    ``d``): forward QK^T (at d) and PV (at dv); dQ recomputes QK^T and forms
    dO V^T (dv) and dS K (d); dK/dV recomputes QK^T and dO V^T and forms
    P^T dO (dv) and dS^T Q (d).  At dv = d that is 4, 6 and 8 x BH Sq Skv D.
    Causal keeps the pairs with qpos >= kpos.  The count is the function's,
    not the padded work :func:`flash_attention` hands the kernels."""
    dv = d if dv is None else dv
    if causal:
        pairs = sum(min(i + 1, skv) for i in range(sq))
    else:
        pairs = sq * skv
    unit = 2.0 * bh * pairs
    return {"flash_fwd": unit * (d + dv), "flash_bwd_dq": unit * (2 * d + dv),
            "flash_bwd_dkv": unit * (2 * d + 2 * dv)}
