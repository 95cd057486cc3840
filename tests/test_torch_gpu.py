"""The CUDA kernels against their plain versions, on a card.

Every test here carries the ``gpu`` marker and skips, with a reason, on a
host without a CUDA device (the decision is taken inside a fixture, at run
time).  On a machine with an NVIDIA GPU and ``nvcc``:

    PYTHONPATH=src python -m pytest -q tests/test_torch_gpu.py

Integer GEMMs must be EQUAL to the plain slot loop (tu and tub on the int8
tensor cores, every int8 code included); the fused decode kernel, its page
axis split as planned, once, twice or a page a split, within 1e-4 of the
gather oracle and of the plain walk at fp32 (online softmax re-associates;
the log-sum-exp merge too) and within one bf16 ulp of the plain walk with a
bf16 query, never reading a dead page, bitwise equal across launches; the
flash kernels within 1e-4 x max|plain| at fp32 and 1e-2 x max|plain| at
bfloat16 (one rounding of an output element), per tensor; a bf16 slab that
the tensor-core kernels' 16-byte copies cannot take raises.  The packed
integer GEMMs (quant_gemm and packed_gemm, both on the int8 tensor cores)
must be EQUAL to their plain versions in int32 and in the fused float32
epilogue, under the planned split K, none and 3, and block_stats EQUAL
too, at every tile 1..128 and any row count, with its two fused sums; each
launch on a CUDA tensor must count.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import gemm_sims, packing
from repro_torch.kernels import bitsparsity as bs_lib
from repro_torch.kernels import flash_attention as flash_lib
from repro_torch.kernels import ops as ops_lib
from repro_torch.kernels import packed_gemm as pg_lib
from repro_torch.kernels import quant_gemm as qg_lib
from repro_torch.kernels import paged_attention as paged_lib
from repro_torch.kernels import paged_attention_fused as fused_lib
from repro_torch.kernels import ref as ref_lib
from repro_torch.kernels import unary_gemm as ug

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels only run on the card")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("bits", [2, 3, 4, 8])
@pytest.mark.parametrize("shape", [(8, 256, 384), (5, 37, 11), (40, 130, 70), (1, 1, 1)])
def test_unary_gemm_kernels_equal_plain(cuda, bits, shape):
    m, k, n = shape
    rng = np.random.default_rng(bits + m)
    v = 2 ** (bits - 1) - 1
    a = torch.from_numpy(rng.integers(-v, v + 1, (m, k)).astype(np.int8)).to(cuda)
    b = torch.from_numpy(rng.integers(-128, 128, (k, n)).astype(np.int8)).to(cuda)
    want = (a.cpu().int() @ b.cpu().int())
    for fn, plain, name in ((ug.tub_gemm, ref_lib.tub_gemm_ref, "tub_gemm"),
                            (ug.tu_gemm, ref_lib.tu_gemm_ref, "tu_gemm")):
        before = ug.LAUNCHES[name]
        out, _ = fn(a, b, bits=bits)
        assert ug.LAUNCHES[name] == before + 1
        assert torch.equal(out.cpu(), want)
        assert torch.equal(out, plain(a, b, bits=bits))


# (K, N) of the dense sites the attention families add, at decode rows:
# phi3.5-moe / phi3-mini lm_head (N = 32064, off the 128-wide tile),
# deepseek-v3's w_kr (N = 64), w_dkv (N = 512), w_uk (K = 512), w_uq
# (K = 1536, N = 128 x 192), wo (K = 16384), gemma-7b's w_up / w_down
FAMILY_SITE_SHAPES = [(4096, 32064), (3072, 32064), (7168, 64), (7168, 512),
                      (512, 16384), (1536, 24576), (16384, 7168),
                      (3072, 24576), (24576, 3072)]


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("m", [4, 8, 27])
@pytest.mark.parametrize("k,n", FAMILY_SITE_SHAPES)
def test_tub_gemm_at_family_site_shapes(cuda, k, n, m, bits):
    rng = np.random.default_rng(k + n + m + bits)
    v = 2 ** (bits - 1) - 1
    a = torch.from_numpy(rng.integers(-v, v + 1, (m, k)).astype(np.int8)).to(cuda)
    b = torch.from_numpy(rng.integers(-v, v + 1, (k, n)).astype(np.int8)).to(cuda)
    before = ug.LAUNCHES["tub_gemm"]
    out, _ = ug.tub_gemm(a, b, bits=bits)
    torch.cuda.synchronize()
    assert ug.LAUNCHES["tub_gemm"] == before + 1
    # float64 products are exact here (|sum| < 2^53)
    assert torch.equal(out, (a.double() @ b.double()).to(torch.int32))
    assert torch.equal(out, ref_lib.tub_gemm_ref(a, b, bits=bits))


@pytest.mark.parametrize("design", ["tu", "tub"])
@pytest.mark.parametrize("splits", [None, 1, 3], ids=["planned", "unsplit", "split3"])
@pytest.mark.parametrize("bits", range(2, 9))
@pytest.mark.parametrize("m", [1, 7, 8, 9, 16, 17, 64, 512])
@pytest.mark.parametrize("k,n", [(203, 77), (256, 384), (1001, 144)])
def test_tu_gemm_tensor_cores_exact(cuda, monkeypatch, k, n, m, bits, splits, design):
    """The int8 tensor-core slot loop, with tu's and with tub's pulse
    builder, EQUAL to the plain slot loop and to the integer GEMM: every
    row-block width (M 1..512), K off the 64-wide tile and off 4, N off the
    128-wide tile and off 16 (plain word loads) or on it (cp.async), every
    bit width, with the planned split K, none, and 3."""
    if splits is not None:
        monkeypatch.setattr(ug, "plan_splits", lambda *shape: splits)
    fn, plain, name = ((ug.tu_gemm, ref_lib.tu_gemm_ref, "tu_gemm") if design == "tu"
                       else (ug.tub_gemm, ref_lib.tub_gemm_ref, "tub_gemm"))
    rng = np.random.default_rng(1000 * bits + m + k)
    v = 2 ** (bits - 1) - 1
    a = torch.from_numpy(rng.integers(-v, v + 1, (m, k)).astype(np.int8)).to(cuda)
    b = torch.from_numpy(rng.integers(-128, 128, (k, n)).astype(np.int8)).to(cuda)
    before = ug.LAUNCHES[name]
    out, _ = fn(a, b, bits=bits)
    torch.cuda.synchronize()
    assert ug.LAUNCHES[name] == before + 1
    assert torch.equal(out, plain(a, b, bits=bits))
    assert torch.equal(out.cpu(), gemm_sims.bgemm_exact(a.cpu(), b.cpu()))


@pytest.mark.parametrize("design", ["tu", "tub"])
@pytest.mark.parametrize("m,k,n", [(8, 256, 384), (13, 203, 77), (64, 1001, 144)])
def test_unary_gemm_every_int8_code(cuda, design, m, k, n):
    """At 8 bits every int8 code, -128 included: its magnitude stays 128
    (tub's v1 = 64 fires in all 64 slots, tu's |a| in all 128), so both
    kernels equal their plain slot loops and the integer GEMM."""
    fn, plain = ((ug.tu_gemm, ref_lib.tu_gemm_ref) if design == "tu"
                 else (ug.tub_gemm, ref_lib.tub_gemm_ref))
    rng = np.random.default_rng(m + k + n)
    a = rng.integers(-128, 128, (m, k)).astype(np.int8)
    a[:, :3] = -128
    a = torch.from_numpy(a).to(cuda)
    b = torch.from_numpy(rng.integers(-128, 128, (k, n)).astype(np.int8)).to(cuda)
    out, _ = fn(a, b, bits=8)
    torch.cuda.synchronize()
    assert torch.equal(out, plain(a, b, bits=8))
    assert torch.equal(out.cpu(), gemm_sims.bgemm_exact(a.cpu(), b.cpu()))


# (pools, q) dtypes of the fused decode checks
DECODE_DTYPES = {"fp32": (torch.float32, torch.float32),
                 "bf16_pools": (torch.bfloat16, torch.float32),
                 "bf16": (torch.bfloat16, torch.bfloat16)}
RAGGED_LENGTHS = [1, 16, 17, 255, 256, 500, 777, 1024]
# (page, gqa, batch, kvh, max_blocks, lengths): odd pages and GQA widths,
# and llama3-8b's serve geometry with lengths to 1024 at page 16
DECODE_CASES = {
    "page3-gqa1": (3, 1, 4, 2, 5, [1, 3, 4, 15]),
    "page4-gqa2": (4, 2, 4, 2, 5, [1, 4, 5, 20]),
    "page8-gqa4": (8, 4, 4, 2, 5, [1, 8, 9, 40]),
    "page16-gqa4": (16, 4, 4, 2, 5, [1, 16, 17, 80]),
    "page16-b8-to1024": (16, 4, 8, 8, 64, RAGGED_LENGTHS)}


@pytest.mark.parametrize("dtype", list(DECODE_DTYPES))
@pytest.mark.parametrize("hd", [64, 96, 128, 256, 512])
@pytest.mark.parametrize("splits", [None, 1, 2, "max"],
                         ids=["planned", "unsplit", "split2", "split_max"])
@pytest.mark.parametrize("case", list(DECODE_CASES))
def test_fused_decode_kernel_matches_oracle(cuda, monkeypatch, case, splits, hd, dtype):
    """The split-KV kernel against the gather oracle (clean pools) and the
    plain walk (over the same split ranges when the plan is forced, whole
    when planned), on NaN-poisoned dead pages; two
    launches bitwise equal; then three calls in a row on other batches (a
    ticket counter left non-zero would leave an output unmerged)."""
    page, gqa, batch, kvh, max_blocks, lengths = DECODE_CASES[case]
    pool_dtype, q_dtype = DECODE_DTYPES[dtype]
    rng = np.random.default_rng(page + gqa + hd)
    h = kvh * gqa
    num_pages = 1 + batch * max_blocks
    bt = torch.from_numpy(rng.permutation(np.arange(1, num_pages)).astype(np.int32)
                          .reshape(batch, max_blocks)).to(cuda)
    lens = torch.tensor(lengths, dtype=torch.int32, device=cuda)

    def rand(shape, dt):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(cuda).to(dt)

    pk = rand((num_pages, page, kvh, hd), pool_dtype)
    pv = rand((num_pages, page, kvh, hd), pool_dtype)
    q = rand((batch, 1, h, hd), q_dtype)
    dead = torch.ones(num_pages, dtype=torch.bool, device=cuda)
    for i in range(batch):
        dead[bt[i, : -(-int(lens[i]) // page)].long()] = False
    pkp, pvp = pk.clone(), pv.clone()
    pkp[dead] = float("nan")
    pvp[dead] = float("nan")
    n = max_blocks if splits == "max" else splits
    if n is not None:
        monkeypatch.setattr(fused_lib, "plan_decode_splits", lambda *shape: n)

    def check(sel):
        qs, bts, ls = q[sel].contiguous(), bt[sel].contiguous(), lens[sel].contiguous()
        before = fused_lib.LAUNCHES["fused_paged_decode"]
        got = fused_lib.fused_paged_decode_attention(qs, pkp, pvp, bts, ls, num_heads=h)
        torch.cuda.synchronize()
        assert fused_lib.LAUNCHES["fused_paged_decode"] == before + 1
        assert got.dtype == q_dtype and bool(torch.isfinite(got.float()).all())
        plain = fused_lib.fused_decode_plain(qs, pkp, pvp, bts, ls, num_heads=h,
                                             splits=n or 1).float()
        oracle = paged_lib.paged_decode_attention(qs, pk, pv, bts, ls,
                                                  num_heads=h).float()
        d_plain = (got.float() - plain).abs()
        d_oracle = float((got.float() - oracle).abs().max())
        if q_dtype == torch.float32:
            assert float(d_plain.max()) <= 1e-4 and d_oracle <= 1e-4, (d_plain.max(), d_oracle)
        else:   # one bfloat16 ulp of the plain walk, as in chip_smoke.py
            assert bool((d_plain <= plain.abs() * 2.0 ** -7 + 1e-6).all())
            assert d_oracle <= 2e-2
        return got

    first = check(slice(None))
    again = fused_lib.fused_paged_decode_attention(q, pkp, pvp, bt, lens, num_heads=h)
    assert torch.equal(first, again), "two launches differ"
    check(slice(0, batch // 2))
    check(slice(1, batch))


def test_wrappers_raise_rather_than_fall_back(cuda):
    a = torch.zeros((2, 4), dtype=torch.int8, device=cuda)
    with pytest.raises(ValueError):
        ug.tub_gemm(a, torch.zeros((4, 2), dtype=torch.int8))      # mixed devices
    q = torch.zeros((1, 1, 2, 8), dtype=torch.float16, device=cuda)
    pool = torch.zeros((2, 4, 2, 8), dtype=torch.float16, device=cuda)
    with pytest.raises(TypeError):
        fused_lib.fused_paged_decode_attention(
            q, pool, pool, torch.zeros((1, 1), dtype=torch.int32, device=cuda),
            torch.ones((1,), dtype=torch.int32, device=cuda), num_heads=2)


FLASH_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}   # x max|plain|
# bf16 o, dQ, dK, dV per element, x (|plain| + max|plain| of its row), as in
# chip_smoke.py
FLASH_BF16_ROW_TOL = 1.2e-2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("bh,sq,skv,d", [(3, 77, 77, 64), (2, 130, 50, 32),
                                         (2, 64, 200, 128), (4, 100, 100, 16),
                                         # the 64-wide tiles' edges: lengths 1,
                                         # 15, 17, 63, 65, 129, Sq < Skv and
                                         # Sq > Skv, every head dim
                                         (2, 1, 1, 16), (2, 15, 17, 32),
                                         (2, 17, 15, 64), (2, 63, 65, 128),
                                         (2, 65, 63, 16), (2, 129, 129, 32),
                                         (2, 1, 129, 64), (2, 129, 1, 128),
                                         # head dims 96 and 256 (phi3-mini,
                                         # gemma-7b): the same edges
                                         (3, 77, 77, 96), (2, 130, 50, 256),
                                         (2, 1, 1, 96), (2, 15, 17, 256),
                                         (2, 63, 65, 96), (2, 65, 63, 256),
                                         (2, 129, 129, 96), (2, 100, 100, 256),
                                         (2, 1, 129, 256), (2, 129, 1, 96),
                                         # head dim 192 (deepseek-v3's MLA
                                         # q/k): the same edges
                                         (3, 77, 77, 192), (2, 130, 50, 192),
                                         (2, 1, 1, 192), (2, 63, 65, 192),
                                         (2, 65, 63, 192), (2, 1, 129, 192),
                                         (2, 129, 1, 192)])
def test_flash_kernels_match_plain(cuda, dtype, causal, bh, sq, skv, d):
    gen = torch.Generator(device=cuda)
    gen.manual_seed(sq + skv + d)

    def rand(n, pad=0):
        # padded tails are NaN: the kernels must never read them
        buf = torch.randn((bh, n + pad, d), generator=gen, device=cuda).to(dtype)
        buf[:, n:] = float("nan")
        return buf[:, :n]

    q, k, v, do = rand(sq, 5), rand(skv, 7), rand(skv, 3), rand(sq, 2)
    before = dict(flash_lib.LAUNCHES)
    o, lse = flash_lib.flash_fwd(q, k, v, causal=causal)
    delta = torch.sum(do.float() * o.float(), dim=-1)
    dq = flash_lib.flash_bwd_dq(q, k, v, do, lse, delta, causal=causal)
    dk, dv = flash_lib.flash_bwd_dkv(q, k, v, do, lse, delta, causal=causal)
    torch.cuda.synchronize()
    assert {n: flash_lib.LAUNCHES[n] - before[n] for n in before} == {
        "flash_fwd": 1, "flash_bwd_dq": 1, "flash_bwd_dkv": 1}
    p_o, p_lse = flash_lib.flash_fwd_plain(q, k, v, causal=causal)
    p_dq = flash_lib.flash_bwd_dq_plain(q, k, v, do, p_lse, delta, causal=causal)
    p_dk, p_dv = flash_lib.flash_bwd_dkv_plain(q, k, v, do, p_lse, delta,
                                               causal=causal)
    # Where a query sees a single key, dS = P (dP - delta) cancels exactly.
    # At a length of 1 that leaves whole dQ and dK rows (every row at Skv = 1;
    # at Sq = 1 causal, query 0's dQ row and key 0's dK row) holding nothing
    # but the fp32 rounding of the cancellation, in the plain version as in
    # the kernel, so no relative check can apply to them.  There those rows
    # are held to 64 fp32 ulps of the cancelling terms' scale, sqrt(d)
    # max|dO| max|V| max(|Q|, |K|), and leave the checks below; every other
    # row is held to the checks below (bar one bf16 row, said there).
    cancelled = {}
    if min(sq, skv) == 1:
        sees = torch.ones((sq, skv), dtype=torch.bool)
        if causal:
            sees = torch.arange(sq)[:, None] >= torch.arange(skv)[None, :]
        single = sees.sum(dim=1) == 1
        cancelled = {"dq": single,
                     "dk": sees.any(dim=0) & ~(sees & ~single[:, None]).any(dim=0)}
    cancel = 64 * 2.0 ** -23 * d ** 0.5 * float(
        do.float().abs().max() * v.float().abs().max()
        * torch.maximum(q.float().abs().max(), k.float().abs().max()))
    for name, got, want in (("o", o, p_o), ("lse", lse, p_lse), ("dq", dq, p_dq),
                            ("dk", dk, p_dk), ("dv", dv, p_dv)):
        assert bool(torch.isfinite(got.float()).all()), name
        got, want = got.float(), want.float()
        if name in cancelled:
            rows = cancelled[name].to(got.device)
            if bool(rows.any()):
                err0 = float((got[:, rows] - want[:, rows]).abs().max())
                assert err0 <= cancel, (name, "cancelled rows", err0, cancel)
            got, want = got[:, ~rows], want[:, ~rows]
            if want.numel() == 0:
                continue
        err = float((got - want).abs().max())
        assert err <= FLASH_TOL[dtype] * float(want.abs().max()), (name, err)
        if dtype == torch.bfloat16 and name != "lse":
            if name == "dq" and causal and not cancelled:
                # Causal query 0 sees key 0 alone at every length, so its
                # row cancels too.  The bf16 dQ kernel sums it in another
                # order than the plain version, so that row alone leaves the
                # per-element check (not the per-tensor one above) and is
                # held to the 64-ulp bound, as in chip_smoke.py.
                err0 = float((got[:, 0] - want[:, 0]).abs().max())
                assert err0 <= cancel, (name, "query 0's cancelled row", err0, cancel)
                got, want = got[:, 1:], want[:, 1:]
            scale = want.abs() + want.abs().amax(dim=-1, keepdim=True)
            excess = (got - want).abs() - FLASH_BF16_ROW_TOL * scale
            assert float(excess.max()) <= 0.0, (name, "per row")


def test_flash_attention_autograd_launches_each_kernel_once(cuda):
    q = torch.randn((2, 70, 4, 32), device=cuda, requires_grad=True)
    flash_lib.reset_launches()
    out = flash_lib.flash_attention(q, q, q, causal=True)
    out.square().sum().backward()
    assert flash_lib.LAUNCHES == {"flash_fwd": 1, "flash_bwd_dq": 1,
                                  "flash_bwd_dkv": 1}
    ref = q.detach().cpu().requires_grad_(True)
    flash_lib.flash_attention(ref, ref, ref, causal=True).square().sum().backward()
    assert float((q.grad.cpu() - ref.grad).abs().max()) <= 1e-4 * float(ref.grad.abs().max())


def test_flash_wrappers_raise_rather_than_fall_back(cuda):
    q = torch.zeros((1, 8, 48), device=cuda)          # head dim 48: not built
    with pytest.raises(ValueError):
        flash_lib.flash_fwd(q, q, q, causal=True)
    for d in (160, 320):                               # nor these
        q4 = torch.zeros((1, 8, 2, d), device=cuda)
        with pytest.raises(ValueError, match="head dims"):
            flash_lib.flash_attention(q4, q4, q4[..., :128])
    q4 = torch.zeros((1, 8, 2, 128), device=cuda)
    with pytest.raises(ValueError, match="exceeds"):  # V wider than Q
        flash_lib.flash_attention(q4, q4, torch.zeros((1, 8, 2, 192), device=cuda))
    h = torch.zeros((1, 8, 16), dtype=torch.float16, device=cuda)
    with pytest.raises(TypeError):
        flash_lib.flash_fwd(h, h, h, causal=True)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("b,sq,skv,h,d,dv", [(2, 130, 130, 3, 192, 128),
                                             (1, 77, 40, 2, 192, 128),
                                             (2, 65, 65, 2, 128, 64),
                                             (1, 33, 100, 2, 128, 96)])
def test_flash_attention_narrow_v_card_equals_cpu(cuda, dtype, causal, b, sq, skv,
                                                  h, d, dv):
    """MLA's shapes through the differentiable wrapper: V zero-padded to D
    for the kernels, the output sliced.  Values and the three gradients on
    the card within the flash tolerance of the same wrapper on the CPU
    (the plain versions), one launch of each kernel."""
    gen = torch.Generator(device="cpu")
    gen.manual_seed(b * sq + skv + d + dv)
    q, k = (torch.randn((b, n, h, d), generator=gen).to(dtype) for n in (sq, skv))
    v = torch.randn((b, skv, h, dv), generator=gen).to(dtype)
    g = torch.randn((b, sq, h, dv), generator=gen).to(dtype)
    outs = {}
    for dev in ("cpu", cuda):
        leaves = [t.to(dev).requires_grad_(True) for t in (q, k, v)]
        flash_lib.reset_launches()
        o = flash_lib.flash_attention(*leaves, causal=causal)
        grads = torch.autograd.grad(o, leaves, g.to(dev))
        outs[str(dev)] = [o.detach().cpu().float()] + [x.cpu().float() for x in grads]
        launched = dict(flash_lib.LAUNCHES)
    assert launched == {"flash_fwd": 1, "flash_bwd_dq": 1, "flash_bwd_dkv": 1}
    for name, got, want in zip(("o", "dq", "dk", "dv"), outs[str(cuda)], outs["cpu"]):
        assert got.shape == want.shape and bool(torch.isfinite(got).all()), name
        err = float((got - want).abs().max())
        assert err <= FLASH_TOL[dtype] * float(want.abs().max()), (name, err)


@pytest.mark.parametrize("fault", ["data_ptr", "slab_stride"])
def test_flash_bf16_refuses_misaligned_slabs(cuda, fault):
    """The bf16 tensor-core kernels copy 16-byte chunks: a slab that does not
    start 16-byte aligned raises ValueError and launches nothing."""
    bh, s, d = 2, 64, 32
    good = torch.randn((bh, s, d), device=cuda).to(torch.bfloat16)
    if fault == "data_ptr":            # one element (2 bytes) off
        bad = torch.zeros(bh * s * d + 1, dtype=torch.bfloat16, device=cuda)[1:]
        bad = bad.view(bh, s, d)
    else:                              # slabs 4 elements apart from 8-aligned
        bad = torch.zeros((bh, s * d + 4), dtype=torch.bfloat16,
                          device=cuda)[:, :s * d].view(bh, s, d)
    lse = torch.zeros((bh, s), device=cuda)
    before = dict(flash_lib.LAUNCHES)
    with pytest.raises(ValueError, match="16-byte aligned"):
        flash_lib.flash_fwd(good, bad, good, causal=True)
    with pytest.raises(ValueError, match="16-byte aligned"):
        flash_lib.flash_bwd_dq(good, good, good, bad, lse, lse, causal=True)
    with pytest.raises(ValueError, match="16-byte aligned"):
        flash_lib.flash_bwd_dkv(good, good, good, bad, lse, lse, causal=True)
    assert flash_lib.LAUNCHES == before


# (M, K, N): decode rows with split K, ragged everything, prefill-like rows
INT_GEMM_SHAPES = [(8, 4096, 1024), (1, 200, 77), (33, 136, 300), (512, 256, 384)]


@pytest.mark.parametrize("fuse", [False, True])
@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("shape", INT_GEMM_SHAPES)
def test_packed_int_gemms_equal_plain(cuda, shape, bits, fuse):
    m, k, n = shape
    rng = np.random.default_rng(m + k + bits)
    v = 1 << (bits - 1)
    x = torch.from_numpy(rng.integers(-128, 128, (m, k)).astype(np.int8)).to(cuda)
    codes = torch.from_numpy(rng.integers(-v, v, (k, n)).astype(np.int8)).to(cuda)
    scales = torch.from_numpy(rng.uniform(1e-4, 1e-2, (1, n)).astype(np.float32)).to(cuda)
    w_packed = ops_lib.pack_values(codes, bits)
    before = qg_lib.LAUNCHES["quant_gemm"]
    got = qg_lib.quant_gemm(x, w_packed, scales, bits=bits, fuse_dequant=fuse)
    assert qg_lib.LAUNCHES["quant_gemm"] == before + 1
    want = ref_lib.quant_gemm_ref(x, w_packed, scales, bits=bits, fuse_dequant=fuse)
    assert torch.equal(got, want)
    kk = k - 3                                 # K off the codes per word
    words = packing.pack_codes(codes[:kk], bits)
    before = pg_lib.LAUNCHES["packed_gemm"]
    got = pg_lib.packed_gemm(x[:, :kk].contiguous(), words, scales, bits=bits,
                             k=kk, fuse_dequant=fuse)
    assert pg_lib.LAUNCHES["packed_gemm"] == before + 1
    want = ref_lib.packed_gemm_ref(x[:, :kk], words, scales, bits=bits, k=kk,
                                   fuse_dequant=fuse)
    assert torch.equal(got, want)
    if not fuse:
        exact = (x[:, :kk].cpu().long() @ codes[:kk].cpu().long())
        assert torch.equal(got.cpu().long(), exact)


@pytest.mark.parametrize("splits", [None, 1, 3], ids=["planned", "unsplit", "split3"])
@pytest.mark.parametrize("fuse", [False, True])
@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("m", [1, 7, 8, 9, 16, 17, 64, 512])
@pytest.mark.parametrize("k,n", [(203, 77), (256, 384), (1001, 144)])
def test_quant_gemm_tensor_cores_exact(cuda, monkeypatch, k, n, m, bits, fuse, splits):
    """The int8 tensor-core quant_gemm EQUAL to its plain version, int32 and
    fused float32: every row-block width (M 1..512), K (cut to a multiple
    of 8/bits) off the 64-wide tile and, at 8 and 4 bits, off 4 (x word
    loads byte by byte), N off the 128-wide tile and off 16 (plain word
    loads) or on it (cp.async), with the planned split K, none, and 3."""
    if splits is not None:
        monkeypatch.setattr(qg_lib, "plan_splits", lambda *shape: splits)
    k -= k % (8 // bits)
    rng = np.random.default_rng(100 * bits + m + k)
    v = 1 << (bits - 1)
    x = torch.from_numpy(rng.integers(-128, 128, (m, k)).astype(np.int8)).to(cuda)
    codes = torch.from_numpy(rng.integers(-v, v, (k, n)).astype(np.int8)).to(cuda)
    scales = torch.from_numpy(rng.uniform(1e-4, 1e-2, (1, n)).astype(np.float32)).to(cuda)
    w_packed = ops_lib.pack_values(codes, bits)
    before = qg_lib.LAUNCHES["quant_gemm"]
    got = qg_lib.quant_gemm(x, w_packed, scales, bits=bits, fuse_dequant=fuse)
    torch.cuda.synchronize()
    assert qg_lib.LAUNCHES["quant_gemm"] == before + 1
    want = ref_lib.quant_gemm_ref(x, w_packed, scales, bits=bits, fuse_dequant=fuse)
    assert got.dtype == want.dtype and torch.equal(got, want)
    if not fuse:
        assert torch.equal(got.cpu(), gemm_sims.bgemm_exact(x.cpu(), codes.cpu()))


@pytest.mark.parametrize("splits", [None, 1, 3], ids=["planned", "unsplit", "split3"])
@pytest.mark.parametrize("fuse", [False, True])
@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("m", [1, 7, 8, 9, 16, 17, 64, 512])
@pytest.mark.parametrize("k,n", [(203, 77), (256, 384), (1001, 144), (100, 132)])
def test_packed_gemm_tensor_cores_exact(cuda, monkeypatch, k, n, m, bits, fuse, splits):
    """packed_gemm on the int8 tensor cores EQUAL to its plain version,
    int32 and fused float32, and to the integer GEMM: every row-block width
    (M 1..512), K off the 64-wide tile and off the codes per word (203, 1001,
    100 at 2/4 bits) or on both (256), N off 4 (masked word loads: 77) or on
    it (cp.async: 132 off 16, 144 and 384 on it), with the planned split K,
    none, and 3."""
    if splits is not None:
        monkeypatch.setattr(pg_lib, "plan_splits", lambda *shape: splits)
    rng = np.random.default_rng(200 * bits + m + k)
    v = 1 << (bits - 1)
    x = torch.from_numpy(rng.integers(-128, 128, (m, k)).astype(np.int8)).to(cuda)
    codes = torch.from_numpy(rng.integers(-v, v, (k, n)).astype(np.int8)).to(cuda)
    scales = torch.from_numpy(rng.uniform(1e-4, 1e-2, (1, n)).astype(np.float32)).to(cuda)
    words = packing.pack_codes(codes, bits)
    before = pg_lib.LAUNCHES["packed_gemm"]
    got = pg_lib.packed_gemm(x, words, scales, bits=bits, k=k, fuse_dequant=fuse)
    torch.cuda.synchronize()
    assert pg_lib.LAUNCHES["packed_gemm"] == before + 1
    want = ref_lib.packed_gemm_ref(x, words, scales, bits=bits, k=k, fuse_dequant=fuse)
    assert got.dtype == want.dtype and torch.equal(got, want)
    if not fuse:
        assert torch.equal(got.cpu(), gemm_sims.bgemm_exact(x.cpu(), codes.cpu()))


@pytest.mark.parametrize("shape", [(1, 1), (32, 32), (33, 70), (100, 129),
                                   (4096, 1024), (14336, 4096)])
def test_block_stats_kernel_equals_plain(cuda, shape):
    rng = np.random.default_rng(shape[1])
    q = rng.integers(-8, 8, shape)
    q[rng.random(shape) < 0.3] = 0
    q = torch.from_numpy(q.astype(np.int8)).to(cuda)
    before = bs_lib.LAUNCHES["block_stats"]
    maxes, zeros = bs_lib.block_stats(q)
    assert bs_lib.LAUNCHES["block_stats"] == before + 1
    want_max, want_zero = ref_lib.block_stats_ref(q)
    assert torch.equal(maxes, want_max) and torch.equal(zeros, want_zero)


@pytest.mark.parametrize("tile", bs_lib.TILES)
@pytest.mark.parametrize("codes", ["int8", "4bit", "zeros"])
@pytest.mark.parametrize("shape", [(1, 1), (33, 70), (100, 129), (257, 1000),
                                   (1000, 777), (4096, 1024), (2_100_000, 32)])
def test_block_stats_every_tile_bit_exact(cuda, shape, codes, tile):
    """Every tile 1..128 EQUAL to the plain version over the full int8 range
    (-128 included), 4-bit codes with zeros, and an all-zero matrix;
    (2,100,000, 32) has more than 65,535 tile rows at every tile.  The
    launch's two sums equal the tile statistics' sums, and
    bit_sparsity_stats' floats are bit-identical to those of the tile
    statistics."""
    rng = np.random.default_rng(shape[0] + tile)
    if codes == "int8":
        q = rng.integers(-128, 128, shape)
        q.flat[::7] = -128
    elif codes == "4bit":
        q = rng.integers(-8, 8, shape)
        q[rng.random(shape) < 0.3] = 0
    else:
        q = np.zeros(shape)
    q = torch.from_numpy(q.astype(np.int8)).to(cuda)
    before = bs_lib.LAUNCHES["block_stats"]
    maxes, zeros, sums = bs_lib.block_stats_with_sums(q, tile=tile)
    torch.cuda.synchronize()
    assert bs_lib.LAUNCHES["block_stats"] == before + 1
    want_max, want_zero = ref_lib.block_stats_ref(q, tile)
    assert torch.equal(maxes, want_max) and torch.equal(zeros, want_zero)
    assert sums.tolist() == [int(want_max.sum(dtype=torch.int64)),
                             int(want_zero.sum(dtype=torch.int64))]
    assert bs_lib._STATE[cuda.index].tolist() == [0, 0, 0]   # reset for the next launch
    m, n = shape
    for bits in (4, 8):
        got = ops_lib.bit_sparsity_stats(q, bits=bits, tile=tile)
        want = ref_lib.sparsity_from_block_stats(want_max, want_zero, m, n, bits, tile)
        assert got == want, (got, want)


def test_packed_wrappers_raise_rather_than_fall_back(cuda):
    x = torch.zeros((2, 8), dtype=torch.int8, device=cuda)
    with pytest.raises(ValueError):
        qg_lib.quant_gemm(x, torch.zeros((4, 2), dtype=torch.int8), bits=4)
    with pytest.raises(ValueError, match="tile"):
        bs_lib.block_stats(x, tile=48)        # divides no (256, 128) block


# -- per-site plans on the card (smoke width) ---------------------------------

def _smoke_plan_setup(cuda):
    from repro_torch import backends, configs
    from repro_torch.models import model as model_lib
    cfg = configs.get_smoke_config("llama3-8b").replace(compute_dtype="float32")
    gen = torch.Generator(device=cuda)
    gen.manual_seed(0)
    params = model_lib.init_params(cfg, gen, device=cuda)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (3, 9)).astype(np.int32)).to(cuda)
    plan = backends.BackendPlan(sites=(
        backends.SiteAssignment("layers/attn/*", "tubgemm", 4),
        backends.SiteAssignment("layers/mlp/*", "tugemm", 4),
        backends.SiteAssignment("lm_head", "bgemm", 8)))
    return cfg, params, tokens, plan


def _kernel_plan(plan):
    """The plan with every design that has a ``*_cuda`` mirror rewritten to
    it, as chip_smoke.py does."""
    import dataclasses as dc
    from repro_torch import backends
    mirror = {sim: cuda for cuda, sim in backends.KERNEL_SIBLINGS.items()}
    return dc.replace(plan, sites=tuple(
        dc.replace(e, design=mirror.get(e.design, e.design)) for e in plan.sites))


def _plan_forward(cfg, params, tokens, plan):
    from repro_torch import backends
    from repro_torch.models import common as common_lib
    from repro_torch.models import model as model_lib
    outs = []
    with backends.use_plan(plan, on_output=lambda s, o: outs.append((s, o.clone()))), \
            common_lib.activation_scaling("per-row"):
        logits, _ = model_lib.forward(params, cfg, tokens)
    return outs, logits


def test_cuda_plan_equals_simulated_plan(cuda):
    cfg, params, tokens, plan = _smoke_plan_setup(cuda)
    ug.reset_launches()
    sim_outs, sim_logits = _plan_forward(cfg, params, tokens, plan)
    assert ug.LAUNCHES == {"tub_gemm": 0, "tu_gemm": 0}
    outs, logits = _plan_forward(cfg, params, tokens, _kernel_plan(plan))
    assert ug.LAUNCHES == {"tub_gemm": 4 * cfg.num_layers,
                           "tu_gemm": 3 * cfg.num_layers}
    assert len(outs) == len(sim_outs) == 7 * cfg.num_layers + 1
    for (s, a), (t, b) in zip(outs, sim_outs):
        assert s == t and torch.equal(a, b), s
    assert torch.equal(logits, sim_logits)


def test_packed_plan_equals_unpacked_on_card(cuda):
    from repro_torch import backends
    cfg, params, tokens, plan = _smoke_plan_setup(cuda)
    plan = _kernel_plan(plan)
    packed = backends.pack_weights(cfg, params, plan)
    assert all(packing.is_packed(w) for w in packed["layers"]["mlp"].values())
    assert packed["layers"]["mlp"]["w_up"].packed.is_cuda
    outs, logits = _plan_forward(cfg, params, tokens, plan)
    p_outs, p_logits = _plan_forward(cfg, packed, tokens, plan)
    assert torch.equal(logits, p_logits)
    for (s, a), (t, b) in zip(outs, p_outs):
        assert s == t and torch.equal(a, b), s


def test_cuda_plan_entry_launches_the_kernel(cuda, monkeypatch):
    """A ``*_cuda`` entry launches its kernel on a CUDA tensor and never
    reaches the plain slot loop or the simulated design."""
    from repro_torch import backends

    def refuse(*_args, **_kw):
        raise AssertionError("a *_cuda entry reached a plain version")

    cfg, params, tokens, _ = _smoke_plan_setup(cuda)
    monkeypatch.setattr(ug, "tub_gemm_ref", refuse)
    monkeypatch.setattr(gemm_sims, "tubgemm_exact", refuse)
    monkeypatch.setattr(gemm_sims, "bgemm_exact", refuse)
    plan = backends.BackendPlan(sites=(
        backends.SiteAssignment("*", "tubgemm_cuda", 4),))
    ug.reset_launches()
    outs, _ = _plan_forward(cfg, params, tokens, plan)
    assert ug.LAUNCHES["tub_gemm"] == len(outs) == 7 * cfg.num_layers + 1


def test_engine_packed_plan_streams_on_card(cuda):
    from repro_torch.models import common as common_lib
    from repro_torch.serving import ServingEngine, TrafficConfig, generate_trace
    cfg, params, _, plan = _smoke_plan_setup(cuda)
    plan = _kernel_plan(plan)
    trace = generate_trace(TrafficConfig(num_requests=4, arrival_rate=1.0, seed=0))
    streams = []
    for packed in (False, True):
        eng = ServingEngine(cfg, params, plan=plan, packed=packed, bits=4,
                            max_batch=4, page_size=8, max_seq_len=64, device=cuda)
        ug.reset_launches()
        with common_lib.activation_scaling("per-row"):
            rep = eng.run(trace, "continuous")
        assert rep.requests == 4 and ug.LAUNCHES["tub_gemm"] > 0
        streams.append(rep.request_tokens)
    assert streams[0] == streams[1]


@pytest.mark.parametrize("m,k,n", [(1, 64, 512), (8, 64, 512), (17, 64, 512),
                                   (24, 64, 512), (27, 64, 512), (33, 100, 70),
                                   (256, 4096, 1024), (27, 192, 64)])
def test_bgemm_exact_on_card_at_any_rows(cuda, m, k, n):
    """The simulated designs' integer GEMM on CUDA tensors (exact fp32
    chunks) equals the CPU's integer matmul at any M: a plan's prefill rows
    reach it (cuBLASLt's int8 matmul, used before, refused M = 24 and 27)."""
    rng = np.random.default_rng(m + k + n)
    a = rng.integers(-128, 128, (m, k)).astype(np.int8)
    b = rng.integers(-128, 128, (k, n)).astype(np.int8)
    want = torch.from_numpy(a).int() @ torch.from_numpy(b).int()
    got = gemm_sims.bgemm_exact(torch.from_numpy(a).to(cuda),
                                torch.from_numpy(b).to(cuda))
    assert got.dtype == torch.int32 and torch.equal(got.cpu(), want)


@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("m,k,n", [(8, 4096, 1024), (27, 4096, 512),
                                   (3, 70_000, 5)])
def test_ugemm_exact_card_equals_cpu(monkeypatch, cuda, m, k, n, bits):
    """uGEMM's exact slot counts (float32 chunk products) on the card equal
    the CPU's bit for bit, also past the float32 window (K * 2^bits >=
    2^24 splits K), with a tight budget forcing many chunks."""
    v = 2 ** (bits - 1) - 1
    rng = np.random.default_rng(m + k + n + bits)
    a = torch.from_numpy(rng.integers(-v, v + 1, (m, k)).astype(np.int8))
    b = torch.from_numpy(rng.integers(-v, v + 1, (k, n)).astype(np.int8))
    want = gemm_sims.ugemm_exact(a, b, bits=bits)
    for budget in (gemm_sims.CHUNK_BUDGET_BYTES, 1 << 20):
        monkeypatch.setattr(gemm_sims, "CHUNK_BUDGET_BYTES", budget)
        got = gemm_sims.ugemm_exact(a.to(cuda), b.to(cuda), bits=bits)
        assert got.is_cuda and torch.equal(got.cpu(), want)


@pytest.mark.parametrize("kind,stream_len,bits", [
    ("sobol", 64, 8), ("sobol", 16, 4), ("lfsr", 16, 8), ("lfsr", 100, 4)])
def test_stochastic_gemm_card_equals_cpu(cuda, kind, stream_len, bits):
    from repro_torch.stochastic import sgemm
    v = 2 ** (bits - 1) - 1
    rng = np.random.default_rng(stream_len + bits)
    a = torch.from_numpy(rng.integers(-v, v + 1, (8, 4096)).astype(np.int8))
    b = torch.from_numpy(rng.integers(-v, v + 1, (4096, 768)).astype(np.int8))
    want = sgemm.stochastic_gemm(a, b, bits, stream_len=stream_len,
                                 rng_kind=kind)
    got = sgemm.stochastic_gemm(a.to(cuda), b.to(cuda), bits,
                                stream_len=stream_len, rng_kind=kind)
    assert got.is_cuda and torch.equal(got.cpu(), want)


def test_ugemm_engines_refuse_operands_on_two_devices(cuda):
    """Activations on the CPU and a weight on the card raise; neither
    engine copies the weight to the host to contract it there."""
    from repro_torch.stochastic import sgemm
    a = torch.ones((2, 64), dtype=torch.int8)
    b = torch.ones((64, 8), dtype=torch.int8, device=cuda)
    with pytest.raises(ValueError, match="different devices"):
        gemm_sims.ugemm_exact(a, b, bits=4)
    with pytest.raises(ValueError, match="different devices"):
        sgemm.stochastic_gemm(a, b, 4, stream_len=16)


@pytest.mark.parametrize("grid", [(2, 2), (3, 2)])
@pytest.mark.parametrize("spec,bits", [("tubgemm_cuda", 2), ("tubgemm_cuda", 4),
                                       ("tubgemm_cuda", 8), ("tugemm_cuda", 4),
                                       ("tugemm_cuda", 8), ("bgemm", 4),
                                       ("ugemm", 4)])
def test_grid_execute_card_equals_cpu(cuda, spec, bits, grid):
    """A PE-array grid at a decode site's shape (8 rows into wk, 4096 ->
    1024): card equal to CPU and to the card's single unit, bit for bit,
    from flat codes and from the shard blocks; the kernel mirrors launch
    their kernel once a shard."""
    from repro_torch import backends
    rng = np.random.default_rng(bits + grid[0])
    v = 2 ** (bits - 1) - 1
    a = torch.from_numpy(rng.integers(-v, v + 1, (8, 4096)).astype(np.int8))
    w = torch.from_numpy(rng.integers(-v, v + 1, (4096, 1024)).astype(np.int8))
    unit = backends.resolve(spec, bits=bits)
    gb = backends.as_grid(unit, *grid)
    want = gb.execute(a, w)
    assert torch.equal(want, unit.execute(a, w))
    ac, wc = a.to(cuda), w.to(cuda)
    codes = gb.shard_codes(wc)
    ug.reset_launches()
    got = gb.execute(ac, codes)
    name = {"tubgemm_cuda": "tub_gemm", "tugemm_cuda": "tu_gemm"}.get(spec)
    if name:
        assert ug.LAUNCHES[name] == grid[0] * grid[1]
    assert got.is_cuda and torch.equal(got.cpu(), want)
    assert torch.equal(gb.execute(ac, wc), unit.execute(ac, wc))


@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("spec", ["tubgemm_cuda", "tugemm_cuda"])
@pytest.mark.parametrize("k,n", [(4096, 1024), (4096, 4096), (4096, 14336),
                                 (14336, 4096)])
def test_grid_kernels_exact_at_every_served_shard_shape(cuda, k, n, spec, bits):
    """A 2x2 grid of a kernel mirror at 8 rows into each distinct
    llama3-8b dense-site shape, so at every shard shape a grid-served decode
    step gives the kernels (K of 2048 and 7168): equal bit for bit to the
    integer product, computed in float64 (exact for these K), and to the
    card's single unit."""
    from repro_torch import backends
    rng = np.random.default_rng(k + n + bits)
    v = 2 ** (bits - 1) - 1
    a = torch.from_numpy(rng.integers(-v, v + 1, (8, k)).astype(np.int8))
    w = torch.from_numpy(rng.integers(-v, v + 1, (k, n)).astype(np.int8))
    want = (a.double() @ w.double()).to(torch.int32)
    unit = backends.resolve(spec, bits=bits)
    gb = backends.as_grid(unit, 2, 2)
    ac, wc = a.to(cuda), w.to(cuda)
    ug.reset_launches()
    got = gb.execute(ac, gb.shard_codes(wc))
    assert ug.LAUNCHES[{"tubgemm_cuda": "tub_gemm",
                        "tugemm_cuda": "tu_gemm"}[spec]] == 4
    assert got.is_cuda and torch.equal(got.cpu(), want)
    assert torch.equal(got, unit.execute(ac, wc))


def test_kernel_crosscheck_on_card(cuda):
    """The sweet-spot report's cross-check at the reference's (8, 16, 8),
    far under the kernels' tiles: the kernels launch, and every row's
    output and cycles agree with the simulators."""
    from repro_torch.eval import sweetspot
    ug.reset_launches()
    rows = sweetspot.kernel_crosscheck(device=cuda)
    assert len(rows) == 6 and all(r["output_ok"] and r["cycles_ok"] for r in rows)
    assert ug.LAUNCHES["tub_gemm"] == ug.LAUNCHES["tu_gemm"] == 3


def _chip_smoke():
    """``chip_smoke.py`` (beside ``tests/``) as a module; its ``main``
    refuses a host without CUDA, its card checks need one."""
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("arch", ["phi3.5-moe-42b-a6.6b", "deepseek-v3-671b"])
def test_moe_and_mla_models_card_equal_cpu(cuda, arch):
    """The narrow MoE and MLA models on the card (flash at their head dims,
    D = 192 with a 128-wide V for MLA) against the same code on the CPU,
    through the one body chip_smoke.py's families phase runs
    (``narrow_family``, ``_family_card_vs_cpu``): routing indices equal,
    forward / prefill / three decode logits within 1e-4, greedy tokens
    equal, loss and every gradient within 1e-4, the flash kernels launched
    once a layer.  A mismatch raises ``chip_smoke.Failed``."""
    _chip_smoke()._family_card_vs_cpu(arch)


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "rwkv6-3b", "mamba2"])
def test_recurrent_models_card_equal_cpu(cuda, arch):
    """The narrow recurrent models (zamba2's hybrid stack with flash at
    D = 64, rwkv6, a pure Mamba2 stack; SSD and WKV dims as published) on
    the card against the same code on the CPU, through the one body
    chip_smoke.py's recurrent phase runs (``narrow_recurrent``,
    ``_recurrent_card_vs_cpu``): forward / prefill / three decode logits
    within 1e-4, greedy tokens equal, every cache leaf, the loss and every
    gradient within 1e-4 of max(1, max|CPU|), flash launched once per
    shared-block application.  A mismatch raises ``chip_smoke.Failed``."""
    _chip_smoke()._recurrent_card_vs_cpu(arch)


# -- the serving engine's decode step captured as a CUDA graph -----------------

#: engines whose decode step the graph runs: the unary kernels under a
#: backend scope, the float path (cuBLAS head and output projection) on
#: either attention, the count-decoded uGEMM, cfg.quant_kernel's packed
#: kernel with no scope, and gemma's scaled embedding and soft-capped head
GRAPH_ENGINES = {
    "gemma-tubgemm_cuda-fused": dict(arch="gemma-7b", backend="tubgemm_cuda"),
    "tubgemm_cuda-fused": dict(backend="tubgemm_cuda", attention="fused"),
    "tugemm_cuda-gather": dict(backend="tugemm_cuda", attention="gather"),
    "float-fused": dict(attention="fused"),
    "float-gather": dict(attention="gather"),
    "ugemm-fused": dict(backend="ugemm", attention="fused"),
    "quant_kernel-fused": dict(attention="fused", quant_kernel=True),
}


def _graph_engine(cuda, backend=None, attention="fused", quant_kernel=False,
                  arch="llama3-8b"):
    from repro_torch import configs
    from repro_torch.models import model as model_lib
    from repro_torch.serving import ServingEngine
    cfg = configs.get_smoke_config(arch).replace(compute_dtype="float32")
    if quant_kernel:
        cfg = cfg.replace(quant_bits=4, quant_kernel=True)
    gen = torch.Generator(device=cuda)
    gen.manual_seed(0)
    params = model_lib.init_params(cfg, gen, device=cuda)
    return ServingEngine(cfg, params, backend=backend, bits=4,
                         attention=attention, max_batch=4, page_size=8,
                         max_seq_len=64, device=cuda)


@pytest.mark.parametrize("which", list(GRAPH_ENGINES))
def test_replayed_decode_step_equals_the_eager_body(cuda, which):
    """Over a trace with admissions, evictions and slot reuse, every decode
    step (replayed from the graph after the first two) equals the eager
    body run on a copy of the state before it, bit for bit: the logits,
    both pools, the lengths and every site's int32 handed to on_output.
    A second run on the same engine replays from its first step."""
    from repro_torch import backends
    from repro_torch.models.common import activation_scaling
    from repro_torch.serving import TrafficConfig, generate_trace
    eng = _graph_engine(cuda, **GRAPH_ENGINES[which])
    trace = generate_trace(TrafficConfig(num_requests=8, arrival_rate=0.8,
                                         seed=1))
    decode = eng._decode
    how = []

    def checked(params, tokens, k_pool, v_pool, tables, lengths, active):
        execution = backends.active_execution()
        before = [t.clone() for t in (tokens, k_pool, v_pool, tables,
                                      lengths, active)]
        counts = dict(eng.decode_counts)
        out = decode(params, tokens, k_pool, v_pool, tables, lengths, active)
        how.append(next(k for k in ("eager", "replays")
                        if eng.decode_counts[k] != counts[k]))
        got = tuple(t.clone() for t in out)
        want_sites: list = []
        hook = None if execution is None else execution.on_output
        if execution is not None:
            execution.on_output = lambda s, o: want_sites.append((s, o))
        try:
            want = eng._decode_step(params, *before)
        finally:
            if execution is not None:
                execution.on_output = hook
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and torch.equal(a, b), how[-1]
        sites = seen[len(seen) - len(want_sites):] if want_sites else []
        assert [s for s, _ in sites] == [s for s, _ in want_sites]
        assert all(torch.equal(a, b) for (_, a), (_, b) in zip(sites, want_sites))
        return out                  # the run goes on with the step's own pools

    seen: list = []
    eng.on_gemm_output = lambda s, o: seen.append((s, o.clone()))
    eng._decode = checked
    with activation_scaling("per-row"):
        rep = eng.run(trace, "continuous")
        again = eng.run(trace, "continuous")
    assert rep.requests == len(trace) and rep.decode_steps > 8
    assert (rep.decode_eager, rep.decode_captures) == (1, 1)
    assert rep.decode_replays == rep.decode_steps - 1
    assert how == ["eager"] + ["replays"] * (rep.decode_steps
                                             + again.decode_steps - 1)
    assert (again.decode_eager, again.decode_captures) == (0, 0)
    assert again.request_tokens == rep.request_tokens
    assert bool(eng.backend) == (len(seen) > 0)


def test_replayed_decode_steps_run_their_kernels(cuda):
    """The kernels' LAUNCHES count their wrappers' calls: the eager step and
    the capture issue one step's each (7 sites a layer and the head on
    tub_gemm, one fused decode a layer), the replays (the captured step's
    own, then N more) none.  The profiler
    counts the kernels the N replays ran on the card: as many as N eager
    steps run."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models.common import activation_scaling
    eng = _graph_engine(cuda, backend="tubgemm_cuda")
    cfg, b = eng.cfg, eng.max_batch
    cache = eng.new_cache()
    tables = torch.zeros((b, cache.max_blocks), dtype=torch.int32)
    for i in range(b):
        cache.allocate(i, 30)
        tables[i] = torch.from_numpy(cache.block_table_row(i))
    args = (torch.arange(1, b + 1, dtype=torch.int32, device=cuda)[:, None],
            cache.k_pool, cache.v_pool, tables.to(cuda),
            torch.full((b,), 20, dtype=torch.int32, device=cuda),
            torch.ones((b,), dtype=torch.bool, device=cuda))
    n = 5

    def counts():
        return (ug.LAUNCHES["tub_gemm"], ug.LAUNCHES["tu_gemm"],
                fused_lib.LAUNCHES["fused_paged_decode"])

    def on_card(step):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                step(eng.params, *args)
            torch.cuda.synchronize()
        rows = [(e.key, e.count) for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA]
        return tuple(sum(c for key, c in rows if piece in key)
                     for piece in ("TubPulses", "TuPulses",
                                   "fused_decode_split_kernel"))

    with eng._scope(), activation_scaling("per-row"):
        ug.reset_launches()
        fused_lib.reset_launches()
        eng._decode(eng.params, *args)                  # eager
        eng._decode(eng.params, *args)                  # captured, replayed
        issued = counts()
        replayed = on_card(eng._decode)
        after = counts()
        eager = on_card(eng._decode_step)
    assert eng.decode_counts == {"eager": 1, "replays": n + 1, "captures": 1}
    step = (7 * cfg.num_layers + 1, 0, cfg.num_layers)
    assert issued == after == tuple(2 * x for x in step)
    assert replayed == eager == tuple(n * x for x in step)
