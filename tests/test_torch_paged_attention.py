"""Port vs reference: paged decode attention.

* gather oracle vs gather oracle (``paged_decode_attention``): <= 1e-5 at
  fp32 (same math, float reductions ordered by two different libraries);
* the port's plain page walk (what its fused wrapper runs on CPU tensors;
  the CUDA kernel is held to it on the card), whole or over the kernel's
  split ranges with the log-sum-exp merge, vs the reference's Pallas
  kernel in interpret mode and vs both oracles: <= 1e-4, the reference's own
  ``FUSED_LOGIT_TOL`` (online softmax re-associates the reduction);
* the kernel's split plan and instance geometry, pure functions of shapes;
* ``write_kv_token`` / ``gather_kv`` are pure data movement: EQUAL.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import paged_attention as ref_paged
from repro.kernels import paged_attention_fused as ref_fused
from repro_torch.kernels import paged_attention as port_paged
from repro_torch.kernels import paged_attention_fused as port_fused

ORACLE_TOL = 1e-5
WALK_TOL = 1e-4


def _case(seed, *, batch, page, kvh, gqa, hd=16, max_blocks=4, lengths=None,
          poison=False):
    rng = np.random.default_rng(seed)
    h = kvh * gqa
    num_pages = 1 + batch * max_blocks
    perm = rng.permutation(np.arange(1, num_pages)).astype(np.int32)
    bt = perm.reshape(batch, max_blocks)
    if lengths is None:
        lengths = rng.integers(1, max_blocks * page + 1, size=batch)
    lens = np.asarray(lengths, np.int32)
    pk = rng.standard_normal((num_pages, page, kvh, hd)).astype(np.float32)
    pv = rng.standard_normal((num_pages, page, kvh, hd)).astype(np.float32)
    q = rng.standard_normal((batch, 1, h, hd)).astype(np.float32)
    pkp, pvp = pk.copy(), pv.copy()
    if poison:
        dead = np.ones(num_pages, bool)
        for i in range(batch):
            dead[bt[i, : -(-int(lens[i]) // page)]] = False
        pkp[dead] = np.nan
        pvp[dead] = np.nan
    return q, pk, pv, pkp, pvp, bt, lens, h


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("page", [3, 4, 8])
@pytest.mark.parametrize("gqa", [1, 2, 4])
def test_walk_and_oracle_match_reference(page, gqa):
    q, pk, pv, pkp, pvp, bt, lens, h = _case(page * 10 + gqa, batch=3, page=page,
                                             kvh=2, gqa=gqa, poison=True)
    ref_oracle = np.asarray(ref_paged.paged_decode_attention(
        jnp.asarray(q), jnp.asarray(pk), jnp.asarray(pv), jnp.asarray(bt),
        jnp.asarray(lens), num_heads=h))
    ref_kernel = np.asarray(ref_fused.fused_paged_decode_attention(
        jnp.asarray(q), jnp.asarray(pkp), jnp.asarray(pvp), jnp.asarray(bt),
        jnp.asarray(lens), num_heads=h, impl="pallas", interpret=True))
    tq, tpk, tpv, tpkp, tpvp, tbt, tlens = _t(q, pk, pv, pkp, pvp, bt, lens)
    oracle = port_paged.paged_decode_attention(tq, tpk, tpv, tbt, tlens,
                                               num_heads=h).numpy()
    walk = port_fused.fused_paged_decode_attention(tq, tpkp, tpvp, tbt, tlens,
                                                   num_heads=h).numpy()
    assert np.isfinite(walk).all(), "the page walk read a dead (NaN) page"
    assert oracle.shape == walk.shape == ref_oracle.shape == (3, 1, h, 16)
    assert np.abs(oracle - ref_oracle).max() <= ORACLE_TOL
    assert np.abs(walk - ref_kernel).max() <= WALK_TOL
    assert np.abs(walk - oracle).max() <= WALK_TOL
    assert np.abs(walk - ref_oracle).max() <= WALK_TOL


@pytest.mark.parametrize("page", [3, 4, 8])
def test_len_one_and_page_boundaries(page):
    lengths = [1, page, page + 1, 4 * page]
    q, pk, pv, pkp, pvp, bt, lens, h = _case(page, batch=4, page=page, kvh=2,
                                             gqa=2, lengths=lengths, poison=True)
    ref_oracle = np.asarray(ref_paged.paged_decode_attention(
        jnp.asarray(q), jnp.asarray(pk), jnp.asarray(pv), jnp.asarray(bt),
        jnp.asarray(lens), num_heads=h))
    tq, tpkp, tpvp, tbt, tlens = _t(q, pkp, pvp, bt, lens)
    walk = port_fused.fused_paged_decode_attention(tq, tpkp, tpvp, tbt, tlens,
                                                   num_heads=h).numpy()
    assert np.isfinite(walk).all()
    assert np.abs(walk - ref_oracle).max() <= WALK_TOL
    # a single valid token: the output is that token's V row, exactly
    first_page = bt[0, 0]
    want = np.repeat(pv[first_page, 0], 2, axis=0)      # (KVH*G, hd)
    np.testing.assert_allclose(walk[0, 0], want, atol=1e-6)


def test_trash_page_slot_like_an_evicted_request():
    # evicted slots: block-table row all zeros (the trash page), length 0,
    # so the engine passes kv_valid_len = 1 on page 0
    q, pk, pv, _, _, bt, lens, h = _case(5, batch=2, page=4, kvh=2, gqa=2)
    bt[1] = 0
    lens[1] = 1
    ref_oracle = np.asarray(ref_paged.paged_decode_attention(
        jnp.asarray(q), jnp.asarray(pk), jnp.asarray(pv), jnp.asarray(bt),
        jnp.asarray(lens), num_heads=h))
    tq, tpk, tpv, tbt, tlens = _t(q, pk, pv, bt, lens)
    walk = port_fused.fused_paged_decode_attention(tq, tpk, tpv, tbt, tlens,
                                                   num_heads=h).numpy()
    assert np.abs(walk - ref_oracle).max() <= WALK_TOL


def test_bf16_pools():
    q, pk, pv, _, _, bt, lens, h = _case(21, batch=3, page=4, kvh=2, gqa=2)
    jk = jnp.asarray(pk).astype(jnp.bfloat16)
    jv = jnp.asarray(pv).astype(jnp.bfloat16)
    ref_kernel = np.asarray(ref_fused.fused_paged_decode_attention(
        jnp.asarray(q), jk, jv, jnp.asarray(bt), jnp.asarray(lens),
        num_heads=h, impl="pallas", interpret=True))
    ref_oracle = np.asarray(ref_paged.paged_decode_attention(
        jnp.asarray(q), jk, jv, jnp.asarray(bt), jnp.asarray(lens), num_heads=h))
    tq, tpk, tpv, tbt, tlens = _t(q, pk, pv, bt, lens)
    tpk, tpv = tpk.to(torch.bfloat16), tpv.to(torch.bfloat16)
    np.testing.assert_array_equal(np.asarray(jk.astype(jnp.float32)),
                                  tpk.float().numpy())
    walk = port_fused.fused_paged_decode_attention(tq, tpk, tpv, tbt, tlens,
                                                   num_heads=h)
    oracle = port_paged.paged_decode_attention(tq, tpk, tpv, tbt, tlens,
                                               num_heads=h)
    assert walk.dtype == torch.float32
    assert np.abs(walk.numpy() - ref_kernel).max() <= WALK_TOL
    assert np.abs(oracle.numpy() - ref_oracle).max() <= ORACLE_TOL
    # bf16 queries: output comes back in q's dtype
    out = port_fused.fused_paged_decode_attention(
        tq.to(torch.bfloat16), tpk, tpv, tbt, tlens, num_heads=h)
    assert out.dtype == torch.bfloat16
    assert np.abs(out.float().numpy() - ref_kernel).max() <= 3e-2  # bf16 rounding


@pytest.mark.parametrize("splits", [1, 2, 3, "max"])
@pytest.mark.parametrize("page", [3, 4])
def test_split_walk_matches_reference(page, splits):
    """The plain walk over the kernel's split ranges, merged in split order
    by log-sum-exp (what the CUDA kernel computes, and what the card holds
    it to), on NaN-poisoned dead pages: within WALK_TOL of the reference's
    Pallas kernel in interpret mode and of both gather oracles.  Lengths
    put the last live page in every split, and one request in the first
    split alone."""
    max_blocks = 6
    splits = max_blocks if splits == "max" else splits
    lengths = [1, 2 * page + 1, 4 * page - 1, max_blocks * page]
    q, pk, pv, pkp, pvp, bt, lens, h = _case(40 + page, batch=4, page=page, kvh=2,
                                             gqa=2, max_blocks=max_blocks,
                                             lengths=lengths, poison=True)
    ref_oracle = np.asarray(ref_paged.paged_decode_attention(
        jnp.asarray(q), jnp.asarray(pk), jnp.asarray(pv), jnp.asarray(bt),
        jnp.asarray(lens), num_heads=h))
    ref_kernel = np.asarray(ref_fused.fused_paged_decode_attention(
        jnp.asarray(q), jnp.asarray(pkp), jnp.asarray(pvp), jnp.asarray(bt),
        jnp.asarray(lens), num_heads=h, impl="pallas", interpret=True))
    tq, tpk, tpv, tpkp, tpvp, tbt, tlens = _t(q, pk, pv, pkp, pvp, bt, lens)
    oracle = port_paged.paged_decode_attention(tq, tpk, tpv, tbt, tlens,
                                               num_heads=h).numpy()
    walk = port_fused.fused_decode_plain(tq, tpkp, tpvp, tbt, tlens, num_heads=h,
                                         splits=splits).numpy()
    assert np.isfinite(walk).all(), "the split walk read a dead (NaN) page"
    assert np.abs(walk - ref_kernel).max() <= WALK_TOL
    assert np.abs(walk - oracle).max() <= WALK_TOL
    assert np.abs(walk - ref_oracle).max() <= WALK_TOL
    # the wrapper on CPU tensors runs the one-split walk, bit for bit
    via = port_fused.fused_paged_decode_attention(tq, tpkp, tpvp, tbt, tlens,
                                                  num_heads=h)
    assert np.abs(via.numpy() - walk).max() <= WALK_TOL
    if splits == 1:
        assert torch.equal(via, torch.from_numpy(walk))


@pytest.mark.parametrize("batch,kvh,max_blocks,resident,want", [
    (8, 8, 64, 8, 16),       # llama3-8b's serve geometry, 8 blocks an SM
    (8, 8, 64, 12, 22),      # 24 fit, 3 pages a split -> 22 splits
    (8, 8, 64, 3, 6),        # 6 fit: 11 pages a split -> 6 splits
    (1, 8, 64, 8, 64),       # one request: one page a split
    (128, 8, 64, 4, 1),      # a wide batch fills the card unsplit
    (8, 8, 1, 8, 1),         # one page: nothing to split
    (4, 2, 5, 16, 5)])
def test_decode_split_plan(batch, kvh, max_blocks, resident, want):
    """The fused decode kernel's plan, from shapes alone (never the valid
    lengths): the most splits of the page axis that keep the grid within
    one wave of resident blocks on 132 SMs, at most one page a split, with
    no empty split."""
    got = port_fused.plan_decode_splits(batch, kvh, max_blocks, sm_count=132,
                                        resident=resident)
    assert got == want
    pps, n = port_fused.split_geometry(max_blocks, got)
    assert n == got and (n - 1) * pps < max_blocks <= n * pps
    assert got == 1 or batch * kvh * got <= resident * 132


@pytest.mark.parametrize("hd,elem,want", [
    (64, 4, (16, 1, 4)), (96, 4, (32, 1, 4)), (128, 4, (32, 1, 4)),
    (256, 4, (32, 2, 4)), (64, 2, (8, 1, 4)), (96, 2, (16, 1, 4)),
    (128, 2, (16, 1, 4)), (256, 2, (32, 1, 4)), (1024, 4, (32, 8, 1)),
    (100, 2, (16, 1, 4))])
def test_decode_geometry(hd, elem, want):
    """Lanes a K/V row, 16-byte chunks a lane and query heads a block of the
    kernel instance: every head dim to MAX_HEAD_DIM is covered (lanes x
    chunks x 16 bytes >= a row), the queries and accumulators of a block fit
    the registers (gtile x chunks <= 8 fp32, 4 bf16), and every head dim
    maps onto the instances the kernel compiles (csrc/fused_paged_decode.cu
    dispatch): 5 for fp32 pools, 4 for bf16."""
    lanes, chunks, gtile = port_fused.decode_geometry(hd, elem)
    assert (lanes, chunks, gtile) == want
    assert lanes * chunks * (16 // elem) >= hd
    assert gtile * chunks <= (8 if elem == 4 else 4)
    compiled = {(8, 1, 4), (16, 1, 4), (32, 1, 4)} | (
        {(32, 2, 4), (32, 8, 1)} if elem == 4 else {(32, 4, 1)})
    every = {port_fused.decode_geometry(d, elem)
             for d in range(1, port_fused.MAX_HEAD_DIM + 1)}
    assert every == compiled
    with pytest.raises(ValueError, match="head dims"):
        port_fused.decode_geometry(port_fused.MAX_HEAD_DIM + 1, elem)


@pytest.mark.parametrize("page", [3, 8])
def test_write_and_gather_equal(page):
    rng = np.random.default_rng(page)
    batch, kvh, hd, max_blocks = 3, 2, 8, 3
    num_pages = 1 + batch * max_blocks
    pool = rng.standard_normal((num_pages, page, kvh, hd)).astype(np.float32)
    bt = rng.permutation(np.arange(1, num_pages)).astype(np.int32).reshape(batch, max_blocks)
    bt[2] = 0                                     # an evicted slot
    lengths = np.array([0, page + 1, 0], np.int32)
    new = rng.standard_normal((batch, kvh, hd)).astype(np.float32)
    ref_pool = np.asarray(ref_paged.write_kv_token(
        jnp.asarray(pool), jnp.asarray(bt), jnp.asarray(lengths),
        jnp.asarray(new), page))
    tpool = torch.from_numpy(pool.copy())
    ret = port_paged.write_kv_token(tpool, torch.from_numpy(bt),
                                    torch.from_numpy(lengths),
                                    torch.from_numpy(new), page)
    assert ret is tpool                           # in place
    np.testing.assert_array_equal(ref_pool, tpool.numpy())
    np.testing.assert_array_equal(
        np.asarray(ref_paged.gather_kv(jnp.asarray(ref_pool), jnp.asarray(bt))),
        port_paged.gather_kv(tpool, torch.from_numpy(bt)).numpy())


def test_bytes_moved_models_equal():
    kw = dict(page_size=16, num_kv_heads=8, head_dim=128, dtype_bytes=4)
    for lens in ([1], [16, 17, 1024], [5] * 8):
        assert ref_fused.fused_decode_bytes_moved(lens, **kw) \
            == port_fused.fused_decode_bytes_moved(lens, **kw)
    gk = dict(batch=8, max_blocks=64, page_size=16, num_kv_heads=8,
              num_heads=32, head_dim=128)
    assert ref_fused.gather_decode_bytes_moved(**gk) \
        == port_fused.gather_decode_bytes_moved(**gk)


def test_shape_checks_and_no_cpu_launches():
    q, pk, pv, _, _, bt, lens, h = _case(1, batch=2, page=4, kvh=2, gqa=2)
    tq, tpk, tpv, tbt, tlens = _t(q, pk, pv, bt, lens)
    port_fused.reset_launches()
    port_fused.fused_paged_decode_attention(tq, tpk, tpv, tbt, tlens, num_heads=h)
    assert port_fused.LAUNCHES == {"fused_paged_decode": 0}
    with pytest.raises(ValueError):
        port_fused.fused_paged_decode_attention(tq[:, 0], tpk, tpv, tbt, tlens, num_heads=h)
    with pytest.raises(ValueError):
        port_fused.fused_paged_decode_attention(tq, tpk, tpv[:-1], tbt, tlens, num_heads=h)
    with pytest.raises(ValueError):
        port_fused.fused_paged_decode_attention(tq, tpk, tpv, tbt, tlens, num_heads=3)
    with pytest.raises(ValueError):
        port_fused.fused_paged_decode_attention(tq, tpk, tpv, tbt[:1], tlens, num_heads=h)
    with pytest.raises(ValueError, match="no page column"):
        port_fused.fused_paged_decode_attention(tq, tpk, tpv, tbt[:, :0], tlens, num_heads=h)
