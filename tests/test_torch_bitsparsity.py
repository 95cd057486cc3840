"""Port vs reference: the per-tile bit-sparsity statistics (``block_stats``)
and ``ops.bit_sparsity_stats``, the Eq.-1 profile they feed.

The port's plain ``block_stats`` (what its wrapper runs on CPU tensors) must
be EQUAL to the reference's Pallas kernel in interpret mode and to
``kernels/ref.py`` on ragged M x N (pad cells of edge tiles count as
zeros).  ``bit_sparsity_stats`` must be within 1e-6 of the reference's and
of the port's ``core.sparsity.profile_tensor`` on the same codes (both
round their means to float32 the same way; the bound covers the reference's
eager division).  The CUDA kernel is held to the same plain version on the
card by ``chip_smoke.py`` and ``tests/test_torch_gpu.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import bitsparsity as ref_bs
from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_ref
from repro_torch.core.quantization import quantize
from repro_torch.core.sparsity import profile_tensor
from repro_torch.kernels import bitsparsity as port_bs
from repro_torch.kernels import ops as port_ops
from repro_torch.kernels import ref as port_ref

STAT_TOL = 1e-6
SHAPES = [(1, 1), (32, 32), (33, 70), (64, 31), (100, 129), (257, 40)]


def _codes(shape, bits, seed, zero_frac=0.3):
    rng = np.random.default_rng(seed)
    v = 1 << (bits - 1)
    q = rng.integers(-v, v, shape)
    q[rng.random(shape) < zero_frac] = 0
    return q.astype(np.int8)


@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("shape", SHAPES)
def test_block_stats_plain_equals_reference(shape, bits):
    q = _codes(shape, bits, seed=shape[0] + bits)
    ref_max, ref_zero = ref_bs.block_stats(jnp.asarray(q), interpret=True)
    maxes, zeros = port_bs.block_stats(torch.from_numpy(q))
    assert maxes.dtype == zeros.dtype == torch.int32
    assert tuple(maxes.shape) == (-(-shape[0] // 32), -(-shape[1] // 32))
    np.testing.assert_array_equal(np.asarray(ref_max), maxes.numpy())
    np.testing.assert_array_equal(np.asarray(ref_zero), zeros.numpy())
    r_max, r_zero = ref_ref.block_stats_ref(jnp.asarray(q))
    np.testing.assert_array_equal(np.asarray(r_max), maxes.numpy())
    np.testing.assert_array_equal(np.asarray(r_zero), zeros.numpy())


@pytest.mark.parametrize("tile", [8, 16])
def test_block_stats_other_tiles_on_cpu(tile):
    q = _codes((45, 19), 4, seed=tile)
    ref_max, ref_zero = ref_ref.block_stats_ref(jnp.asarray(q), tile=tile)
    maxes, zeros = port_bs.block_stats(torch.from_numpy(q), tile=tile)
    np.testing.assert_array_equal(np.asarray(ref_max), maxes.numpy())
    np.testing.assert_array_equal(np.asarray(ref_zero), zeros.numpy())


@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("shape", SHAPES[1:])
def test_bit_sparsity_stats_match_reference_and_profile(shape, bits):
    q = _codes(shape, bits, seed=7 * bits + shape[1])
    ref_word, ref_blk = ref_ops.bit_sparsity_stats(jnp.asarray(q), bits=bits)
    word, blk = port_ops.bit_sparsity_stats(torch.from_numpy(q), bits=bits)
    assert abs(word - float(ref_word)) <= STAT_TOL
    assert abs(blk - float(ref_blk)) <= STAT_TOL
    r_word, r_blk = ref_ref.bit_sparsity_stats_ref(jnp.asarray(q), bits)
    assert abs(word - float(r_word)) <= STAT_TOL
    assert abs(blk - float(r_blk)) <= STAT_TOL
    assert (word, blk) == port_ref.bit_sparsity_stats_ref(torch.from_numpy(q), bits)
    prof = profile_tensor(torch.from_numpy(q), bits, pre_quantized=True)
    assert abs(word - prof.word) <= STAT_TOL
    assert abs(blk - prof.bit_blockmax) <= STAT_TOL


@pytest.mark.parametrize("bits", [2, 4, 8])
def test_stats_of_per_tensor_codes_equal_weight_profile(bits):
    # what chip_smoke.py holds on the card for every site weight
    w = torch.from_numpy(np.random.default_rng(bits).normal(
        0, 1, (96, 70)).astype(np.float32))
    codes = quantize(w, bits=bits, per_channel=False).values
    word, blk = port_ops.bit_sparsity_stats(codes, bits=bits)
    prof = profile_tensor(w, bits)
    assert abs(word - prof.word) <= STAT_TOL
    assert abs(blk - prof.bit_blockmax) <= STAT_TOL


def test_block_stats_flattens_and_checks():
    q = _codes((2, 3, 40), 4, seed=1)
    maxes, zeros = port_bs.block_stats(torch.from_numpy(q))
    ref_max, ref_zero = port_ref.block_stats_ref(torch.from_numpy(q.reshape(6, 40)))
    assert torch.equal(maxes, ref_max) and torch.equal(zeros, ref_zero)
    with pytest.raises(TypeError, match="int8"):
        port_bs.block_stats(torch.zeros((4, 4), dtype=torch.int32))
    port_bs.reset_launches()
    port_bs.block_stats(torch.from_numpy(q))
    assert port_bs.LAUNCHES == {"block_stats": 0}


@pytest.mark.parametrize("tile", port_bs.TILES)
@pytest.mark.parametrize("codes", ["int8", "zeros"])
def test_every_tile_equals_reference(codes, tile):
    """Every tile that divides the reference's (256, 128) block, on the full
    int8 range (-128 included) and on an all-zero matrix, ragged against
    every tile above 1: the tile statistics EQUAL to the reference's Pallas
    kernel in interpret mode and to its plain version; the fused sums equal
    theirs; bit_sparsity_stats equal to the port's plain chain and within
    STAT_TOL of the reference's."""
    shape = (300, 257)
    if codes == "int8":
        q = _codes(shape, 8, seed=tile, zero_frac=0.1)
        q.flat[::11] = -128
    else:
        q = np.zeros(shape, np.int8)
    ref_max, ref_zero = ref_bs.block_stats(jnp.asarray(q), tile=tile, interpret=True)
    maxes, zeros, sums = port_bs.block_stats_with_sums(torch.from_numpy(q), tile=tile)
    assert tuple(maxes.shape) == (-(-shape[0] // tile), -(-shape[1] // tile))
    np.testing.assert_array_equal(np.asarray(ref_max), maxes.numpy())
    np.testing.assert_array_equal(np.asarray(ref_zero), zeros.numpy())
    r_max, r_zero = ref_ref.block_stats_ref(jnp.asarray(q), tile=tile)
    np.testing.assert_array_equal(np.asarray(r_max), maxes.numpy())
    np.testing.assert_array_equal(np.asarray(r_zero), zeros.numpy())
    assert sums.dtype == torch.int64
    assert sums.tolist() == [int(np.asarray(ref_max).sum()), int(np.asarray(ref_zero).sum())]
    if codes == "int8":
        assert int(maxes.max()) == 128          # |-128|, not saturated to 127
    bits = 8 if codes == "int8" else 4
    word, blk = port_ops.bit_sparsity_stats(torch.from_numpy(q), bits=bits, tile=tile)
    assert (word, blk) == port_ref.bit_sparsity_stats_ref(torch.from_numpy(q), bits, tile)
    ref_word, ref_blk = ref_ops.bit_sparsity_stats(jnp.asarray(q), bits=bits, tile=tile)
    assert abs(word - float(ref_word)) <= STAT_TOL
    assert abs(blk - float(ref_blk)) <= STAT_TOL


@pytest.mark.parametrize("tile", [3, 48, 256])
def test_tiles_the_reference_refuses_raise(tile):
    q = np.zeros((64, 64), np.int8)
    with pytest.raises(ValueError):
        ref_bs.block_stats(jnp.asarray(q), tile=tile, interpret=True)
    with pytest.raises(ValueError, match="tile"):
        port_bs.block_stats(torch.from_numpy(q), tile=tile)


def test_sums_give_the_same_floats_as_the_tile_statistics():
    """ops.bit_sparsity_stats reads the two fused sums; the floats are those
    that the tile statistics give, bit for bit, on ragged shapes."""
    for shape, tile in (((33, 70), 32), ((100, 129), 16), ((257, 40), 64)):
        q = torch.from_numpy(_codes(shape, 4, seed=shape[0]))
        maxes, zeros = port_bs.block_stats(q, tile=tile)
        for bits in (2, 4, 8):
            want = port_ref.sparsity_from_block_stats(maxes, zeros, *shape, bits, tile)
            assert port_ops.bit_sparsity_stats(q, bits=bits, tile=tile) == want
