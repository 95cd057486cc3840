"""Port vs reference: ``core/unary.py``, the unary stream encodings.

Every function is integer or dyadic arithmetic, so each is held to the
reference **bit for bit** (values and dtypes' widths) at 2, 4 and 8 bits on
the same numpy-seeded codes, including the full signed range.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import unary as ref_unary
from repro_torch.core import unary as port_unary

BITS = (2, 4, 8)


def _codes(bits, shape=(5, 7), seed=0):
    v = 2 ** (bits - 1) - 1
    return np.random.default_rng(seed).integers(-v, v + 1, shape).astype(np.int8)


def _eq(port, ref):
    np.testing.assert_array_equal(port.numpy(), np.asarray(ref))


@pytest.mark.parametrize("bits", BITS)
def test_stream_lengths(bits):
    for name in ("temporal_stream_len", "tub_stream_len", "rate_stream_len"):
        assert getattr(port_unary, name)(bits) == getattr(ref_unary, name)(bits)


@pytest.mark.parametrize("bits", BITS)
def test_temporal_encode_decode(bits):
    q = _codes(bits)
    stream, sign = port_unary.encode_temporal(torch.from_numpy(q), bits)
    r_stream, r_sign = ref_unary.encode_temporal(jnp.asarray(q), bits)
    _eq(stream, r_stream)
    _eq(sign, r_sign)
    _eq(port_unary.decode_temporal(stream, sign),
        ref_unary.decode_temporal(r_stream, r_sign))
    np.testing.assert_array_equal(
        port_unary.decode_temporal(stream, sign).numpy(), q.astype(np.int32))


@pytest.mark.parametrize("bits", BITS)
def test_tub_encode_decode(bits):
    q = _codes(bits, seed=1)
    got = port_unary.encode_tub(torch.from_numpy(q), bits)
    want = ref_unary.encode_tub(jnp.asarray(q), bits)
    for g, w in zip(got, want):
        _eq(g, w)
    _eq(port_unary.decode_tub(*got), ref_unary.decode_tub(*want))
    np.testing.assert_array_equal(port_unary.decode_tub(*got).numpy(), q)


@pytest.mark.parametrize("n", [1, 2, 16, 256, 1000])
def test_van_der_corput(n):
    got = port_unary.van_der_corput(n)
    assert got.dtype == torch.float32
    _eq(got, ref_unary.van_der_corput(n))


@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("phase,reflect", [(0, False), (3, False), (0, True),
                                           (5, True)])
def test_rate_encode_decode(bits, phase, reflect):
    q = _codes(bits, seed=2)
    stream, sign = port_unary.encode_rate(torch.from_numpy(q), bits,
                                          phase=phase, reflect=reflect)
    r_stream, r_sign = ref_unary.encode_rate(jnp.asarray(q), bits,
                                             phase=phase, reflect=reflect)
    _eq(stream, r_stream)
    _eq(sign, r_sign)
    _eq(port_unary.decode_rate(stream, sign, bits),
        ref_unary.decode_rate(r_stream, r_sign, bits))
    _eq(port_unary.ones_count(stream), ref_unary.ones_count(r_stream))


@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("scheme", ["temporal", "tub"])
def test_bit_sparsity_of_stream(bits, scheme):
    for seed, shape in ((3, (5, 7)), (4, (64, 33))):
        q = _codes(bits, shape, seed)
        got = port_unary.bit_sparsity_of_stream(torch.from_numpy(q), bits,
                                                scheme)
        want = ref_unary.bit_sparsity_of_stream(jnp.asarray(q), bits, scheme)
        assert got.dtype == torch.float32
        assert float(got) == float(want)
    with pytest.raises(ValueError):
        port_unary.bit_sparsity_of_stream(torch.zeros(2), 4, "rate")


def test_full_int8_range_encodes_like_the_reference():
    q = np.arange(-127, 128, dtype=np.int8).reshape(15, 17)
    for fn in ("encode_temporal", "encode_tub"):
        for g, w in zip(getattr(port_unary, fn)(torch.from_numpy(q), 8),
                        getattr(ref_unary, fn)(jnp.asarray(q), 8)):
            _eq(g, w)
