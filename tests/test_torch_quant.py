"""Port vs reference: the symmetric quantizer.

Codes and scales must be EQUAL (tolerance 0): the same numpy inputs go
through ``repro.core.quantization`` (JAX, CPU) and
``repro_torch.core.quantization`` (PyTorch, CPU).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quantization as ref_q
from repro_torch.core import quantization as port_q

BITS = (2, 4, 8)


def _inputs(seed, shape):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    x *= np.float32(10.0) ** rng.integers(-3, 3, size=shape[-1:]).astype(np.float32)
    return x


def _assert_equal(ref, port):
    np.testing.assert_array_equal(np.asarray(ref.values), port.values.numpy())
    np.testing.assert_array_equal(np.asarray(ref.scale), port.scale.numpy())
    assert port.values.dtype == torch.int8
    assert port.scale.dtype == torch.float32
    assert ref.bits == port.bits
    assert tuple(ref.scale.shape) == tuple(port.scale.shape)


@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("shape", [(7, 5), (64, 192), (3, 4, 6), (33,)])
@pytest.mark.parametrize("mode", ["per-channel", "per-tensor", "per-row"])
def test_codes_and_scales_equal(bits, shape, mode):
    x = _inputs(hash((bits, shape)) % 1000, shape)
    if mode == "per-row":
        ref = ref_q.quantize_per_row(jnp.asarray(x), bits=bits)
        port = port_q.quantize_per_row(torch.from_numpy(x), bits=bits)
    else:
        pc = mode == "per-channel"
        ref = ref_q.quantize(jnp.asarray(x), bits=bits, per_channel=pc)
        port = port_q.quantize(torch.from_numpy(x), bits=bits, per_channel=pc)
    _assert_equal(ref, port)


@pytest.mark.parametrize("bits", BITS)
def test_ties_round_half_to_even(bits):
    v = port_q.vmax(bits)
    # column absmax == vmax -> scale exactly 1.0, so k + 0.5 are exact ties
    ties = np.arange(-v, v, dtype=np.float32) + np.float32(0.5)
    x = np.concatenate([ties, [np.float32(v), np.float32(-v)]])[:, None]
    x = np.repeat(x, 3, axis=1).astype(np.float32)
    ref = ref_q.quantize(jnp.asarray(x), bits=bits)
    port = port_q.quantize(torch.from_numpy(x), bits=bits)
    _assert_equal(ref, port)
    np.testing.assert_array_equal(port.scale.numpy(), np.ones((1, 3), np.float32))
    expect = np.clip(np.round(ties), -v, v).astype(np.int8)   # numpy: half to even
    np.testing.assert_array_equal(port.values.numpy()[:-2, 0], expect)


@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("mode", ["per-channel", "per-tensor", "per-row"])
def test_all_zero_rows_and_columns(bits, mode):
    x = _inputs(3, (6, 8))
    x[2, :] = 0.0
    x[:, 5] = 0.0
    if mode == "per-row":
        ref = ref_q.quantize_per_row(jnp.asarray(x), bits=bits)
        port = port_q.quantize_per_row(torch.from_numpy(x), bits=bits)
    else:
        pc = mode == "per-channel"
        ref = ref_q.quantize(jnp.asarray(x), bits=bits, per_channel=pc)
        port = port_q.quantize(torch.from_numpy(x), bits=bits, per_channel=pc)
    _assert_equal(ref, port)
    zero = np.zeros((4, 4), np.float32)
    _assert_equal(ref_q.quantize(jnp.asarray(zero), bits=bits),
                  port_q.quantize(torch.from_numpy(zero), bits=bits))


@pytest.mark.parametrize("bits", BITS)
def test_dequantize_and_helpers_equal(bits):
    x = _inputs(11, (9, 12))
    ref = ref_q.quantize_per_channel(jnp.asarray(x), bits=bits)
    port = port_q.quantize_per_channel(torch.from_numpy(x), bits=bits)
    np.testing.assert_array_equal(np.asarray(ref_q.dequantize(ref)),
                                  port_q.dequantize(port).numpy())
    _assert_equal(ref_q.quantize_per_tensor(jnp.asarray(x), bits=bits),
                  port_q.quantize_per_tensor(torch.from_numpy(x), bits=bits))
    assert port.shape == (9, 12)
    assert ref_q.vmax(bits) == port_q.vmax(bits)


def test_vmax_rejects_one_bit():
    with pytest.raises(ValueError):
        port_q.vmax(1)
