"""Port vs reference: the bit-packed weight stores (``core/packing.py``), the
store report, and ``dense``'s packed-leaf branches.

Everything here is integer or exactly rounded, so the contract is EQUALITY
(tolerance 0): the int32 words over the full signed range (``-2^(bits-1)``
included) and lengths that do not divide the codes per word, the unpacked
codes, the scales, ``quantized()`` / ``dequantize()``, the byte counts, the
``PackedStoreReport`` of a whole tree, and ``dense`` over a packed leaf
under a backend scope.  The one exception: ``dense``'s float path over a
packed leaf is a float32 matmul, held to 1e-5 (the two libraries sum K in
different orders; its dequantized weight is equal).  Inputs come from numpy
seeds.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import backends as ref_backends
from repro import configs as ref_configs
from repro.core import accounting as ref_accounting
from repro.core import packing as ref_packing
from repro.models import common as ref_common
from repro_torch import backends as port_backends
from repro_torch import configs as port_configs
from repro_torch.core import accounting as port_accounting
from repro_torch.core import packing as port_packing
from repro_torch.core.quantization import quantize, quantize_per_row
from repro_torch.models import common as port_common

BITS = (2, 4, 8)


def _eq(ref, port):
    np.testing.assert_array_equal(np.asarray(ref), port.numpy())


@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("k,n", [(1, 1), (5, 3), (16, 4), (37, 9), (64, 2)])
def test_words_equal_reference_over_full_signed_range(bits, k, n):
    rng = np.random.default_rng(bits * 100 + k)
    lo, hi = -(1 << (bits - 1)), (1 << (bits - 1)) - 1
    codes = rng.integers(lo, hi + 1, (k, n)).astype(np.int8)
    codes[0, 0] = lo                                # the extreme code, always
    ref_words = ref_packing.pack_codes(jnp.asarray(codes), bits)
    words = port_packing.pack_codes(torch.from_numpy(codes), bits)
    assert words.dtype == torch.int32
    assert tuple(words.shape) == (-(-k // port_packing.codes_per_word(bits)), n)
    _eq(ref_words, words)
    back = port_packing.unpack_codes(words, bits, k)
    assert back.dtype == torch.int8
    np.testing.assert_array_equal(back.numpy(), codes)
    _eq(ref_packing.unpack_codes(ref_words, bits, k), back)


@pytest.mark.parametrize("bits", BITS)
def test_pack_along_other_axes(bits):
    rng = np.random.default_rng(bits)
    v = 1 << (bits - 1)
    codes = rng.integers(-v, v, (3, 7, 5)).astype(np.int8)
    for axis in (0, 1, -1):
        ref_words = ref_packing.pack_codes(jnp.asarray(codes), bits, axis=axis)
        words = port_packing.pack_codes(torch.from_numpy(codes), bits, axis=axis)
        _eq(ref_words, words)
        _eq(ref_packing.unpack_codes(ref_words, bits, codes.shape[axis], axis=axis),
            port_packing.unpack_codes(words, bits, codes.shape[axis], axis=axis))


@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("k,n", [(2, 1), (13, 6), (33, 8)])
def test_pack_quantized_equals_reference(bits, k, n):
    rng = np.random.default_rng(bits + 7 * k)
    w = rng.normal(0, 1, (k, n)).astype(np.float32)
    ref = ref_packing.pack_quantized(jnp.asarray(w), bits=bits)
    store = port_packing.pack_quantized(torch.from_numpy(w), bits=bits)
    _eq(ref.packed, store.packed)
    _eq(ref.scale, store.scale)
    _eq(ref.codes(), store.codes())
    _eq(ref.quantized().values, store.quantized().values)
    _eq(ref.quantized().scale, store.quantized().scale)
    _eq(ref.dequantize(), store.dequantize())
    assert (store.bits, store.k, store.tail, store.grid_x) == \
        (ref.bits, ref.k, ref.tail, ref.grid_x)
    assert (store.shape, store.ndim, store.size, store.n_out) == \
        (ref.shape, ref.ndim, ref.size, ref.n_out)
    assert store.stored_bytes == ref.stored_bytes
    assert store.float32_bytes == ref.float32_bytes
    # the store holds exactly what quantize() produces
    q = quantize(torch.from_numpy(w), bits=bits)
    assert torch.equal(store.codes(), q.values)
    assert torch.equal(store.dequantize(), q.dequantize())


def test_stacked_leaf_packs_per_slice():
    rng = np.random.default_rng(1)
    w = rng.normal(0, 1, (3, 10, 4)).astype(np.float32)
    ref = ref_packing.pack_quantized(jnp.asarray(w), bits=4, k=10, n_out=4)
    store = port_packing.pack_quantized(torch.from_numpy(w), bits=4, k=10, n_out=4)
    _eq(ref.packed, store.packed)
    _eq(ref.scale, store.scale)
    _eq(ref.codes(), store.codes())
    assert store.shape == ref.shape == (3, 10, 4)
    for i in range(3):
        q = quantize(torch.from_numpy(w[i]), bits=4)
        assert torch.equal(store.codes()[i], q.values)
    with pytest.raises(ValueError, match="stacked"):
        store.reshape(30, 4)


def test_multi_axis_k_and_tail():
    rng = np.random.default_rng(2)
    w = rng.normal(0, 1, (4, 8, 12)).astype(np.float32)
    ref = ref_packing.pack_quantized(jnp.asarray(w), bits=4, k=32, n_out=12)
    store = port_packing.pack_quantized(torch.from_numpy(w), bits=4, k=32, n_out=12)
    assert store.shape == ref.shape == (4, 8, 12)
    assert store.k_shape == ref.k_shape == (4, 8)
    flat, ref_flat = store.reshape(32, 12), ref.reshape(32, 12)
    assert flat.shape == ref_flat.shape == (32, 12)
    _eq(ref_flat.codes(), flat.codes())
    _eq(ref.dequantize(), store.dequantize())
    with pytest.raises(ValueError, match="without mixing"):
        store.reshape(12, 32)


@pytest.mark.parametrize("bits", BITS)
def test_from_quantized_per_row_scales(bits):
    rng = np.random.default_rng(3)
    w = rng.normal(0, 1, (11, 6)).astype(np.float32)
    q = quantize_per_row(torch.from_numpy(w), bits=bits)
    store = port_packing.from_quantized(q)
    assert tuple(store.scale.shape) == (11, 1)
    assert torch.equal(store.dequantize(), q.dequantize())


def test_bad_inputs_raise():
    with pytest.raises(ValueError, match="packable widths"):
        port_packing.codes_per_word(3)
    w = torch.from_numpy(np.random.default_rng(4).normal(0, 1, (6, 4)).astype(np.float32))
    with pytest.raises(ValueError, match="not a stack"):
        port_packing.pack_quantized(w, bits=4, k=5, n_out=4)
    store = port_packing.pack_quantized(w, bits=4)
    with pytest.raises(ValueError, match="second width"):
        port_packing.pack_quantized(store, bits=2)
    # grid stores (one packed band per K band) are no longer refused: both
    # entry points equal the reference's grid store word for word
    from repro.core.quantization import quantize as ref_quantize
    jw = jnp.asarray(w.numpy())
    _eq(ref_packing.pack_quantized(jw, bits=4, grid_x=2).packed,
        port_packing.pack_quantized(w, bits=4, grid_x=2).packed)
    _eq(ref_packing.from_quantized(ref_quantize(jw, bits=4), grid_x=2).packed,
        port_packing.from_quantized(quantize(w, bits=4), grid_x=2).packed)
    with pytest.raises(ValueError, match="grid_x"):
        port_packing.pack_quantized(w, bits=4, grid_x=0)
    with pytest.raises(ValueError, match=">=2-D"):
        port_packing.pack_quantized(w[0], bits=4)
    with pytest.raises(ValueError, match="tail"):
        port_packing.from_quantized(quantize(w, bits=4), tail=(3,))


def _trees():
    """The same small parameter tree in both packages, two leaves packed."""
    rng = np.random.default_rng(5)
    arrays = {"embed": rng.normal(0, 1, (10, 8)),
              "norm": np.ones(8),
              "layers": {"wq": rng.normal(0, 1, (8, 6)),
                         "w_up": rng.normal(0, 1, (8, 12)),
                         "wo": rng.normal(0, 1, (2, 3, 8))}}
    arrays = jax.tree_util.tree_map(lambda a: a.astype(np.float32), arrays)
    ref = jax.tree_util.tree_map(jnp.asarray, arrays)
    port = jax.tree_util.tree_map(torch.from_numpy, arrays)
    ref["layers"]["wq"] = ref_packing.pack_quantized(ref["layers"]["wq"], bits=4)
    ref["layers"]["wo"] = ref_packing.pack_quantized(ref["layers"]["wo"], bits=2,
                                                     k=6, n_out=8)
    port["layers"]["wq"] = port_packing.pack_quantized(port["layers"]["wq"], bits=4)
    port["layers"]["wo"] = port_packing.pack_quantized(port["layers"]["wo"], bits=2,
                                                       k=6, n_out=8)
    return ref, port


def test_store_report_and_widths_equal_reference():
    ref, port = _trees()
    ref_rep = ref_accounting.packed_store_report(ref)
    rep = port_accounting.packed_store_report(port)
    assert dataclasses.asdict(rep) == dataclasses.asdict(ref_rep)
    assert rep.reduction == ref_rep.reduction
    assert rep.packed_reduction == ref_rep.packed_reduction
    assert (rep.packed_sites, rep.total_sites) == (2, 4)
    assert port_packing.packed_widths(port) == ref_packing.packed_widths(ref) \
        == {"layers/wo": 2, "layers/wq": 4}


@pytest.mark.parametrize("spec", ["tubgemm", "bgemm", "tubgemm_cuda"])
@pytest.mark.parametrize("bits", BITS)
def test_backend_dense_over_packed_leaf(spec, bits):
    rng = np.random.default_rng(bits)
    w = rng.normal(0, 1, (24, 12)).astype(np.float32)
    x = rng.normal(0, 1, (3, 24)).astype(np.float32)
    tw, tx = torch.from_numpy(w), torch.from_numpy(x)
    store = port_packing.pack_quantized(tw, bits=bits)
    with port_backends.use_backend(spec, bits=bits):
        want = port_common.dense(tw, tx, name="w")
    with port_backends.use_backend(spec, bits=bits) as execution:
        got = port_common.dense(store, tx, name="w")
    assert torch.equal(got, want)
    assert (execution.calls[0].k, execution.calls[0].n_out) == (24, 12)
    ref_store = ref_packing.pack_quantized(jnp.asarray(w), bits=bits)
    with ref_backends.use_backend(spec.removesuffix("_cuda"), bits=bits):
        ref_out = ref_common.dense(ref_store, jnp.asarray(x), name="w")
    _eq(ref_out, got)


def test_packed_leaf_width_mismatch_and_float_path():
    rng = np.random.default_rng(6)
    w = torch.from_numpy(rng.normal(0, 1, (16, 8)).astype(np.float32))
    x = torch.from_numpy(rng.normal(0, 1, (2, 16)).astype(np.float32))
    store = port_packing.pack_quantized(w, bits=8)
    with port_backends.use_backend("tubgemm", bits=4):
        with pytest.raises(ValueError, match="packed-width-mismatch"):
            port_common.dense(store, x, name="w")
    # the float path dequantizes the stored codes, as the reference does
    got = port_common.dense(store, x, name="w")
    assert torch.equal(got, x @ store.dequantize())
    ref_store = ref_packing.pack_quantized(jnp.asarray(w.numpy()), bits=8)
    _eq(ref_store.dequantize(), store.dequantize())
    # a float32 matmul: the two libraries sum K in different orders
    np.testing.assert_allclose(
        np.asarray(ref_common._plain_matmul(jnp.asarray(x.numpy()), ref_store)),
        got.numpy(), rtol=0, atol=1e-5)


def test_quant_kernel_path_refuses_packed_leaf():
    cfg = port_configs.get_smoke_config("llama3-8b").replace(
        quant_bits=4, quant_kernel=True)
    rng = np.random.default_rng(7)
    store = port_packing.pack_quantized(
        torch.from_numpy(rng.normal(0, 1, (16, 8)).astype(np.float32)), bits=4)
    x = torch.from_numpy(rng.normal(0, 1, (2, 16)).astype(np.float32))
    with pytest.raises(TypeError, match="second time"):
        port_common.dense(store, x, cfg, name="w")
    assert ref_configs.get_smoke_config("llama3-8b").quant_kernel is False
