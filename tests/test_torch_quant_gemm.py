"""Port vs reference: the packed integer GEMMs (``quant_gemm``,
``packed_gemm``), their unpack helpers, ``ops.quantized_matmul`` and the
``cfg.quant_kernel`` model path.

The port's plain versions (what its wrappers run on CPU tensors) must be
EQUAL (tolerance 0) to the reference's Pallas kernels in interpret mode and
to ``kernels/ref.py``, in int32 and in the fused float32 epilogue, for bits
{2, 4, 8} and ragged M, N, K (K not a multiple of the tile or of the codes
per word).  ``quantized_matmul`` is bit-equal in float32 on the same float
``x`` and ``Quantized`` weight.  A ``quant_kernel`` forward of the
llama3-8b smoke config (fp32) sends every dense site through
``quantized_matmul`` on both sides: the port's float32 output on each
site's recorded inputs is bit-equal to the reference's ``quantized_matmul``
on them, and within two ulps of the value the reference's compiled forward
produced there (XLA folds that epilogue into the scanned layer and rounds
it differently in the last bits; its integer accumulators are the same);
the logits of the two forwards agree within ``TOL`` (float32 attention,
norms and residuals sum in different orders).  The CUDA
kernels are held to the same plain versions on the card by
``chip_smoke.py`` and ``tests/test_torch_gpu.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.core import packing as ref_packing
from repro.core import quantization as ref_quant
from repro.kernels import ops as ref_ops
from repro.kernels import packed_gemm as ref_pg
from repro.kernels import quant_gemm as ref_qg
from repro.kernels import ref as ref_ref
from repro.models import model as ref_model
from repro_torch import backends as port_backends
from repro_torch import configs as port_configs
from repro_torch.core import packing as port_packing
from repro_torch.core import quantization as port_quant
from repro_torch.kernels import _build
from repro_torch.kernels import ops as port_ops
from repro_torch.kernels import packed_gemm as port_pg
from repro_torch.kernels import quant_gemm as port_qg
from repro_torch.kernels import ref as port_ref
from repro_torch.kernels import unary_gemm as port_ug
from repro_torch.models import model as port_model

TOL = 1e-4
BITS = (2, 4, 8)
# (M, K, N): decode rows, a ragged prefill-like M, K off the 128 tile
SHAPES = [(1, 16, 3), (8, 64, 20), (5, 136, 11), (33, 40, 130)]
BLOCK = (8, 128, 128)   # small M tile keeps interpret mode quick


def _eq(ref, port):
    np.testing.assert_array_equal(np.asarray(ref), port.numpy())


def _codes(rng, shape, bits):
    v = 1 << (bits - 1)
    return rng.integers(-v, v, shape).astype(np.int8)   # full signed range


@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("axis", [0, 1])
def test_pack_and_unpack_values_equal_reference(bits, axis):
    rng = np.random.default_rng(bits + axis)
    codes = _codes(rng, (8, 12), bits)
    ref_p = ref_ops.pack_values(jnp.asarray(codes), bits, axis=axis)
    p = port_ops.pack_values(torch.from_numpy(codes), bits, axis=axis)
    assert p.dtype == torch.int8
    _eq(ref_p, p)
    back = port_qg.unpack_values(p, bits, axis=axis)
    np.testing.assert_array_equal(back.numpy(), codes)
    _eq(ref_qg.unpack_values(ref_p, bits, axis=axis), back)
    _eq(ref_ref.unpack_values_ref(ref_p, bits, axis=axis),
        port_ref.unpack_values_ref(p, bits, axis=axis))
    if bits != 8:
        with pytest.raises(ValueError, match="divisible"):
            port_ops.pack_values(torch.from_numpy(codes[:3, :5]), bits, axis=axis)


@pytest.mark.parametrize("bits", BITS)
def test_unpack_words_equals_reference(bits):
    rng = np.random.default_rng(bits)
    codes = _codes(rng, (37, 6), bits)
    words = ref_packing.pack_codes(jnp.asarray(codes), bits)
    got = port_pg.unpack_words(torch.from_numpy(np.array(words)), bits)
    assert got.dtype == torch.int32
    _eq(ref_pg.unpack_words(words, bits), got)


def _words(b):
    """(..., 4) uint8 -> uint32 words, low byte first."""
    return np.ascontiguousarray(b, dtype=np.uint8).view(np.uint32)[..., 0]


def _word_bytes(w):
    return np.asarray(w, dtype=np.uint32)[..., None].view(np.uint8)


def _byte_perm(x, y, sel):
    """__byte_perm(x, y, sel) without the sign-replicate mode: result byte i
    is byte (sel >> 4 i) & 7 of the eight bytes y:x."""
    pool = np.concatenate([_word_bytes(x), _word_bytes(y)], axis=-1)
    return _words(pool[..., [(sel >> (4 * i)) & 7 for i in range(4)]])


def _transpose4x4(r0, r1, r2, r3):
    """csrc/mma_int8.cuh:transpose4x4, selector for selector."""
    t0, t1 = _byte_perm(r0, r1, 0x5140), _byte_perm(r2, r3, 0x5140)
    t2, t3 = _byte_perm(r0, r1, 0x7362), _byte_perm(r2, r3, 0x7362)
    return (_byte_perm(t0, t1, 0x5410), _byte_perm(t0, t1, 0x7632),
            _byte_perm(t2, t3, 0x5410), _byte_perm(t2, t3, 0x7632))


def _sext_bytes(v, bits, j):
    """csrc/int_gemm.cuh:sext_bytes: field j of each byte, sign-extended
    within the byte by f ^ h - h (__vsub4, per byte with wrap-around)."""
    mask = ((1 << bits) - 1) * 0x01010101
    half = (1 << (bits - 1)) * 0x01010101
    f = (np.asarray(v, dtype=np.uint32) >> np.uint32(bits * j)) & np.uint32(mask)
    d = (_word_bytes(f ^ np.uint32(half)).astype(np.int64)
         - _word_bytes(np.uint32(half)).astype(np.int64)) & 0xFF
    return _words(d.astype(np.uint8))


@pytest.mark.parametrize("bits", BITS)
def test_quant_gemm_fragment_unpack(bits):
    """The tensor-core quant_gemm unpacks each packed tile in shared memory
    into k-packed column words, the mma's A fragments (csrc/int_gemm.cuh:
    unpack_quads): word kw of column n holds k 4 kw .. 4 kw + 3 of that
    column.  Every byte value of the container, at 2/4/8 bits, through that
    arithmetic equals unpack_values_ref."""
    packed = np.arange(256, dtype=np.uint8).reshape(64, 4)   # 4 columns
    packed[1::2] = packed[1::2, ::-1]                        # vary columns per row
    rows = _words(packed)                                    # one word per row
    k = 64 * 8 // bits
    got = np.zeros((k, 4), dtype=np.int8)
    for kw in range(k // 4):
        r = kw * bits // 2                  # the kernel's packed row of kw
        if bits == 8:
            cols = _transpose4x4(*rows[r:r + 4])
        elif bits == 4:
            cols = _transpose4x4(_sext_bytes(rows[r], 4, 0), _sext_bytes(rows[r], 4, 1),
                                 _sext_bytes(rows[r + 1], 4, 0),
                                 _sext_bytes(rows[r + 1], 4, 1))
        else:
            cols = _transpose4x4(*(_sext_bytes(rows[r], 2, j) for j in range(4)))
        for n, word in enumerate(cols):
            got[4 * kw: 4 * kw + 4, n] = _word_bytes(word).view(np.int8)
    want = port_ref.unpack_values_ref(torch.from_numpy(packed.view(np.int8)), bits, axis=0)
    np.testing.assert_array_equal(got, want.numpy())


@pytest.mark.parametrize("bits", BITS)
def test_packed_gemm_fragment_unpack(bits):
    """The tensor-core packed_gemm unpacks each raw word of a word store in
    shared memory into k-packed column words, the mma's A fragments (csrc/
    int_gemm.cuh:unpack_word): word row r of column n holds k = r cpw ..
    r cpw + cpw - 1, and fragment word j of it k 4 (r cpw / 4 + j) .. + 3.
    Every byte value sits in every byte position of some word; at 2/4/8
    bits that arithmetic, selector for selector, equals unpack_codes."""
    base = np.arange(256, dtype=np.int64)
    raw = np.stack([(base + 67 * p) % 256 for p in range(4)], axis=-1)   # (256, 4) bytes
    for p in range(4):                      # every value in every position
        assert sorted(raw[:, p]) == list(range(256))
    words = _words(raw.astype(np.uint8)).reshape(64, 4)   # 64 word rows x 4 columns
    cpw = 32 // bits
    got = np.zeros((64 * cpw, 4), dtype=np.int8)
    for r in range(64):
        v = words[r]
        if bits == 8:
            frags = [v]
        elif bits == 4:
            lo, hi = _sext_bytes(v, 4, 0), _sext_bytes(v, 4, 1)
            frags = [_byte_perm(lo, hi, 0x5140), _byte_perm(lo, hi, 0x7362)]
        else:
            frags = list(_transpose4x4(*(_sext_bytes(v, 2, j) for j in range(4))))
        for j, f in enumerate(frags):
            kw = r * cpw // 4 + j
            got[4 * kw: 4 * kw + 4] = _word_bytes(f).view(np.int8).T
    want = port_packing.unpack_codes(torch.from_numpy(words.view(np.int32)), bits,
                                     64 * cpw, axis=0)
    np.testing.assert_array_equal(got, want.numpy())


@pytest.mark.parametrize("m,k,n,resident,want", [
    (8, 4096, 14336, 8, 9), (8, 4096, 14336, 6, 7), (512, 4096, 14336, 3, 1),
    (512, 4096, 1024, 4, 8), (8, 4096, 4096, 8, 33), (8, 14336, 4096, 8, 33),
    (1, 37, 3, 12, 1), (33, 100, 11, 5, 2)])
def test_packed_split_plan(m, k, n, resident, want):
    """packed_gemm's plan is the one the int8 tensor-core GEMMs share
    (_build.plan_splits), at its own instances' resident blocks: the most K
    slices (at most the 64-wide K tiles of the logical K) that keep the grid
    within one wave on 132 SMs."""
    assert port_pg.plan_splits is _build.plan_splits
    assert "plan_dp4a_splits" not in vars(port_pg)
    assert port_pg.plan_splits(m, k, n, sm_count=132, resident=resident) == want
    blocks = -(-m // _build.block_rows(m)) * -(-n // 128)
    assert want == 1 or blocks * want <= resident * 132


@pytest.mark.parametrize("m,k,n,resident,want", [
    (8, 4096, 14336, 8, 9), (16, 4096, 14336, 8, 9), (8, 4096, 4096, 8, 33),
    (8, 4096, 1024, 8, 64), (8, 14336, 4096, 8, 33), (512, 4096, 14336, 4, 1),
    (512, 4096, 1024, 4, 8), (1, 4093, 1027, 8, 64), (33, 203, 77, 6, 4),
    (1, 1, 1, 8, 1)])
def test_quant_split_plan(m, k, n, resident, want):
    """quant_gemm's plan, the one the tensor-core GEMMs share, at its own
    instances' resident blocks: the most K slices (at most the 64-wide K
    tiles) that keep the grid within one wave on 132 SMs; the ticket
    counters count the same tiles."""
    assert port_qg.plan_splits is port_ug.plan_splits
    assert port_qg.plan_splits(m, k, n, sm_count=132, resident=resident) == want
    blocks = -(-m // port_qg.block_rows(m)) * -(-n // 128)
    assert want == 1 or blocks * want <= resident * 132


@pytest.mark.parametrize("fuse", [False, True])
@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("shape", SHAPES)
def test_quant_gemm_plain_equals_reference_kernel(shape, bits, fuse):
    m, k, n = shape
    rng = np.random.default_rng(m * 31 + bits)
    x = _codes(rng, (m, k), 8)
    w = _codes(rng, (k, n), bits)
    scales = rng.uniform(1e-4, 1e-2, (1, n)).astype(np.float32)
    ref_packed = ref_ops.pack_values(jnp.asarray(w), bits)
    packed = torch.from_numpy(np.array(ref_packed))
    ref_out = ref_qg.quant_gemm(jnp.asarray(x), ref_packed, jnp.asarray(scales),
                                bits=bits, block=BLOCK, fuse_dequant=fuse,
                                interpret=True)
    out = port_qg.quant_gemm(torch.from_numpy(x), packed, torch.from_numpy(scales),
                             bits=bits, fuse_dequant=fuse)
    assert out.dtype == (torch.float32 if fuse else torch.int32)
    assert tuple(out.shape) == (m, n)
    _eq(ref_out, out)
    _eq(ref_ref.quant_gemm_ref(jnp.asarray(x), ref_packed, jnp.asarray(scales),
                               bits=bits, fuse_dequant=fuse), out)
    acc = x.astype(np.int64) @ w.astype(np.int64)
    if not fuse:
        np.testing.assert_array_equal(out.numpy(), acc)
        _eq(ref_ops.int_matmul(jnp.asarray(x), ref_packed, bits=bits, block=BLOCK),
            port_ops.int_matmul(torch.from_numpy(x), packed, bits=bits))


@pytest.mark.parametrize("fuse", [False, True])
@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("shape", [(1, 37, 3), (8, 64, 20), (33, 100, 11)])
def test_packed_gemm_plain_equals_reference_kernel(shape, bits, fuse):
    m, k, n = shape        # K = 37, 100: not a multiple of the codes per word
    rng = np.random.default_rng(m + k + bits)
    x = _codes(rng, (m, k), 8)
    codes = _codes(rng, (k, n), bits)
    scales = rng.uniform(1e-4, 1e-2, (1, n)).astype(np.float32)
    ref_words = ref_packing.pack_codes(jnp.asarray(codes), bits)
    words = port_packing.pack_codes(torch.from_numpy(codes), bits)
    _eq(ref_words, words)
    ref_out = ref_pg.packed_gemm(jnp.asarray(x), ref_words, jnp.asarray(scales),
                                 bits=bits, k=k, block=(8, 128, 128),
                                 fuse_dequant=fuse, interpret=True)
    out = port_pg.packed_gemm(torch.from_numpy(x), words, torch.from_numpy(scales),
                              bits=bits, k=k, fuse_dequant=fuse)
    _eq(ref_out, out)
    _eq(ref_out, port_ref.packed_gemm_ref(torch.from_numpy(x), words,
                                          torch.from_numpy(scales), bits=bits,
                                          k=k, fuse_dequant=fuse))


@pytest.mark.parametrize("bits", BITS)
def test_packed_matmul_equals_reference(bits):
    rng = np.random.default_rng(bits)
    w = rng.normal(0, 1, (20, 6)).astype(np.float32)
    x = _codes(rng, (3, 20), 8)
    ref_store = ref_packing.pack_quantized(jnp.asarray(w), bits=bits)
    store = port_packing.pack_quantized(torch.from_numpy(w), bits=bits)
    for fuse in (True, False):
        _eq(ref_pg.packed_matmul(jnp.asarray(x), ref_store, block=(8, 8, 16),
                                 fuse_dequant=fuse, interpret=True),
            port_pg.packed_matmul(torch.from_numpy(x), store, fuse_dequant=fuse))


def test_wrappers_reject_bad_operands():
    x = torch.zeros((2, 8), dtype=torch.int8)
    store = port_packing.pack_quantized(torch.ones((8, 4)), bits=4)
    with pytest.raises(TypeError, match="int8"):
        port_qg.quant_gemm(x.float(), torch.zeros((4, 4), dtype=torch.int8), bits=4)
    with pytest.raises(ValueError, match="K mismatch"):
        port_qg.quant_gemm(x, torch.zeros((3, 4), dtype=torch.int8), bits=4)
    with pytest.raises(ValueError, match="bits"):
        port_qg.quant_gemm(x, torch.zeros((8, 4), dtype=torch.int8), bits=3)
    with pytest.raises(ValueError, match="scales"):
        port_qg.quant_gemm(x, torch.zeros((4, 4), dtype=torch.int8),
                           torch.ones((1, 5)), bits=4, fuse_dequant=True)
    with pytest.raises(TypeError, match="int8 activations"):
        port_pg.packed_gemm(x.float(), store.packed, bits=4, k=8)
    with pytest.raises(TypeError, match="int32 word store"):
        port_pg.packed_gemm(x, store.packed.to(torch.int64), bits=4, k=8)
    with pytest.raises(ValueError, match="K mismatch"):
        port_pg.packed_gemm(x, store.packed, bits=4, k=9)
    wide = port_packing.pack_quantized(torch.ones((40, 3)), bits=4)   # 5 words
    with pytest.raises(ValueError, match="word-count"):
        port_pg.packed_gemm(torch.zeros((2, 40), dtype=torch.int8), wide.packed,
                            bits=2, k=40)                          # needs 3
    with pytest.raises(TypeError, match="PackedQuantized"):
        port_pg.packed_matmul(x, torch.ones((8, 4)))
    import dataclasses
    with pytest.raises(ValueError, match="flat"):
        port_pg.packed_matmul(x, dataclasses.replace(store, grid_x=2))
    stacked = port_packing.pack_quantized(torch.ones((2, 8, 4)), bits=4, k=8, n_out=4)
    with pytest.raises(ValueError, match="unstacked"):
        port_pg.packed_matmul(x, stacked)


def test_cpu_tensors_never_count_as_launches():
    port_qg.reset_launches()
    port_pg.reset_launches()
    x = torch.ones((2, 8), dtype=torch.int8)
    port_qg.quant_gemm(x, torch.ones((4, 3), dtype=torch.int8), bits=4)
    store = port_packing.pack_quantized(torch.ones((8, 3)), bits=4)
    port_pg.packed_matmul(x, store)
    assert port_qg.LAUNCHES == {"quant_gemm": 0}
    assert port_pg.LAUNCHES == {"packed_gemm": 0}


@pytest.mark.parametrize("bits,act_bits", [(2, 4), (4, 8), (8, 8)])
@pytest.mark.parametrize("shape", [(1, 16, 8), (2, 3, 40, 12)])
def test_quantized_matmul_bit_equal(bits, act_bits, shape):
    rng = np.random.default_rng(bits + len(shape))
    x = rng.normal(0, 1, shape[:-1]).astype(np.float32)
    w = rng.normal(0, 1, shape[-2:]).astype(np.float32)
    ref_wq = ref_quant.quantize(jnp.asarray(w), bits=bits)
    wq = port_quant.quantize(torch.from_numpy(w), bits=bits)
    _eq(ref_wq.values, wq.values)
    _eq(ref_wq.scale, wq.scale)
    ref_out = ref_ops.quantized_matmul(jnp.asarray(x), ref_wq, act_bits=act_bits,
                                       block=BLOCK)
    out = port_ops.quantized_matmul(torch.from_numpy(x), wq, act_bits=act_bits)
    assert out.dtype == torch.float32 and tuple(out.shape) == ref_out.shape
    _eq(ref_out, out)


# -- the cfg.quant_kernel model path ------------------------------------------

@pytest.fixture(scope="module")
def setup():
    ref_cfg = ref_configs.get_smoke_config("llama3-8b").replace(
        compute_dtype="float32")
    port_cfg = port_configs.get_smoke_config("llama3-8b").replace(
        compute_dtype="float32")
    ref_params = ref_model.init_params(ref_cfg, jax.random.PRNGKey(0))
    port_params = port_model.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, ref_params), device="cpu")
    tokens = np.random.default_rng(0).integers(
        0, ref_cfg.vocab_size, (2, 9)).astype(np.int32)
    return ref_cfg, port_cfg, ref_params, port_params, tokens


@pytest.mark.parametrize("bits", [4, 8])
def test_quant_kernel_forward_sites_bit_equal(setup, monkeypatch, bits):
    ref_cfg, port_cfg, ref_params, port_params, tokens = setup
    ref_cfg = ref_cfg.replace(quant_bits=bits, quant_kernel=True)
    port_cfg = port_cfg.replace(quant_bits=bits, quant_kernel=True)
    ref_sites, port_sites = [], []
    ref_fn, port_fn = ref_ops.quantized_matmul, port_ops.quantized_matmul

    def ref_recording(x, w_q, **kw):
        # the layers run under lax.scan: record the traced values as the
        # compiled forward produces them
        out = ref_fn(x, w_q, **kw)
        jax.debug.callback(
            lambda *a: ref_sites.append((*map(np.asarray, a[:3]), kw,
                                         np.asarray(a[3]))),
            x, w_q.values, w_q.scale, out, ordered=True)
        return out

    def port_recording(x, w_q, **kw):
        out = port_fn(x, w_q, **kw)
        port_sites.append((tuple(x.shape), tuple(w_q.values.shape), kw))
        return out

    monkeypatch.setattr(ref_ops, "quantized_matmul", ref_recording)
    monkeypatch.setattr(port_ops, "quantized_matmul", port_recording)
    ref_logits, _ = ref_model.forward(ref_params, ref_cfg, jnp.asarray(tokens))
    logits, _ = port_model.forward(port_params, port_cfg, torch.from_numpy(tokens))
    # wq wk wv + w_up w_gate w_down per layer (wo and lm_head stay float
    # outside a backend scope, as in the reference)
    assert len(ref_sites) == len(port_sites) == 6 * ref_cfg.num_layers
    assert [(s[0].shape, s[1].shape, s[3]) for s in ref_sites] == port_sites
    assert all(s[3] == {"act_bits": min(2 * bits, 8)} for s in ref_sites)
    for x, values, scale, kw, in_model in ref_sites:
        wq = port_quant.Quantized(values=torch.from_numpy(values.copy()),
                                  scale=torch.from_numpy(scale.copy()), bits=bits)
        got = port_fn(torch.from_numpy(x.copy()), wq, **kw).numpy()
        want = ref_fn(jnp.asarray(x), ref_quant.Quantized(
            jnp.asarray(values), jnp.asarray(scale), bits), **kw)
        np.testing.assert_array_equal(got, np.asarray(want))
        # compiled inside the scanned forward, XLA rounds the reference's
        # dequant epilogue differently from its own standalone function, by
        # up to two ulps (the integer accumulators agree)
        np.testing.assert_array_max_ulp(got, in_model, maxulp=2)
    assert float(np.abs(np.asarray(ref_logits) - logits.numpy()).max()) <= TOL


def test_quant_kernel_ugemm_and_packed_refusals(setup):
    # quant_backend="ugemm": activations per tensor at quant_bits, uGEMM's
    # multiplier on the codes, the two dequant multiplies in turn — logits
    # within the quant path's tolerance of the reference's
    ref_cfg, port_cfg, ref_params, port_params, tokens = setup
    kw = dict(quant_bits=4, quant_kernel=True, quant_backend="ugemm")
    ref_logits, _ = ref_model.forward(ref_params, ref_cfg.replace(**kw),
                                      jnp.asarray(tokens))
    logits, _ = port_model.forward(port_params, port_cfg.replace(**kw),
                                   torch.from_numpy(tokens))
    assert float(np.abs(np.asarray(ref_logits) - logits.numpy()).max()) <= TOL
    with pytest.raises(TypeError, match="already-packed"):
        port_model.forward(
            port_backends.pack_weights(port_cfg, port_params, bits=4),
            port_cfg.replace(**kw), torch.from_numpy(tokens))
