"""Port vs reference: the tubGEMM / tuGEMM slot-loop GEMMs.

The port's plain slot loops (what its wrappers run on CPU tensors) must be
EQUAL (tolerance 0) to the reference's Pallas kernels in interpret mode
(``ops.tub_matmul`` / ``ops.tu_matmul``), to ``kernels/ref.py`` and to the
integer GEMM; cycle reports equal too.  The CUDA kernels themselves are
held to the same plain versions on the card by ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_ref
from repro_torch import backends as port_backends
from repro_torch.kernels import ops as port_ops
from repro_torch.kernels import ref as port_ref
from repro_torch.kernels import unary_gemm as port_ug

BITS = (2, 3, 4, 8)
SHAPES = [(8, 16, 8), (5, 37, 11), (1, 130, 3), (33, 64, 70)]


def _operands(bits, shape, seed=0):
    m, k, n = shape
    rng = np.random.default_rng(seed + bits * 7 + m)
    v = 2 ** (bits - 1) - 1
    a = rng.integers(-v, v + 1, size=(m, k)).astype(np.int8)
    b = rng.integers(-128, 128, size=(k, n)).astype(np.int8)
    return a, b


@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("design", ["tub", "tu"])
def test_plain_equals_reference_kernel(design, bits, shape):
    a, b = _operands(bits, shape)
    ref_fn = ref_ops.tub_matmul if design == "tub" else ref_ops.tu_matmul
    port_fn = port_ops.tub_matmul if design == "tub" else port_ops.tu_matmul
    block = (8, 128, 128)   # small M tile keeps interpret mode quick
    ref_out, ref_cycles = ref_fn(jnp.asarray(a), jnp.asarray(b), bits=bits,
                                 block=block, interpret=True)
    out, cycles = port_fn(torch.from_numpy(a), torch.from_numpy(b), bits=bits)
    assert out.dtype == torch.int32 and tuple(out.shape) == (shape[0], shape[2])
    np.testing.assert_array_equal(np.asarray(ref_out), out.numpy())
    assert int(ref_cycles) == cycles
    np.testing.assert_array_equal(
        out.numpy(), a.astype(np.int32) @ b.astype(np.int32))


@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("shape", SHAPES[:3])
def test_plain_equals_reference_ref(bits, shape):
    a, b = _operands(bits, shape, seed=3)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    np.testing.assert_array_equal(
        np.asarray(ref_ref.tub_gemm_ref(jnp.asarray(a), jnp.asarray(b), bits=bits)),
        port_ref.tub_gemm_ref(ta, tb, bits=bits).numpy())
    np.testing.assert_array_equal(
        np.asarray(ref_ref.tu_gemm_ref(jnp.asarray(a), jnp.asarray(b), bits=bits)),
        port_ref.tu_gemm_ref(ta, tb, bits=bits).numpy())


# small stand-ins for the families' site edges: N = 64, N % 128 = 64 (as
# 32064), K = 1536 and K = 512 (deepseek-v3's w_uq and w_uk)
FAMILY_EDGES = [(4, 1536, 64), (4, 512, 192), (8, 96, 320)]


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("shape", FAMILY_EDGES)
def test_plain_equals_reference_kernel_at_family_edges(bits, shape):
    a, b = _operands(bits, shape, seed=5)
    ref_out, ref_cycles = ref_ops.tub_matmul(jnp.asarray(a), jnp.asarray(b),
                                             bits=bits, block=(8, 128, 128),
                                             interpret=True)
    out, cycles = port_ops.tub_matmul(torch.from_numpy(a), torch.from_numpy(b),
                                      bits=bits)
    np.testing.assert_array_equal(np.asarray(ref_out), out.numpy())
    assert int(ref_cycles) == cycles


@pytest.mark.parametrize("bits", BITS)
def test_cycle_formulas_and_mirrors(bits):
    from repro.kernels import unary_gemm as ref_ug
    for k in (1, 64, 4096):
        assert ref_ug.tub_wc_cycles(bits, k) == port_ug.tub_wc_cycles(bits, k)
        assert ref_ug.tu_wc_cycles(bits, k) == port_ug.tu_wc_cycles(bits, k)
    a, b = _operands(bits, (4, 24, 6), seed=9)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    want = a.astype(np.int32) @ b.astype(np.int32)
    for mirror in ("tubgemm_cuda", "tugemm_cuda"):
        be = port_backends.resolve(mirror, bits=bits)
        np.testing.assert_array_equal(be.execute(ta, tb).numpy(), want)
        out, cycles = be.stream(ta, tb)
        np.testing.assert_array_equal(out.numpy(), want)
        assert cycles == be.cycles(24)


def test_wrappers_reject_bad_operands():
    a = torch.zeros((2, 4), dtype=torch.int8)
    with pytest.raises(TypeError):
        port_ug.tub_gemm(a.to(torch.int32), torch.zeros((4, 2), dtype=torch.int8))
    with pytest.raises(ValueError, match="K mismatch"):
        port_ug.tu_gemm(a, torch.zeros((5, 2), dtype=torch.int8))
    with pytest.raises(ValueError):
        port_ug.tub_gemm(a, torch.zeros((4, 2), dtype=torch.int8), bits=9)
    with pytest.raises(ValueError):
        port_ug.tub_gemm(a[0], torch.zeros((4, 2), dtype=torch.int8))


def test_cpu_tensors_never_count_as_launches():
    port_ug.reset_launches()
    a, b = _operands(4, (3, 8, 5))
    port_ug.tub_gemm(torch.from_numpy(a), torch.from_numpy(b), bits=4)
    port_ug.tu_gemm(torch.from_numpy(a), torch.from_numpy(b), bits=4)
    assert port_ug.LAUNCHES == {"tub_gemm": 0, "tu_gemm": 0}


@pytest.mark.parametrize("m,k,n,resident,want", [
    (8, 4096, 14336, 5, 5), (8, 4096, 4096, 5, 20), (8, 4096, 1024, 5, 64),
    (8, 14336, 4096, 5, 20), (8, 4096, 128256, 5, 1), (512, 4096, 14336, 3, 1),
    (512, 4096, 1024, 3, 6), (13, 203, 77, 5, 4), (1, 1, 1, 5, 1),
    (8, 4096, 14336, 4, 4), (512, 4096, 1024, 4, 8), (32, 4096, 4096, 4, 16),
    # the attention families' sites: phi3.5-moe's lm_head (N = 32064, off the
    # 128-wide tile), deepseek-v3's w_kr (N = 64), w_dkv, w_uk (K = 512),
    # w_uq (K = 1536), wo (K = 16384), gemma-7b's w_down (K = 24576)
    (8, 4096, 32064, 5, 2), (8, 7168, 64, 5, 112), (8, 7168, 512, 5, 112),
    (8, 512, 16384, 5, 5), (8, 1536, 24576, 5, 3), (8, 16384, 7168, 5, 11),
    (8, 24576, 3072, 5, 27)])
def test_tu_split_plan(m, k, n, resident, want):
    """The slot loop's plan, one for tu and tub: the most K slices (at most
    the 64-wide K tiles) that keep the grid within one wave of the
    instance's resident blocks on 132 SMs (an H100 SXM holds 5/5/4/3 blocks
    of tu's 8/16/32/64-row instances)."""
    assert port_ug.plan_splits(m, k, n, sm_count=132, resident=resident) == want
    blocks = -(-m // port_ug.block_rows(m)) * -(-n // 128)
    assert want == 1 or blocks * want <= resident * 132


def _bytes(words: np.ndarray) -> np.ndarray:
    return words[..., None].view(np.uint8).reshape(*words.shape, 4)


def test_tu_pulse_word_arithmetic():
    """The identity the tu tensor-core kernel builds its pulses with (csrc/
    unary_gemm.cu:TuPulses), on every int8 code and every slot: per byte,
    |a| + 127 - i has bit 7 set exactly when i < |a|, with no carry or
    borrow between the bytes of a word, so replicating bit 7 over its byte
    and masking with sign(a) as an int8 gives the pulse [i < |a|] sign(a)."""
    codes = np.arange(-128, 128, dtype=np.int64)
    words = (codes.reshape(-1, 4) & 0xFF) @ (1 << (8 * np.arange(4)))
    words = words.astype(np.uint32)
    neg = np.where(_bytes(words) >= 128, 0xFF, 0).astype(np.uint8)
    neg = neg.reshape(-1).view(np.uint32)                    # 0xff where a < 0
    mag = ((words ^ neg) + (neg & 0x01010101) + 0x7F7F7F7F).astype(np.uint32)
    sgn = neg | np.uint32(0x01010101)
    mag_bytes = _bytes(mag).reshape(-1).astype(np.int64)
    np.testing.assert_array_equal(mag_bytes, np.abs(codes) + 127)
    for slot in range(128):
        s = (mag - np.uint32(slot * 0x01010101)).astype(np.uint32)
        gate = np.where(_bytes(s) >= 128, 0xFF, 0).astype(np.uint8)
        pulse = gate.reshape(-1).view(np.uint32) & sgn
        got = _bytes(pulse).reshape(-1).view(np.int8).astype(np.int64)
        np.testing.assert_array_equal(got, (slot < np.abs(codes)) * np.sign(codes))


def _vsub4(x, y):
    """__vsub4: per-byte subtraction with wrap-around."""
    d = (_bytes(x).astype(np.int64) - _bytes(y).astype(np.int64)) & 0xFF
    return d.astype(np.uint8).reshape(-1).view(np.uint32)


def _byte_signs(x):
    """prmt's sign-replicate mode: 0xff in each byte whose bit 7 is set."""
    return np.where(_bytes(x) >= 128, 0xFF, 0).astype(np.uint8).reshape(-1).view(np.uint32)


def test_tub_pulse_word_arithmetic():
    """The planes tub's tensor-core slot loop builds its pulses from (csrc/
    unary_gemm.cu:TubPulses), on every int8 code and every slot 0..63: per
    byte, |a| = (a ^ neg) + (neg & 1) without carry (-128 stays 128), and
    v1 + 127 - t has bit 7 set exactly when t < v1 with no borrow, so slot
    t >= 1's pulse word byte_signs(p0 - t) & p1 and slot 0's plane p2 are
    (2 [t < v1] + [t == 0] v0) sign(a), per byte."""
    codes = np.arange(-128, 128, dtype=np.int64)
    words = ((codes.reshape(-1, 4) & 0xFF) @ (1 << (8 * np.arange(4)))).astype(np.uint32)
    one = np.uint32(0x01010101)
    neg = _byte_signs(words)
    mag = ((words ^ neg) + (neg & one)).astype(np.uint32)
    np.testing.assert_array_equal(_bytes(mag).reshape(-1), np.abs(codes))
    v1 = (mag >> 1) & np.uint32(0x7F7F7F7F)
    p0 = (v1 + np.uint32(0x7F7F7F7F)).astype(np.uint32)
    p1 = _vsub4(np.uint32(0x02020202) ^ neg, neg)
    above = np.where(_bytes(v1) > 0, 0xFF, 0).astype(np.uint8).reshape(-1).view(np.uint32)
    gate = (above & np.uint32(0x02020202)) | (mag & one)      # __vcmpgtu4(v1, 0)
    p2 = _vsub4(gate ^ neg, neg)
    mag_v1, mag_v0 = np.abs(codes) // 2, np.abs(codes) % 2
    np.testing.assert_array_equal(_bytes(p0).reshape(-1).astype(np.int64), mag_v1 + 127)
    for slot in range(64):
        pulse = p2 if slot == 0 else _byte_signs(
            (p0 - np.uint32(slot) * one).astype(np.uint32)) & p1
        got = _bytes(pulse).reshape(-1).view(np.int8).astype(np.int64)
        want = (2 * (slot < mag_v1) + (slot == 0) * mag_v0) * np.sign(codes)
        np.testing.assert_array_equal(got, want, err_msg=f"slot {slot}")
