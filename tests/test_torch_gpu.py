"""The CUDA kernels against their plain versions, on a card.

Every test here carries the ``gpu`` marker and skips, with a reason, on a
host without a CUDA device (the decision is taken inside a fixture, at run
time).  On a machine with an NVIDIA GPU and ``nvcc``:

    PYTHONPATH=src python -m pytest -q tests/test_torch_gpu.py

Integer GEMMs must be EQUAL to the plain slot loop; the fused decode kernel
within 1e-4 of the gather oracle at fp32 (online softmax re-associates).
"""

import numpy as np
import pytest
import torch

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


@pytest.mark.parametrize("page,gqa", [(3, 1), (4, 2), (8, 4), (16, 4)])
def test_fused_decode_kernel_matches_oracle(cuda, page, gqa):
    rng = np.random.default_rng(page + gqa)
    batch, kvh, hd, max_blocks = 4, 2, 64, 5
    h = kvh * gqa
    num_pages = 1 + batch * max_blocks
    bt = torch.from_numpy(rng.permutation(np.arange(1, num_pages)).astype(np.int32)
                          .reshape(batch, max_blocks)).to(cuda)
    lens = torch.tensor([1, page, page + 1, max_blocks * page], dtype=torch.int32,
                        device=cuda)
    pk = torch.from_numpy(rng.standard_normal((num_pages, page, kvh, hd))
                          .astype(np.float32)).to(cuda)
    pv = torch.from_numpy(rng.standard_normal((num_pages, page, kvh, hd))
                          .astype(np.float32)).to(cuda)
    q = torch.from_numpy(rng.standard_normal((batch, 1, h, hd)).astype(np.float32)).to(cuda)
    oracle = paged_lib.paged_decode_attention(q, pk, pv, bt, lens, num_heads=h)
    dead = torch.ones(num_pages, dtype=torch.bool, device=cuda)
    for i in range(batch):
        dead[bt[i, : -(-int(lens[i]) // page)].long()] = False
    pk[dead] = float("nan")
    pv[dead] = float("nan")
    before = fused_lib.LAUNCHES["fused_paged_decode"]
    got = fused_lib.fused_paged_decode_attention(q, pk, pv, bt, lens, num_heads=h)
    assert fused_lib.LAUNCHES["fused_paged_decode"] == before + 1
    assert bool(torch.isfinite(got).all())
    assert float((got - oracle).abs().max()) <= 1e-4
    plain = fused_lib.fused_decode_plain(q, pk, pv, bt, lens, num_heads=h)
    assert float((got - plain).abs().max()) <= 1e-4


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
