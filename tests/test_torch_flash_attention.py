"""Port vs reference: flash attention (plain versions on the CPU), the
no-cache attention dispatch and blockwise attention.

The reference's Pallas kernels run in interpret mode; the same numpy inputs
go through both.  Tolerances are the reference's own
(``tests/test_flash_attention.py``): values 2e-5, gradients 2e-4 (float32;
online softmax and the tile walk re-associate sums), bfloat16 3e-2.
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attention as ref_flash
from repro.models import attention as ref_attn
from repro_torch.kernels import flash_attention as port_flash
from repro_torch.models import attention as port_attn

VAL_TOL = 2e-5
GRAD_TOL = 2e-4
BF16_TOL = 3e-2


def _arrays(rng, *shapes):
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _port(x, dtype=torch.float32, grad=False):
    return torch.from_numpy(x).to(dtype).requires_grad_(grad)


def _ref(x, dtype=jnp.float32):
    return jnp.asarray(x, dtype)


# (B, Sq, Skv, H, D, reference block)
CASES = [
    (1, 128, 128, 2, 32, 64),     # exact multiples of the block
    (2, 20, 20, 2, 16, 16),       # ragged, one padded tile
    (1, 40, 40, 2, 16, 16),       # ragged, several tiles
    (2, 77, 77, 1, 64, 64),       # ragged past the port's 64-row tile
]
CROSS = [(1, 10, 26, 2, 16, 16), (1, 40, 20, 2, 16, 16), (2, 70, 130, 1, 32, 64)]
# head dims 96 (phi3-mini-3.8b) and 256 (gemma-7b), which the kernels take
# since the D = 256 instances split their work (the plain versions walk the
# same 64-wide tiles): whole tiles, ragged, Sq < Skv and Sq > Skv
HEAD_DIM_CASES = [(1, 64, 64, 2, 96, 64), (1, 64, 64, 1, 256, 64),
                  (2, 20, 20, 1, 256, 16), (1, 20, 40, 2, 96, 16),
                  (1, 40, 20, 1, 256, 16), (1, 77, 77, 1, 96, 64)]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("case", CASES + CROSS + HEAD_DIM_CASES, ids=str)
def test_values_and_grads_match_reference(case, causal):
    b, sq, skv, h, d, blk = case
    rng = np.random.default_rng(sq * 31 + skv + d)
    q, k, v = _arrays(rng, (b, sq, h, d), (b, skv, h, d), (b, skv, h, d))
    g = rng.standard_normal((b, sq, h, d)).astype(np.float32)

    def ref_fn(q_, k_, v_):
        return ref_flash.flash_attention(q_, k_, v_, causal=causal, bq=blk,
                                         bk=blk, interpret=True)

    want, vjp = jax.vjp(ref_fn, _ref(q), _ref(k), _ref(v))
    want_grads = vjp(_ref(g))
    tq, tk, tv = (_port(x, grad=True) for x in (q, k, v))
    got = port_flash.flash_attention(tq, tk, tv, causal=causal)
    assert got.shape == (b, sq, h, d)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=VAL_TOL, atol=VAL_TOL)
    got_grads = torch.autograd.grad(got, (tq, tk, tv), torch.from_numpy(g))
    for name, a, w in zip("qkv", got_grads, want_grads):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), rtol=GRAD_TOL,
                                   atol=GRAD_TOL, err_msg=f"d{name}")


@pytest.mark.parametrize("causal", [True, False])
def test_bf16_matches_reference(causal):
    rng = np.random.default_rng(5)
    q, k, v = _arrays(rng, *[(1, 128, 2, 32)] * 3)
    want = ref_flash.flash_attention(_ref(q, jnp.bfloat16), _ref(k, jnp.bfloat16),
                                     _ref(v, jnp.bfloat16), causal=causal,
                                     bq=64, bk=64, interpret=True)
    got = port_flash.flash_attention(_port(q, torch.bfloat16),
                                     _port(k, torch.bfloat16),
                                     _port(v, torch.bfloat16), causal=causal)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=BF16_TOL, atol=BF16_TOL)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("case", HEAD_DIM_CASES, ids=str)
def test_bf16_head_dims_values_and_grads_match_reference(case, causal):
    """bf16 at head dims 96 and 256: values and the three gradients of the
    port (its plain versions, on the CPU) against the reference's kernels in
    interpret mode, both fed the same bf16 inputs."""
    b, sq, skv, h, d, blk = case
    rng = np.random.default_rng(sq * 7 + skv + d)
    q, k, v = _arrays(rng, (b, sq, h, d), (b, skv, h, d), (b, skv, h, d))
    g = rng.standard_normal((b, sq, h, d)).astype(np.float32)

    def ref_fn(q_, k_, v_):
        return ref_flash.flash_attention(q_, k_, v_, causal=causal, bq=blk,
                                         bk=blk, interpret=True)

    want, vjp = jax.vjp(ref_fn, *(_ref(x, jnp.bfloat16) for x in (q, k, v)))
    want_grads = vjp(_ref(g, jnp.bfloat16))
    tq, tk, tv = (_port(x, torch.bfloat16, grad=True) for x in (q, k, v))
    got = port_flash.flash_attention(tq, tk, tv, causal=causal)
    assert got.dtype == torch.bfloat16 and got.shape == (b, sq, h, d)
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=BF16_TOL, atol=BF16_TOL)
    got_grads = torch.autograd.grad(got, (tq, tk, tv),
                                    _port(g, torch.bfloat16))
    for name, a, w in zip("qkv", got_grads, want_grads):
        assert a.dtype == torch.bfloat16
        np.testing.assert_allclose(a.float().numpy(), np.asarray(w, np.float32),
                                   rtol=BF16_TOL, atol=BF16_TOL, err_msg=f"d{name}")


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("sq,skv", [(64, 64), (20, 20), (40, 20)])
def test_plain_backward_functions_match_jax_grad(causal, sq, skv):
    """flash_fwd_plain's lse, then flash_bwd_dq_plain / flash_bwd_dkv_plain
    called directly on (BH, S, D) slabs, against jax's gradient of the
    reference op."""
    h, d = 3, 16
    rng = np.random.default_rng(sq + skv)
    q, k, v = _arrays(rng, (1, sq, h, d), (1, skv, h, d), (1, skv, h, d))
    g = rng.standard_normal((1, sq, h, d)).astype(np.float32)
    _, vjp = jax.vjp(lambda a, b_, c: ref_flash.flash_attention(
        a, b_, c, causal=causal, bq=16, bk=16, interpret=True),
        _ref(q), _ref(k), _ref(v))
    want = vjp(_ref(g))

    def slabs(x):   # (1, S, H, D) -> (H, S, D)
        return torch.from_numpy(x).transpose(1, 2).reshape(-1, x.shape[1], d)

    tq, tk, tv, tg = map(slabs, (q, k, v, g))
    o, lse = port_flash.flash_fwd_plain(tq, tk, tv, causal=causal)
    assert lse.dtype == torch.float32 and lse.shape == (h, sq)
    delta = torch.sum(tg * o, dim=-1)
    dq = port_flash.flash_bwd_dq_plain(tq, tk, tv, tg, lse, delta, causal=causal)
    dk, dv = port_flash.flash_bwd_dkv_plain(tq, tk, tv, tg, lse, delta,
                                            causal=causal)
    for name, a, w in (("dq", dq, want[0]), ("dk", dk, want[1]), ("dv", dv, want[2])):
        w = np.asarray(w).transpose(0, 2, 1, 3).reshape(a.shape)
        np.testing.assert_allclose(a.numpy(), w, rtol=GRAD_TOL, atol=GRAD_TOL,
                                   err_msg=name)


def test_lse_is_the_row_logsumexp():
    rng = np.random.default_rng(1)
    q, k, v = (torch.from_numpy(x) for x in _arrays(rng, *[(2, 70, 16)] * 3))
    _, lse = port_flash.flash_fwd_plain(q, k, v, causal=True)
    s = (q @ k.transpose(1, 2)) / 4.0
    s = s.masked_fill(torch.ones(70, 70, dtype=torch.bool).triu(1), -1e30)
    np.testing.assert_allclose(lse.numpy(), torch.logsumexp(s, -1).numpy(),
                               rtol=1e-6, atol=1e-5)


def test_kernel_head_dims():
    """The head dims the kernels are built for: the reference's configs'
    (16 .. 128, phi3-mini's 96, deepseek-v3's MLA q/k 192, gemma-7b's 256);
    any other raises on a CUDA tensor (tests/test_torch_gpu.py), and the
    CPU path takes every head dim."""
    assert port_flash.HEAD_DIMS == (16, 32, 64, 96, 128, 192, 256)
    q = torch.randn(1, 9, 1, 48)
    assert port_flash.flash_attention(q, q, q).shape == (1, 9, 1, 48)


@pytest.mark.parametrize("b,h,dv", [(1, 2, 16), (1, 3, 8), (2, 2, 16)])
def test_slabs_handed_to_the_kernels_pass_their_checks(monkeypatch, b, h, dv):
    """What ``flash_attention`` hands the kernel wrappers passes their
    layout check (contiguous rows, one head dim), at batch 1 too, where the
    (BH, S, D) reshape alone is a view whose rows sit H * D apart."""
    seen = []
    real = port_flash._Flash.apply

    def spy(q, k, v, causal):
        seen.append((q, k, v))
        return real(q, k, v, causal)

    monkeypatch.setattr(port_flash._Flash, "apply", spy)
    q = torch.randn(b, 9, h, 16)
    v = torch.randn(b, 9, h, dv)
    out = port_flash.flash_attention(q, q, v)
    assert out.shape == (b, 9, h, dv)
    port_flash._check("flash_fwd", *seen[0])


def test_cpu_tensors_never_launch_a_kernel():
    port_flash.reset_launches()
    q = torch.randn(1, 9, 2, 16, requires_grad=True)
    port_flash.flash_attention(q, q, q).sum().backward()
    assert port_flash.LAUNCHES == {"flash_fwd": 0, "flash_bwd_dq": 0,
                                   "flash_bwd_dkv": 0}


@pytest.mark.parametrize("wrapper", ["flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"])
@pytest.mark.parametrize("layout", ["fresh", "reshaped", "data_ptr", "slab_stride"])
def test_cp_async_alignment_check(layout, wrapper):
    """What the bf16 tensor-core kernels' 16-byte copies need of a slab,
    decided from data_ptr and strides alone (so testable on the CPU): the
    (BH, S, D) reshapes of ``flash_attention`` always pass.  Every wrapper
    checks its bf16 operands before it launches."""
    bh, s, d = 3, 20, 16
    if layout == "fresh":
        t = torch.zeros((bh, s, d), dtype=torch.bfloat16)
    elif layout == "reshaped":
        t = torch.zeros((1, s, bh, d), dtype=torch.bfloat16)
        t = t.transpose(1, 2).reshape(bh, s, d)
    elif layout == "data_ptr":
        t = torch.zeros(bh * s * d + 1, dtype=torch.bfloat16)[1:].view(bh, s, d)
    else:
        t = torch.zeros((bh, s * d + 4), dtype=torch.bfloat16)[:, :s * d].view(bh, s, d)
    source = inspect.getsource(getattr(port_flash, wrapper))
    assert f'_check_cp_async("{wrapper}", ("q", q)' in source
    if layout in ("fresh", "reshaped"):
        port_flash._check_cp_async(wrapper, ("q", t))
    else:
        with pytest.raises(ValueError, match=f"{wrapper}: bf16 q must start 16-byte aligned"):
            port_flash._check_cp_async(wrapper, ("q", t))


def test_flash_ops_counts_visible_pairs():
    for sq, skv in ((5, 5), (3, 7), (7, 3)):
        pairs = sum(1 for i in range(sq) for j in range(skv) if i >= j)
        ops = port_flash.flash_ops(2, sq, skv, 8, causal=True)
        assert ops["flash_fwd"] == 4 * 2 * pairs * 8
        assert ops["flash_bwd_dq"] == 6 * 2 * pairs * 8
        assert ops["flash_bwd_dkv"] == 8 * 2 * pairs * 8
    assert port_flash.flash_ops(1, 4, 6, 2, causal=False)["flash_fwd"] == 4 * 24 * 2
    # a narrower V: QK^T at d, PV at dv, whatever the kernels are handed
    ops = port_flash.flash_ops(2, 5, 5, 192, causal=True, dv=128)
    assert ops == {"flash_fwd": 2 * 2 * 15 * (192 + 128),
                   "flash_bwd_dq": 2 * 2 * 15 * (2 * 192 + 128),
                   "flash_bwd_dkv": 2 * 2 * 15 * (2 * 192 + 2 * 128)}


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_blockwise_attention_matches_reference(causal, dtype):
    rng = np.random.default_rng(2)
    q, k, v = _arrays(rng, *[(2, 64, 2, 16)] * 3)
    want = ref_attn.blockwise_attention(_ref(q, dtype), _ref(k, dtype),
                                        _ref(v, dtype), causal=causal,
                                        q_chunk=16, kv_chunk=32)
    tdt = getattr(torch, dtype)
    got = port_attn.blockwise_attention(_port(q, tdt), _port(k, tdt),
                                        _port(v, tdt), causal=causal,
                                        q_chunk=16, kv_chunk=32)
    tol = VAL_TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)
    with pytest.raises(ValueError):
        port_attn.blockwise_attention(_port(q), _port(k), _port(v),
                                      causal=causal, q_chunk=24)


@pytest.mark.parametrize("causal", [True, False])
def test_mixed_attention_matches_reference(causal, monkeypatch):
    rng = np.random.default_rng(3)
    q, k, v = _arrays(rng, *[(1, 32, 2, 16)] * 3)
    # below the threshold both take naive attention, above it blockwise
    for threshold in (8192, 8):
        monkeypatch.setattr(ref_attn, "BLOCKWISE_THRESHOLD", threshold)
        monkeypatch.setattr(port_attn, "BLOCKWISE_THRESHOLD", threshold)
        want = ref_attn._mixed_attention(_ref(q), _ref(k), _ref(v), causal=causal)
        got = port_attn._mixed_attention(_port(q), _port(k), _port(v),
                                         causal=causal)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=VAL_TOL, atol=VAL_TOL)
