"""The plain reference against the port's engine, at each configuration's
``smoke_config()`` sizes, on the CPU.

Tolerance: 1e-4 on a logit.  Both sides compute the same float32 numbers
(the integer products are exact on both), in other summation orders in
attention and the norms; a flipped 4-bit code would move a logit by about
a hundredth, and none flips at these sizes and seeds."""

import numpy as np
import pytest
import torch

from bench import reference
from bench.families import dense
from bench.tests import smoke_cells

TOL = 1e-4


def _engine(arch: str, seed: int):
    from repro_torch.serving.engine import ServingEngine
    sizes = dense.sizes_of(smoke_cells.port_smoke_sizes(arch))
    params = dense.make_params(sizes, seed, torch.device("cpu"))
    engine = ServingEngine(
        dense.port_config(arch, sizes), params, max_batch=2, page_size=4,
        max_seq_len=64, backend="tubgemm_cuda", bits=4, attention="fused",
        prompt_seed=seed, device="cpu")
    return sizes, params, engine


@pytest.mark.parametrize("arch", ["phi3-mini-3.8b", "internlm2-1.8b"])
@pytest.mark.parametrize("seed", [3, 2**31 + 5])
def test_reference_equals_engine_logits(arch, seed):
    from repro_torch.models.common import activation_scaling
    from repro_torch.serving.traffic import TrafficRequest
    sizes, params, engine = _engine(arch, seed)
    decoded = []
    inner = engine._decode

    def keep(*args):
        out = inner(*args)
        decoded.append((args[1][:, 0].clone(), args[5].clone(),
                        args[6].clone(), out[0][:, 0].clone()))
        return out

    engine._decode = keep
    trace = (TrafficRequest(0, 0, 37, 6), TrafficRequest(1, 1, 21, 5))
    with activation_scaling("per-row"):
        report = engine.run(trace, "continuous")
    ref = reference.Reference(sizes, params, 4)
    compared = 0
    for slot, req in enumerate(trace):       # two requests: slots 0 and 1
        prompt = reference.prompt_tokens(seed, req.req_id, req.prompt_len,
                                         sizes["vocab_size"])
        np.testing.assert_array_equal(prompt, engine.prompt_tokens(req))
        served = list(report.request_tokens[req.req_id])
        seq = torch.tensor(list(prompt) + served[:-1])
        rows = torch.arange(req.prompt_len - 1, seq.shape[0])
        (logits,), _ = ref.run([seq], [rows])
        # every served token is the reference's best at its position
        assert logits.argmax(dim=-1).tolist() == served
        # and every decode step's logits equal the reference's
        for tokens, lengths, active, lg in decoded:
            if bool(active[slot]):
                pos = int(lengths[slot])
                assert int(tokens[slot]) == int(seq[pos])
                want = logits[pos - req.prompt_len + 1]
                assert float((lg[slot] - want).abs().max()) <= TOL
                compared += 1
    assert compared == sum(r.output_len - 1 for r in trace)


@pytest.mark.parametrize("arch", ["phi3-mini-3.8b", "internlm2-1.8b"])
def test_reference_equals_engine_prefill(arch):
    from repro_torch.models.common import activation_scaling
    sizes, params, engine = _engine(arch, 11)
    prompt = reference.prompt_tokens(11, 4, 29, sizes["vocab_size"])
    padded = torch.zeros((1, 32), dtype=torch.int32)
    padded[0, :29] = torch.from_numpy(prompt)
    with engine._scope(), activation_scaling("per-row"):
        logits, _, _ = engine._prefill(padded)
    ref = reference.Reference(sizes, params, 4)
    (want,), _ = ref.run([torch.from_numpy(prompt).long()],
                         [torch.arange(29)])
    assert float((logits[0, :29] - want).abs().max()) <= TOL


def test_quantizer_rounds_half_to_even_and_flushes():
    x = torch.tensor([[0.5, 1.5, 2.5, -0.5, 7.0]])
    codes, scale = reference.quantize_rows(x, 4)
    assert float(scale[0, 0]) == pytest.approx(1.0)
    assert codes.tolist() == [[0.0, 2.0, 2.0, -0.0, 7.0]]
    zero_codes, zero_scale = reference.quantize_columns(torch.zeros(3, 2), 4)
    assert zero_scale.tolist() == [0.0, 0.0]
    assert zero_codes.abs().sum() == 0


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2.0 ** -10, 1.0 + 2.0 ** -12, 1.0 + 2.0 ** -11])
    got = reference._to_tf32(x)
    assert got.tolist() == [1.0 + 2.0 ** -10, 1.0, 1.0 + 2.0 ** -10]
