"""The dense family measures what the harness measured before families
were files of their own.  On a smoke cell and one seed: the weight tree
bit for bit (leaf order, one draw a leaf), the reference's logits and
layer-0 integer products, a run's check numbers and the TF32 control's,
and the two readers' counts over one served trace, against the values the
harness gave while the dense code lived in ``bench/weights.py`` and
``bench/serve.py`` (``make_params``, ``sizes_of``, ``run_cell``,
``mfu.serve``'s ``window_ops``, ``tub_gemm_roofline``'s
``least_seconds``)."""

import hashlib
import time

import pytest
import torch

from bench import control, manifest, serve
from bench.tests import smoke_cells

CELL = "phi3-mini-3.8b.docqa"
SEED = 2**31 + 101
H100 = "NVIDIA H100 80GB HBM3"

LEAVES = ["/embed", "/final_norm", "/layers/attn/wk", "/layers/attn/wo",
          "/layers/attn/wq", "/layers/attn/wv", "/layers/ln1", "/layers/ln2",
          "/layers/mlp/w_down", "/layers/mlp/w_gate", "/layers/mlp/w_up",
          "/lm_head"]
WEIGHTS_SHA = ("1cf35f23a15a261d980158f8ae801640c151ae0b1f7d2f0ffa67495b2c0"
               "dfe91")
#: the reference over request 7's 40-token prompt
ARGMAX = [906, 36, 609, 333, 906, 343, 987, 593, 142, 163, 499, 569, 903, 916,
          998, 814, 562, 814, 562, 427, 156, 156, 156, 156, 515, 156, 790, 908,
          156, 138, 194, 998, 328, 156, 156, 121, 156, 1007, 414, 103]
LOGIT_SUM = 421.69415323249996
PRODUCTS_SHA = ("922ceecef16fa6a444865c9a63bb5892cf613c719c7238aecc2f215e"
                "44eb12b7")
RUN_CHECK = {"first_over": 0.0, "l0_rows_off": 0.0, "tokens_over": 0.0}
CONTROL_CHECK = {"first_over": 0.0, "l0_rows_off": 0.07738095238095238,
                 "tokens_over": 0.012500000186264515}
WINDOW_OPS = 880691200.0
LEAST_SECONDS = 8.256191044776114e-06
#: trace 0's served tokens, request id -> tokens
TOKENS = {0: [522, 49, 527, 625, 258, 744, 479, 536, 321],
          1: [120, 562, 433, 865, 71, 600, 596, 737],
          2: [632, 807, 873, 484, 289, 122, 629],
          3: [156, 988, 286, 396, 396, 156, 345, 331, 145, 305, 307, 805, 693,
              616],
          4: [661, 56, 864, 13, 1008, 989, 817, 273, 1021, 864, 613, 107, 132],
          5: [402, 536, 208, 1006, 918, 660],
          6: [67, 967, 657, 967, 754, 721, 535, 255, 370, 935, 370, 728],
          7: [194, 269, 156, 156, 156, 156, 156, 156, 156, 156, 156]}


def _cell(**traffic):
    return smoke_cells.cell(CELL, configuration=dict(smoke_cells.WIDER,
                                                     name=CELL), **traffic)


def _leaves(node, path=""):
    if isinstance(node, dict):
        for k in sorted(node):
            yield from _leaves(node[k], f"{path}/{k}")
    else:
        yield path, node


@pytest.fixture(scope="module")
def drawn():
    cell = _cell()
    family = manifest.family(cell)
    sizes = family.sizes_of(cell["configuration"],
                            serve.longest_positions(cell))
    return cell, sizes, family.make_params(sizes, SEED, torch.device("cpu"))


def test_weight_tree_is_bit_for_bit(drawn):
    _, _, params = drawn
    h = hashlib.sha256()
    for path, t in _leaves(params):
        h.update(path.encode())
        h.update(str(tuple(t.shape)).encode())
        h.update(t.contiguous().numpy().tobytes())
    assert [p for p, _ in _leaves(params)] == LEAVES
    assert h.hexdigest() == WEIGHTS_SHA


def test_reference_logits_and_layer0_products(drawn):
    cell, sizes, params = drawn
    ref = manifest.reference(cell)
    prompt = ref.prompt_tokens(SEED, 7, 40, sizes["vocab_size"])
    seq = torch.tensor(prompt, dtype=torch.long)
    (logits,), products = ref.Reference(sizes, params, 4).run(
        [seq], [torch.arange(40)], {0: torch.arange(40)}, (0,))
    assert logits.argmax(-1).tolist() == ARGMAX
    assert float(logits.double().sum()) == pytest.approx(LOGIT_SUM, rel=1e-12)
    h = hashlib.sha256()
    for site in ref.SITES:
        h.update(site.encode())
        h.update(products[0][0][site].to(torch.int64).numpy().tobytes())
    assert h.hexdigest() == PRODUCTS_SHA


def test_run_check_numbers():
    out = serve.run_cell(_cell(), SEED, 0.0, False,
                         t_start=time.perf_counter(), metrics=[],
                         device="cpu", plan=smoke_cells.PLAN)
    assert (out["attempted"], out["failed"], out["correct"]) == (16, 0, True)
    assert {k: v["value"] for k, v in out["check"].items()} == RUN_CHECK


def test_control_check_numbers():
    program, ctl = control.readings(_cell(prompt=[40, 90]), SEED,
                                    torch.device("cpu"), plan=smoke_cells.PLAN)
    assert {k: v["value"] for k, v in program["check"].items()} == RUN_CHECK
    assert {k: v["value"] for k, v in ctl["check"].items()} == CONTROL_CHECK
    assert (ctl["requests"], ctl["tokens"]) == (8, 80)


def test_reader_counts_over_a_served_trace():
    cell = _cell()
    sizes, _, window, _, _ = control._served(cell, SEED, torch.device("cpu"),
                                             smoke_cells.PLAN)
    assert window.traces[0].tokens == TOKENS
    view = serve.RunView(setup_s=1.0, window=window, sizes=sizes, bits=4,
                         device_kind=H100, traced=window.traces[0],
                         family=manifest.family(cell), engine=cell["engine"])
    assert manifest.reader("mfu.serve").window_ops(
        window, sizes, view.family) == WINDOW_OPS
    assert manifest.reader("tub_gemm_roofline").least_seconds(
        view) == LEAST_SECONDS
