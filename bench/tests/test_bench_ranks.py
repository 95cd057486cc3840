"""The launcher of a cell of several cards (``bench/ranks.py``), on two
``gloo`` ranks on the CPU: one spawn a case, every case at once, once for
the file.

A smoke cell on ``chips: 2`` under the engine grid ``[1, 2]`` runs through
``bench/run.py``'s rank processes: one result line, rank 0's, with
``device.count`` 2, correct, and the tokens every rank served equal the
one-process grid engine's; ``bench/control.py`` on the same cell reads on
its two ranks what it reads in one process. A rank whose check fails
alone makes the line read ``correct: false``. A rank made to raise, or to
stall past the cell's limit, ends the launch non-zero within the limit,
naming the rank and its phase; where there is no card the command exits 3
and prints nothing. The family module that serves these cells is
a file of the test's own (the dense family, each served trace's tokens
written down, a fault planted on one rank), added to a copy of the bench
tree.
"""

import json
import subprocess
import sys
import threading
import time

import pytest
import torch

from bench import control, manifest, ranks, serve
from bench.tests import smoke_cells

CELL = "phi3-mini-3.8b.docqa"
SEED = 2**31 + 61
STALL_LIMIT_S = 60.0

SPY_FAMILY = '''
import dataclasses
import json
import time
from pathlib import Path

from bench.families import dense
from bench.families.dense import (gemm_calls, head_ops, layer_params,
                                  port_config, sizes_of, token_ops)


def build(cell, sizes, seed, device, rank=0, world=1):
    cfg = cell["configuration"]
    if cfg.get("fault_rank") == rank:
        if cfg["fault"] == "raise":
            raise RuntimeError(f"a fault planted on rank {rank}")
        time.sleep(3600)
    params, engine = dense.build(cell, sizes, seed, device, rank, world)
    out = Path(cfg["spy_dir"]) / f"{cell['name']}.{rank}.json"
    run = engine.run

    def spy(trace, scheduler):
        report = run(trace, scheduler)
        if cfg.get("alter_rank") == rank:
            # every token this rank served one id off, after the step
            report = dataclasses.replace(report, request_tokens={
                k: [(int(t) + 1) % sizes["vocab_size"] for t in v]
                for k, v in report.request_tokens.items()})
        seen = json.loads(out.read_text()) if out.exists() else {}
        seen.update({str(k): list(v)
                     for k, v in report.request_tokens.items()})
        out.write_text(json.dumps(seen))
        return report

    engine.run = spy
    return params, engine
'''


@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    root = tmp_path_factory.mktemp("checkout")
    spies = tmp_path_factory.mktemp("tokens")
    config = dict(smoke_cells.WIDER, family="spy", spy_dir=str(spies),
                  reference="bench/reference.py")
    grid = smoke_cells.workload(CELL, "toy-grid", grid=[1, 2])
    cells = {"toy-grid.two": (dict(grid, limit_s=200.0), 2),
             "toy-grid.one": (grid, 1),
             "toy-alter.two": (dict(grid, config="toy-alter"), 2)}
    configs = {"toy-grid": config, "toy-alter": dict(config, alter_rank=1)}
    for fault in ("raise", "stall"):
        configs[f"toy-{fault}"] = dict(config, fault=fault, fault_rank=1)
        cells[f"toy-{fault}.two"] = (dict(grid, config=f"toy-{fault}",
                                          limit_s=STALL_LIMIT_S), 2)
    bench = smoke_cells.checkout(root, configs=configs, workloads=cells,
                                 files={"bench/families/spy.py": SPY_FAMILY})
    results = {}

    def run(name):
        t0 = time.perf_counter()
        cell = manifest.cell(bench, name, root / "bench")
        results[name] = ranks.launch(
            root / "bench" / "run.py",
            ["--workload", name, "--seed", str(SEED), "--seconds", "0",
             "--trace", "0"], 2, device="cpu",
            limit_s=float(cell.get("limit_s", ranks.LIMIT_S)), t_start=t0
        ) + (time.perf_counter() - t0,)

    threads = [threading.Thread(target=run, args=(n,))
               for n in ("toy-stall.two", "toy-grid.two", "toy-raise.two",
                         "toy-alter.two")]
    for t in threads:
        t.start()
    ctl = subprocess.Popen(
        [sys.executable, "bench/control.py", "--workload", "toy-grid.two",
         "--seeds", str(SEED), "--device", "cpu"],
        cwd=root, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    # the command as the benchmark is run, where there is no card
    cmd = subprocess.Popen(
        [sys.executable, "bench/run.py", "--workload", "toy-grid.two",
         "--seed", str(SEED), "--seconds", "0", "--trace", "0"],
        cwd=root, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    # the one-process grid engine and control, here, while the ranks run
    one_cell = manifest.cell(bench, "toy-grid.one", root / "bench")
    one = serve.run_cell(one_cell, SEED, 0.0, False,
                         t_start=time.perf_counter(), metrics=[],
                         device="cpu")
    one_control = control.readings(one_cell, SEED, torch.device("cpu"))
    try:
        ctl_out, ctl_err = ctl.communicate(timeout=300)
        cmd_out, cmd_err = cmd.communicate(timeout=300)
    finally:
        ctl.kill()
        cmd.kill()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads)
    tokens = {p.stem: json.loads(p.read_text()) for p in spies.iterdir()}
    return {"results": results, "one": one, "tokens": tokens,
            "control": (ctl.returncode, ctl_out, ctl_err),
            "command": (cmd.returncode, cmd_out, cmd_err),
            "one_control": one_control}


def test_one_result_line_from_rank_0_with_both_cards(launched):
    code, outputs, why, _ = launched["results"]["toy-grid.two"]
    assert code == 0 and why == ""
    # rank 0 prints the run's object, rank 1 its peak, verdict and numbers
    assert [len(o.splitlines()) for o in outputs] == [1, 1]
    assert json.loads(outputs[1]) == {
        "rank": 1, "correct": True, "memory_peak_bytes": 0,
        "check": json.loads(outputs[0])["check"]}
    line = ranks.result_line(outputs)
    assert "\n" not in line
    out = json.loads(line)
    assert out["correct"], out["check"]
    assert out["device"]["count"] == 2
    assert out["attempted"] > 0 and out["failed"] == 0
    assert list(out)[-1] == "check"
    assert out["check"] == launched["one"]["check"]


def test_every_rank_serves_the_one_process_grid_engines_tokens(launched):
    tokens = launched["tokens"]
    one = tokens["toy-grid.one.0"]
    assert len(one) > 8
    assert tokens["toy-grid.two.0"] == one
    assert tokens["toy-grid.two.1"] == one


def test_a_check_failed_on_one_rank_fails_the_line(launched):
    code, outputs, why, _ = launched["results"]["toy-alter.two"]
    assert code == 0 and why == ""
    rank0, rank1 = (json.loads(o) for o in outputs)
    assert rank0["correct"] and not rank1["correct"]
    out = json.loads(ranks.result_line(outputs))
    assert out["correct"] is False
    # each number the worse rank's: rank 1's tokens all one id off
    assert out["check"] == {
        name: dict(c, value=max(c["value"], rank1["check"][name]["value"]))
        for name, c in rank0["check"].items()}
    assert out["check"]["tokens_over"]["value"] > 0.9


@pytest.mark.parametrize("fault", ["raise", "stall"])
def test_a_failed_or_stalled_rank_ends_the_launch_named(launched, fault):
    code, outputs, why, seconds = launched["results"][f"toy-{fault}.two"]
    assert code != 0 and outputs is None
    assert seconds < STALL_LIMIT_S + 15
    assert why.startswith({
        "raise": "rank 1 of 2 exited with code 1 in phase 'weights and "
                 "engine'",
        "stall": f"the run passed its limit of {STALL_LIMIT_S:g} s; rank 1 "
                 f"in phase 'weights and engine' lagged furthest"}[fault]), why
    assert why.endswith("every rank stopped"), why


def test_control_reads_on_two_ranks_what_it_reads_in_one_process(launched):
    code, out, err = launched["control"]
    assert code == 0, err[-3000:]
    lines = [json.loads(ln) for ln in out.splitlines()]
    assert [ln["side"] for ln in lines] == ["program", "control"]
    for two, one in zip(lines, launched["one_control"]):
        assert two["check"] == one["check"]
        assert (two["correct"], two["tokens"]) == (one["correct"],
                                                   one["tokens"])


def test_a_launch_where_there_is_no_card_exits_3_unprinted(launched):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    code, out, err = launched["command"]
    assert code == 3 and out == "", err[-3000:]
    assert "torch.cuda.is_available() is False" in err
    assert "exited with code 3 in phase 'start'" in err
