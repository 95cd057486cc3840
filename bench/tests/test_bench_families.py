"""A model family and its reference come as files: a configuration naming
a family module and a reference file of its own, and a workload over it,
added to a copy of the bench tree, are found, built, served and judged by
the harness with no harness file edited; an unknown family or reference
file is refused (exit code 2), naming the file."""

import subprocess
import sys
import time

import pytest

from bench import manifest, serve
from bench.tests import smoke_cells

CELL = "phi3-mini-3.8b.docqa"

#: a family of its own: the dense model, refusing a configuration that does
#: not say it is a toy, and keeping what it built
TOY_FAMILY = '''
from bench.families import dense
from bench.families.dense import (gemm_calls, head_ops, layer_params,
                                  port_config, token_ops)

BUILT = []


def sizes_of(config, longest=None):
    from bench.manifest import ManifestError
    if config.get("toy") is not True:
        raise ManifestError("not a toy configuration")
    return dense.sizes_of(config, longest)


def build(cell, sizes, seed, device, rank=0, world=1):
    params, engine = dense.build(cell, sizes, seed, device, rank, world)
    BUILT.append((cell["name"], rank, world))
    return params, engine
'''

#: a reference of its own: the dense one, compared at two sites of layer 0
TOY_REFERENCE = '''
from bench.reference import Reference as _Dense, prompt_tokens

SITES = ("wq", "w_down")
MADE = []


class Reference(_Dense):
    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        MADE.append(self.precision)
'''


def _toy_tree(tmp_path, family="toy", reference="bench/toy_reference.py"):
    config = dict(smoke_cells.WIDER, toy=True, family=family,
                  reference=reference)
    bench = smoke_cells.checkout(
        tmp_path, configs={"toy-tiny": config},
        workloads={"toy-tiny.chat": (smoke_cells.workload(CELL, "toy-tiny"),
                                     1)},
        files={"bench/families/toy.py": TOY_FAMILY,
               "bench/toy_reference.py": TOY_REFERENCE})
    return bench, tmp_path / "bench"


def test_a_family_and_its_reference_are_added_as_files(tmp_path):
    bench, base = _toy_tree(tmp_path)
    cell = manifest.cell(bench, "toy-tiny.chat", base)
    family, ref = manifest.family(cell), manifest.reference(cell)
    assert family.__file__ == str(base / "families" / "toy.py")
    assert ref.__file__ == str(base / "toy_reference.py")
    out = serve.run_cell(cell, 2**31 + 41, 0.0, False,
                         t_start=time.perf_counter(), metrics=[],
                         device="cpu", plan=smoke_cells.PLAN)
    assert out["correct"], out["check"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert out["device"]["count"] == 1
    assert family.BUILT == [("toy-tiny.chat", 0, 1)]
    assert ref.MADE == ["fp32"]
    # the family's own refusal holds
    with pytest.raises(manifest.ManifestError, match="not a toy"):
        family.sizes_of(dict(smoke_cells.WIDER))


def test_the_probe_keeps_the_sites_the_reference_names(tmp_path):
    bench, base = _toy_tree(tmp_path)
    cell = manifest.cell(bench, "toy-tiny.chat", base)
    probe = serve.make_probe(cell, type("E", (), dict.fromkeys(
        serve.PROGRAM_ATTRS))(), 5)
    assert probe.sites == {"wq", "w_down"}


@pytest.mark.parametrize("missing", ["family", "reference"])
def test_an_unknown_family_or_reference_file_is_refused(tmp_path, missing):
    family, reference, named = "toy", "bench/toy_reference.py", None
    if missing == "family":
        family, named = "no_such_family", "bench/families/no_such_family.py"
    else:
        reference = named = "bench/no_such_reference.py"
    _toy_tree(tmp_path, family, reference)
    out = subprocess.run(
        [sys.executable, "bench/run.py", "--workload", "toy-tiny.chat",
         "--seed", str(2**31 + 43), "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode == 2, out.stderr
    assert out.stdout == ""
    assert named in out.stderr, out.stderr


PHI3 = {"d_model": 3072, "d_ff": 8192, "num_layers": 32, "num_heads": 32,
        "num_kv_heads": 32, "head_dim": 96, "vocab_size": 32064,
        "rope_theta": 1e4, "rms_eps": 1e-5}


def _ops(calls) -> int:
    return sum(times * sum(2 * k * n * r for k, n, r in gemms)
               for times, gemms in calls)


@pytest.mark.parametrize("grid", [[2, 2], [1, 4], [3, 1]])
def test_dense_gemm_calls_split_over_a_grid(grid):
    from bench.families import dense
    whole = dense.gemm_calls(PHI3, {}, 10, 2)
    assert [t for t, _ in whole] == [32, 1]
    assert whole[1][1] == [(3072, 32064, 2)]
    world = grid[0] * grid[1]
    engine = {"grid": grid}
    # one process runs every shard; each rank of the grid its own
    assert _ops(dense.gemm_calls(PHI3, engine, 10, 2)) == _ops(whole)
    per_rank = [dense.gemm_calls(PHI3, engine, 10, 2, rank=r, world=world)
                for r in range(world)]
    assert sum(_ops(c) for c in per_rank) == _ops(whole)
    assert all(len(g) == 7 for c in per_rank for g in [c[0][1]])
    if grid == [2, 2]:
        # rank 3 holds the second K band and the second column band
        assert per_rank[3][0][1][0] == (1536, 1536, 10)
        assert per_rank[3][1][1] == [(1536, 16032, 2)]
    with pytest.raises(manifest.ManifestError, match="grid"):
        dense.gemm_calls(PHI3, {}, 10, 2, rank=0, world=world)


def test_mfu_divides_by_every_card():
    from bench import traffic
    rec = serve.TraceRecord(index=0, requests=(traffic.Request(0, 0, 3, 2),),
                            t_call=0.0, t_return=2.0)
    rec.tokens = {0: [1, 2]}
    mfu = manifest.reader("mfu.serve")
    view = serve.RunView(setup_s=1.0, window=serve.Window([rec]), sizes=PHI3,
                         bits=4, device_kind="NVIDIA H100 80GB HBM3")
    one = mfu.read(view)
    assert one == pytest.approx(100 * mfu.window_ops(view.window, PHI3)
                                / 2.0 / 1979e12)
    view.chips = 4
    assert mfu.read(view) == pytest.approx(one / 4)
