"""The manifest: cells, configurations and metrics found by name, a new one
added as new files only, unknown names refused; the committed
BENCHMARK.json inside the contract's limits."""

import json
import re
import shutil
from pathlib import Path

import pytest

from bench import manifest

ROOT = Path(__file__).resolve().parents[2]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture
def added(tmp_path):
    """A copy of bench's data files with one more cell, configuration and
    per-layer metric, each in a file of its own."""
    base = tmp_path / "bench"
    for kind in ("configs", "workloads", "metrics"):
        shutil.copytree(manifest.BENCH / kind, base / kind)
    bench = manifest.load(ROOT)
    cfg = json.loads((base / "configs" / "internlm2-1.8b.json").read_text())
    cfg["name"] = "internlm2-1.8b-copy"
    (base / "configs" / "internlm2-1.8b-copy.json").write_text(json.dumps(cfg))
    wl = json.loads((base / "workloads" / "internlm2-1.8b.longdoc.json")
                    .read_text())
    wl["config"] = "internlm2-1.8b-copy"
    wl["engine"]["packed"] = True
    (base / "workloads" / "internlm2-1.8b-copy.packed.json").write_text(
        json.dumps(wl))
    (base / "metrics" / "prefill_ms.serve.py").write_text(
        "def read(run):\n    return 1.5\n")
    bench["configs"].append({"name": "internlm2-1.8b-copy", "source": "x",
                             "file": "bench/configs/internlm2-1.8b-copy.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "internlm2-1.8b-copy.packed",
                               "config": "internlm2-1.8b-copy",
                               "traffic": "packed", "chips": 1, "why": "x"})
    bench["per_layer"].append({"name": "prefill_ms.serve", "unit": "ms",
                               "better": "lower", "source": "host_clock",
                               "layer": "engine host loop",
                               "moves": "ttft_p90_ms",
                               "workloads": ["internlm2-1.8b-copy.packed"]})
    return bench, base


def test_new_cell_config_and_metric_are_found_as_new_files(added):
    bench, base = added
    c = manifest.cell(bench, "internlm2-1.8b-copy.packed", base)
    assert c["engine"]["packed"] is True
    assert c["configuration"]["name"] == "internlm2-1.8b-copy"
    names = [m["name"] for m in
             manifest.metrics_for(bench, "internlm2-1.8b-copy.packed", True)]
    assert "prefill_ms.serve" in names and "mfu.serve" in names
    assert manifest.reader("prefill_ms.serve", base).read(None) == 1.5
    # the metric that lists its cells is not reported elsewhere
    assert "prefill_ms.serve" not in [
        m["name"] for m in manifest.metrics_for(bench, "phi3-mini-3.8b.docqa",
                                                True)]


@pytest.mark.parametrize("call", ["cell", "config", "metric", "file"])
def test_unknown_names_are_refused(added, call):
    bench, base = added
    with pytest.raises(manifest.ManifestError):
        if call == "cell":
            manifest.cell(bench, "nope.chat", base)
        elif call == "config":
            bench["workloads"].append({"name": "x.y", "config": "nope",
                                       "traffic": "y", "chips": 1, "why": "x"})
            (base / "workloads" / "x.y.json").write_text(
                json.dumps({"config": "nope"}))
            manifest.cell(bench, "x.y", base)
        elif call == "metric":
            manifest.reader("no_such_metric", base)
        else:
            bench["workloads"].append({"name": "z.w", "config": "phi3-mini-3.8b",
                                       "traffic": "w", "chips": 1, "why": "x"})
            manifest.cell(bench, "z.w", base)


def test_committed_benchmark_keeps_the_contract():
    bench = manifest.load(ROOT)
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["command"] == ["python3", "bench/run.py"]
    assert bench["paths"] == ["bench"]
    assert 1 <= bench["run_seconds"] <= 51
    names = set()
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("bench/")
        assert json.loads((ROOT / c["file"]).read_text())["name"] == c["name"]
        names.add(c["name"])
    cells = set()
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in names and w["chips"] in (1, 4)
        assert len(w["why"]) <= 200
        manifest.cell(bench, w["name"])
        cells.add(w["name"])
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        manifest.reader(m["name"])
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    layers = set()
    for m in bench["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]
        assert set(m.get("workloads", cells)) <= cells
        layers.add(m["layer"])
    assert len(json.dumps(bench)) < 64 * 1024


@pytest.mark.parametrize("cell", ["phi3-mini-3.8b.docqa",
                                  "internlm2-1.8b.longdoc"])
def test_committed_configurations_are_served_as_published(cell):
    from bench import serve
    c = manifest.cell(manifest.load(ROOT), cell)
    sizes = manifest.family(c).sizes_of(c["configuration"],
                                        serve.longest_positions(c))
    assert sizes["num_layers"] == c["configuration"]["num_hidden_layers"]


# (published keys changed from phi3-mini-3.8b's file, refused?)
UNSERVED_CASES = {
    "gelu": ({"hidden_act": "gelu"}, True),
    "tied": ({"tie_word_embeddings": True}, True),
    "tie_unstated": ({"tie_word_embeddings": None}, True),
    "attention_bias": ({"attention_bias": True}, True),
    "mlp_bias": ({"mlp_bias": True}, True),
    "experts": ({"num_local_experts": 16}, True),
    "partial_rope": ({"partial_rotary_factor": 0.5}, True),
    "window_under_requests": ({"sliding_window": 1024}, True),
    "window_over_requests": ({"sliding_window": 4096}, False),
    "linear_rope_scaling": ({"rope_scaling": {"type": "linear",
                                              "factor": 2.0}}, True),
    "dynamic_beyond_requests": ({"rope_scaling": {"type": "dynamic",
                                                  "factor": 2.0}}, False),
    "dynamic_within_requests": ({"rope_scaling": {"type": "dynamic",
                                                  "factor": 2.0},
                                 "max_position_embeddings": 1024}, True),
    "no_bias_false": ({"attention_bias": False, "bias": False}, False),
}


@pytest.mark.parametrize("case", list(UNSERVED_CASES))
def test_a_key_the_port_does_not_serve_is_refused(case):
    from bench import serve
    from bench.families import dense
    change, refused = UNSERVED_CASES[case]
    c = manifest.cell(manifest.load(ROOT), "phi3-mini-3.8b.docqa")
    config = dict(c["configuration"], **change)
    config = {k: v for k, v in config.items() if v is not None}
    longest = serve.longest_positions(c)
    assert longest == 2015 + 32 - 1
    if refused:
        with pytest.raises(manifest.ManifestError, match="phi3-mini-3.8b"):
            dense.sizes_of(config, longest)
    else:
        dense.sizes_of(config, longest)
