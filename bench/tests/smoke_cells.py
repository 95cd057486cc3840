"""Cells of the benchmark cut to sizes a CPU test run holds."""

from __future__ import annotations

import copy
import json
import shutil
from pathlib import Path

from bench import serve

BENCH = Path(__file__).resolve().parents[1]


#: a configuration wide enough that one flipped 4-bit code is rare and a
#: fault's effect on the tokens is not (two layers, CPU-sized)
WIDER = {"hidden_size": 256, "intermediate_size": 512, "num_hidden_layers": 2,
         "num_attention_heads": 4, "num_key_value_heads": 2,
         "vocab_size": 1024, "rope_theta": 10000.0, "rms_norm_eps": 1e-5,
         "hidden_act": "silu", "tie_word_embeddings": False}

#: the check's picks of a smoke trace, which runs few steps
PLAN = serve.CheckPlan(prefill=(0, 2), decode=(1, 3), sample_tokens=1000)


def port_smoke_sizes(arch: str) -> dict:
    """The published keys of the port's ``smoke_config()`` of ``arch``."""
    from repro_torch import configs
    cfg = configs.get_smoke_config(arch)
    return {"name": arch, "hidden_size": cfg.d_model,
            "intermediate_size": cfg.d_ff, "num_hidden_layers": cfg.num_layers,
            "num_attention_heads": cfg.num_heads,
            "num_key_value_heads": cfg.num_kv_heads,
            "vocab_size": cfg.vocab_size, "rope_theta": cfg.rope_theta,
            "rms_norm_eps": cfg.rms_eps, "hidden_act": "silu",
            "tie_word_embeddings": False}


def cell(name: str, *, configuration: dict | None = None, **traffic) -> dict:
    """The benchmark's cell ``name`` with its limits, on the port's smoke
    sizes (or ``configuration``), a small engine and short traffic; its
    configuration's reference file unless ``configuration`` names one."""
    wl = json.loads((BENCH / "workloads" / f"{name}.json").read_text())
    committed = json.loads((BENCH / "configs" / f"{wl['config']}.json")
                           .read_text())
    cfg = dict(configuration or port_smoke_sizes(wl["config"]))
    cfg.setdefault("reference", committed["reference"])
    out = copy.deepcopy(wl)
    out.update(name=name, chips=1, configuration=cfg)
    out["engine"].update(max_batch=4, page_size=4, max_seq_len=96,
                         num_pages=None)
    out["traffic"] = dict({"requests": 8, "rate": 2.0, "prompt": [9, 60],
                           "output": [6, 14], "trace_seconds": 1.0}, **traffic)
    return out


def checkout(dest: Path, *, configs: dict | None = None,
             workloads: dict | None = None, files: dict | None = None) -> dict:
    """A checkout for a test at ``dest``: a copy of ``bench/`` and of
    ``BENCHMARK.json``, the port's ``src/`` linked in, and

    ``configs``  ``{name: configuration}``, each a configuration file and a
      ``configs`` entry;
    ``workloads``  ``{name: (workload, chips)}``, each a workload file and a
      ``workloads`` entry;
    ``files``  ``{path from dest: text}``, written as they are;

    added as new files, no file of the copy edited but the manifest.
    Returns the manifest."""
    root = BENCH.parent
    shutil.copytree(BENCH, dest / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (dest / "src").symlink_to(root / "src")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    for name, cfg in (configs or {}).items():
        (dest / "bench" / "configs" / f"{name}.json").write_text(
            json.dumps(dict(cfg, name=name)))
        bench["configs"].append({"name": name, "source": "a test",
                                 "file": f"bench/configs/{name}.json",
                                 "reduced": [], "why": "a test"})
    for name, (wl, chips) in (workloads or {}).items():
        (dest / "bench" / "workloads" / f"{name}.json").write_text(
            json.dumps(wl))
        bench["workloads"].append({"name": name, "config": wl["config"],
                                   "traffic": name.rpartition(".")[2],
                                   "chips": chips, "why": "a test"})
    for path, text in (files or {}).items():
        (dest / path).parent.mkdir(parents=True, exist_ok=True)
        (dest / path).write_text(text)
    (dest / "BENCHMARK.json").write_text(json.dumps(bench))
    return bench


def workload(name: str, config: str, **engine) -> dict:
    """The workload file of the smoke cell ``name`` (:func:`cell`), naming
    ``config``, its engine options updated by ``engine``."""
    out = cell(name)
    for key in ("name", "chips", "configuration"):
        out.pop(key)
    out["config"] = config
    out["engine"].update(engine)
    return out
