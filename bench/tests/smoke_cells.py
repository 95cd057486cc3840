"""Cells of the benchmark cut to sizes a CPU test run holds."""

from __future__ import annotations

import copy
import json
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
    sizes (or ``configuration``), a small engine and short traffic."""
    wl = json.loads((BENCH / "workloads" / f"{name}.json").read_text())
    cfg = configuration or port_smoke_sizes(wl["config"])
    out = copy.deepcopy(wl)
    out.update(name=name, chips=1, configuration=cfg)
    out["engine"].update(max_batch=4, page_size=4, max_seq_len=96,
                         num_pages=None)
    out["traffic"] = dict({"requests": 8, "rate": 2.0, "prompt": [9, 60],
                           "output": [6, 14], "trace_seconds": 1.0}, **traffic)
    return out
