"""Architecture registry: ``--arch <id>`` -> ModelConfig.

Each module exposes ``config()`` (the exact published configuration) and
``smoke_config()`` (a reduced same-family config for CPU tests).
"""

from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig

_MODULES = {
    "zamba2-1.2b": "repro_torch.configs.zamba2_1p2b",
    "gemma-7b": "repro_torch.configs.gemma_7b",
    "phi3-mini-3.8b": "repro_torch.configs.phi3_mini_3p8b",
    "internlm2-1.8b": "repro_torch.configs.internlm2_1p8b",
    "llama3-8b": "repro_torch.configs.llama3_8b",
    "deepseek-v3-671b": "repro_torch.configs.deepseek_v3_671b",
    "phi3.5-moe-42b-a6.6b": "repro_torch.configs.phi3p5_moe_42b",
    "rwkv6-3b": "repro_torch.configs.rwkv6_3b",
    "musicgen-medium": "repro_torch.configs.musicgen_medium",
    "chameleon-34b": "repro_torch.configs.chameleon_34b",
}

ARCH_IDS = tuple(_MODULES)

# (arch x shape) grid: seq_len, global_batch, and which step each shape lowers.
SHAPES = {
    "train_4k": dict(seq_len=4096, global_batch=256, step="train"),
    "prefill_32k": dict(seq_len=32768, global_batch=32, step="prefill"),
    "decode_32k": dict(seq_len=32768, global_batch=128, step="decode"),
    "long_500k": dict(seq_len=524288, global_batch=1, step="decode"),
}


def get_config(arch_id: str) -> ModelConfig:
    return importlib.import_module(_MODULES[arch_id]).config()


def get_smoke_config(arch_id: str) -> ModelConfig:
    return importlib.import_module(_MODULES[arch_id]).smoke_config()


def shape_applicable(cfg: ModelConfig, shape_name: str) -> bool:
    """long_500k needs sub-quadratic sequence mixing (the recurrent
    families' O(1)-state decode)."""
    if shape_name == "long_500k":
        return cfg.subquadratic
    return True


def cells(include_skipped: bool = False):
    """All (arch_id, shape_name) cells."""
    out = []
    for a in ARCH_IDS:
        cfg = get_config(a)
        for s in SHAPES:
            if include_skipped or shape_applicable(cfg, s):
                out.append((a, s))
    return out
