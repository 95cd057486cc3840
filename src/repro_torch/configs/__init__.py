"""Architecture registry: ``--arch <id>`` -> ModelConfig.

Each module exposes ``config()`` (the exact published configuration) and
``smoke_config()`` (a reduced same-family config for CPU tests).  Only the
architectures whose model family is ported are listed: the attention
transformers (dense, MoE, MLA, and the audio / vlm frontend stubs).
``zamba2-1.2b`` (Mamba2 + shared attention) and ``rwkv6-3b`` join with the
recurrent families (ROADMAP Queue 1 item 8b).
"""

from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig

_MODULES = {
    "gemma-7b": "repro_torch.configs.gemma_7b",
    "phi3-mini-3.8b": "repro_torch.configs.phi3_mini_3p8b",
    "internlm2-1.8b": "repro_torch.configs.internlm2_1p8b",
    "llama3-8b": "repro_torch.configs.llama3_8b",
    "deepseek-v3-671b": "repro_torch.configs.deepseek_v3_671b",
    "phi3.5-moe-42b-a6.6b": "repro_torch.configs.phi3p5_moe_42b",
    "musicgen-medium": "repro_torch.configs.musicgen_medium",
    "chameleon-34b": "repro_torch.configs.chameleon_34b",
}

#: the reference's ids whose families are not ported yet
RECURRENT_IDS = ("zamba2-1.2b", "rwkv6-3b")

ARCH_IDS = tuple(_MODULES)


def _module(arch_id: str):
    if arch_id in RECURRENT_IDS:
        raise NotImplementedError(
            f"{arch_id} is a recurrent-family architecture, not ported yet "
            f"(ROADMAP Queue 1 item 8b)")
    return importlib.import_module(_MODULES[arch_id])


def get_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).config()


def get_smoke_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).smoke_config()
