"""Architecture registry: ``--arch <id>`` -> ModelConfig.

Each module exposes ``config()`` (the exact published configuration) and
``smoke_config()`` (a reduced same-family config for CPU tests).  Only the
architectures whose model family is ported are listed; the remaining ids
of the reference registry join as their families are ported.
"""

from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig

_MODULES = {
    "llama3-8b": "repro_torch.configs.llama3_8b",
}

ARCH_IDS = tuple(_MODULES)


def get_config(arch_id: str) -> ModelConfig:
    return importlib.import_module(_MODULES[arch_id]).config()


def get_smoke_config(arch_id: str) -> ModelConfig:
    return importlib.import_module(_MODULES[arch_id]).smoke_config()
