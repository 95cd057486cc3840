"""llama3-8b — dense GQA decoder with 128k vocab.

[arXiv:2407.21783; unverified]  32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=128256.  Closest assigned arch to the paper's own LLaMA2 sparsity study.
"""

from repro_torch.models.config import ModelConfig

ARCH_ID = "llama3-8b"


def config() -> ModelConfig:
    return ModelConfig(
        arch_id=ARCH_ID,
        family="dense",
        num_layers=32,
        d_model=4096,
        num_heads=32,
        num_kv_heads=8,
        d_ff=14336,
        vocab_size=128256,
        activation="swiglu",
        rope_theta=500_000.0,
    )


def smoke_config() -> ModelConfig:
    return config().replace(
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, d_ff=192,
        vocab_size=512, remat=False)
