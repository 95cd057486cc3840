"""phi3-mini-3.8b — dense RoPE/SwiGLU/GQA decoder.

[arXiv:2404.14219; unverified]  32L d_model=3072 32H (kv=32) d_ff=8192
vocab=32064.
"""

from repro_torch.models.config import ModelConfig

ARCH_ID = "phi3-mini-3.8b"


def config() -> ModelConfig:
    return ModelConfig(
        arch_id=ARCH_ID,
        family="dense",
        num_layers=32,
        d_model=3072,
        num_heads=32,
        num_kv_heads=32,
        d_ff=8192,
        vocab_size=32064,
        activation="swiglu",
    )


def smoke_config() -> ModelConfig:
    return config().replace(
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, d_ff=128,
        vocab_size=512, remat=False)
