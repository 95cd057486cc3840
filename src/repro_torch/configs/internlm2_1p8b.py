"""internlm2-1.8b — dense GQA decoder.

[arXiv:2403.17297; hf]  24L d_model=2048 16H (GQA kv=8) d_ff=8192 vocab=92544.
"""

from repro_torch.models.config import ModelConfig

ARCH_ID = "internlm2-1.8b"


def config() -> ModelConfig:
    return ModelConfig(
        arch_id=ARCH_ID,
        family="dense",
        num_layers=24,
        d_model=2048,
        num_heads=16,
        num_kv_heads=8,
        d_ff=8192,
        vocab_size=92544,
        activation="swiglu",
        rope_theta=1_000_000.0,
    )


def smoke_config() -> ModelConfig:
    return config().replace(
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, d_ff=128,
        vocab_size=512, remat=False)
