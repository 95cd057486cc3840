"""musicgen-medium — decoder-only transformer over EnCodec audio tokens.

[arXiv:2306.05284; hf]  48L d_model=1536 24H (kv=24) d_ff=6144 vocab=2048.
Backbone only per the assignment: the EnCodec frontend is a stub —
``input_specs()`` supplies precomputed frame embeddings (B, S, D); the
codebook-interleaving pattern is outside scope.
"""

from repro_torch.models.config import ModelConfig

ARCH_ID = "musicgen-medium"


def config() -> ModelConfig:
    return ModelConfig(
        arch_id=ARCH_ID,
        family="audio",
        num_layers=48,
        d_model=1536,
        num_heads=24,
        num_kv_heads=24,
        d_ff=6144,
        vocab_size=2048,
        activation="gelu",
        frontend_stub=True,
        # 24 heads don't divide the 16-way model axis: pure DP + FSDP
        dp_over_model=True,
        fsdp=True,
    )


def smoke_config() -> ModelConfig:
    return config().replace(
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, d_ff=128,
        vocab_size=256, remat=False)
