"""gemma-7b — dense GeGLU decoder, head_dim 256, huge 256k vocab.

[arXiv:2403.08295; hf]  28L d_model=3072 16H (kv=16) d_ff=24576 vocab=256000.
Tied embeddings with sqrt(d_model) input scaling (Gemma convention).
"""

from repro_torch.models.config import ModelConfig

ARCH_ID = "gemma-7b"


def config() -> ModelConfig:
    return ModelConfig(
        arch_id=ARCH_ID,
        family="dense",
        num_layers=28,
        d_model=3072,
        num_heads=16,
        num_kv_heads=16,
        head_dim=256,
        d_ff=24576,
        vocab_size=256_000,
        activation="geglu",
        tie_embeddings=True,
        scale_embeddings=True,
    )


def smoke_config() -> ModelConfig:
    return config().replace(
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
        d_ff=256, vocab_size=512, remat=False)
