"""chameleon-34b — early-fusion VLM decoder over mixed text/VQ-image tokens.

[arXiv:2405.09818; unverified]  48L d_model=8192 64H (GQA kv=8) d_ff=22016
vocab=65536.  Backbone only: the VQ image tokenizer is a stub —
``input_specs()`` supplies precomputed patch embeddings.
"""

from repro_torch.models.config import ModelConfig

ARCH_ID = "chameleon-34b"


def config() -> ModelConfig:
    return ModelConfig(
        arch_id=ARCH_ID,
        family="vlm",
        num_layers=48,
        d_model=8192,
        num_heads=64,
        num_kv_heads=8,
        d_ff=22016,
        vocab_size=65536,
        activation="swiglu",
        frontend_stub=True,
        fsdp=True,
        fsdp_inference=False,   # 68 GB bf16 / 16-way TP fits HBM replicated over data
    )


def smoke_config() -> ModelConfig:
    return config().replace(
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, d_ff=192,
        vocab_size=512, remat=False, fsdp=False)
