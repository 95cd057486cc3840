"""phi3.5-moe-42b-a6.6b — 16-expert top-2 MoE decoder.

[hf:microsoft/Phi-3.5-MoE-instruct; hf]  32L d_model=4096 32H (GQA kv=8)
d_ff(expert)=6400 vocab=32064, 16 experts top-2.
"""

from repro_torch.models.config import ModelConfig, MoEConfig

ARCH_ID = "phi3.5-moe-42b-a6.6b"


def config() -> ModelConfig:
    return ModelConfig(
        arch_id=ARCH_ID,
        family="moe",
        num_layers=32,
        d_model=4096,
        num_heads=32,
        num_kv_heads=8,
        d_ff=6400,
        vocab_size=32064,
        activation="swiglu",
        moe=MoEConfig(num_experts=16, top_k=2, d_ff_expert=6400,
                      capacity_factor=1.25),
    )


def smoke_config() -> ModelConfig:
    return config().replace(
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
        vocab_size=512, remat=False,
        moe=MoEConfig(num_experts=4, top_k=2, d_ff_expert=64,
                      capacity_factor=2.0))
