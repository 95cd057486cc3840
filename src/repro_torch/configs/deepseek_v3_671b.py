"""deepseek-v3-671b — MoE (1 shared + 256 routed, top-8) with MLA.

[arXiv:2412.19437; hf]  61L d_model=7168 128H d_ff(expert)=2048 vocab=129280.
MLA: q_lora 1536, kv_lora 512, rope/nope head dims 64/128, v 128.
Simplifications noted in DESIGN.md: all layers are MoE (the release uses 3
dense warm-up layers) and MTP heads are not modeled.
"""

from repro_torch.models.config import MLAConfig, ModelConfig, MoEConfig

ARCH_ID = "deepseek-v3-671b"


def config() -> ModelConfig:
    return ModelConfig(
        arch_id=ARCH_ID,
        family="moe",
        num_layers=61,
        d_model=7168,
        num_heads=128,
        num_kv_heads=128,
        head_dim=128,
        d_ff=2048,
        vocab_size=129280,
        attention="mla",
        activation="swiglu",
        mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512, rope_head_dim=64,
                      nope_head_dim=128, v_head_dim=128),
        moe=MoEConfig(num_experts=256, top_k=8, num_shared_experts=1,
                      d_ff_expert=2048, capacity_factor=1.25),
        fsdp=True,   # 671B params: optimizer state must shard over data too
    )


def smoke_config() -> ModelConfig:
    return config().replace(
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
        vocab_size=512, remat=False, fsdp=False,
        mla=MLAConfig(q_lora_rank=32, kv_lora_rank=16, rope_head_dim=8,
                      nope_head_dim=16, v_head_dim=16),
        moe=MoEConfig(num_experts=8, top_k=2, num_shared_experts=1,
                      d_ff_expert=64, capacity_factor=2.0))
