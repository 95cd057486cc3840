"""zamba2-1.2b — hybrid Mamba2 backbone + shared attention blocks.

[arXiv:2411.15242; hf]  38L d_model=2048 32H (GQA kv=32) d_ff=8192
vocab=32000, ssm_state=64.  The shared attention+MLP block (one weight copy)
is applied every 6 Mamba2 layers (6 sites + 2 tail layers).
"""

from repro_torch.models.config import ModelConfig, SSMConfig

ARCH_ID = "zamba2-1.2b"


def config() -> ModelConfig:
    return ModelConfig(
        arch_id=ARCH_ID,
        family="hybrid",
        num_layers=38,
        d_model=2048,
        num_heads=32,
        num_kv_heads=32,
        d_ff=8192,
        vocab_size=32000,
        ssm=SSMConfig(state_dim=64, head_dim=64, expand=2, n_groups=1,
                      conv_kernel=4, chunk=64),
        hybrid_attn_every=6,
    )


def smoke_config() -> ModelConfig:
    return config().replace(
        num_layers=7, d_model=64, num_heads=4, num_kv_heads=4, d_ff=128,
        vocab_size=256, hybrid_attn_every=3,
        ssm=SSMConfig(state_dim=8, head_dim=16, expand=2, n_groups=1,
                      conv_kernel=4, chunk=8),
        remat=False)
