"""rwkv6-3b ("Finch") — attention-free RNN with data-dependent decay.

[arXiv:2404.05892; hf]  32L d_model=2560 d_ff=8960 vocab=65536, head_dim 64.
O(1)-state decode makes the long_500k shape runnable.
"""

from repro_torch.models.config import ModelConfig, RWKVConfig

ARCH_ID = "rwkv6-3b"


def config() -> ModelConfig:
    return ModelConfig(
        arch_id=ARCH_ID,
        family="ssm",
        attention="none",
        num_layers=32,
        d_model=2560,
        num_heads=40,           # d_model / head_dim (bookkeeping only)
        num_kv_heads=40,
        d_ff=8960,
        vocab_size=65536,
        rwkv=RWKVConfig(head_dim=64, decay_lora=64),
        # 40 heads don't divide the 16-way model axis: run pure DP over the
        # whole mesh with FSDP (see DESIGN.md §Arch-applicability)
        dp_over_model=True,
        fsdp=True,
    )


def smoke_config() -> ModelConfig:
    return config().replace(
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, d_ff=128,
        vocab_size=512, remat=False,
        rwkv=RWKVConfig(head_dim=16, decay_lora=8))
