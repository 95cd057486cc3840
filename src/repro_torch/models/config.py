"""Model configuration covering all assigned architecture families.

One dataclass drives dense / MoE / SSM / hybrid assembly, attention flavor
(GQA vs. MLA), activation flavor, quantized-GEMM backend selection, and the
sharding/remat knobs the distribution layer consumes.
"""

from __future__ import annotations

import dataclasses
from typing import Literal

__all__ = ["ModelConfig", "MoEConfig", "SparseMixerMoEConfig", "MLAConfig",
           "SSMConfig", "RWKVConfig"]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 16
    top_k: int = 2
    num_shared_experts: int = 0      # DeepSeek-style always-on experts
    d_ff_expert: int = 2048
    capacity_factor: float = 1.25
    router_noise: float = 0.0
    # "psum" = every model-rank computes its local experts for all tokens and
    # the results are all-reduced (baseline).  "a2a" = all-to-all dispatch
    # (optimized variant, see EXPERIMENTS.md §Perf).
    ep_impl: Literal["psum", "a2a"] = "psum"


@dataclasses.dataclass(frozen=True)
class SparseMixerMoEConfig(MoEConfig):
    """An MoE whose serving expert layer (``moe.moe_serve``) routes by
    Phi-3.5-MoE's sparsemixer, top-2 at inference, its band
    ``router_noise`` (the published router_jitter_noise); a plain
    :class:`MoEConfig` routes by softmax top-k.  ``moe_fwd`` (forward and
    training) routes every MoE by softmax."""


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    rope_head_dim: int = 64
    nope_head_dim: int = 128
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    state_dim: int = 64          # N
    head_dim: int = 64           # P
    expand: int = 2              # d_inner = expand * d_model
    n_groups: int = 1            # B/C groups (G)
    conv_kernel: int = 4
    chunk: int = 256             # SSD chunk length
    dt_min: float = 0.001
    dt_max: float = 0.1


@dataclasses.dataclass(frozen=True)
class RWKVConfig:
    head_dim: int = 64
    decay_lora: int = 64         # rank of the data-dependent decay LoRA
    ffn_mult_key: float = 1.0    # channel-mix sizing handled via d_ff


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    arch_id: str = "custom"
    family: Literal["dense", "moe", "ssm", "hybrid", "audio", "vlm"] = "dense"

    num_layers: int = 4
    d_model: int = 256
    num_heads: int = 4
    num_kv_heads: int = 4
    head_dim: int | None = None          # default d_model // num_heads
    d_ff: int = 1024
    vocab_size: int = 1024

    attention: Literal["gqa", "mla", "none"] = "gqa"
    activation: Literal["swiglu", "geglu", "gelu"] = "swiglu"
    tie_embeddings: bool = False
    scale_embeddings: bool = False       # gemma-style sqrt(d_model) scaling
    rope_theta: float = 10000.0
    rms_eps: float = 1e-5
    logit_softcap: float | None = None   # gemma-style

    moe: MoEConfig | None = None
    mla: MLAConfig | None = None
    ssm: SSMConfig | None = None
    rwkv: RWKVConfig | None = None

    # hybrid (zamba2-style): a shared attention+MLP block applied every
    # ``hybrid_attn_every`` SSM layers with shared weights.
    hybrid_attn_every: int = 6

    # modality frontend stubs ([audio]/[vlm]): input_specs() provides
    # precomputed frame/patch embeddings of this dim instead of token ids.
    frontend_stub: bool = False

    # numerics / execution
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    remat: bool = True
    scan_layers: bool = True

    # distribution
    fsdp: bool = False                    # shard params over the data axis too
    # keep FSDP sharding at inference?  False = replicate weights over 'data'
    # for serving (kills the per-step FSDP all-gathers) — only for models
    # that fit HBM when sharded over 'model' alone (chameleon yes, 671B no)
    fsdp_inference: bool = True
    # pure DP across the whole mesh (batch also over 'model'; no TP) — for
    # archs whose head counts don't divide the model axis (rwkv6, musicgen)
    dp_over_model: bool = False
    # quantized-GEMM backend (the paper's technique as a first-class feature)
    quant_bits: int | None = None         # None = float path
    quant_backend: str = "tubgemm"        # priced by core.ppa / accounting
    quant_kernel: bool = False            # execute via kernels.quantized_matmul

    # sub-quadratic? (drives long_500k applicability)
    @property
    def subquadratic(self) -> bool:
        return self.family in ("ssm", "hybrid")

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.num_heads

    @property
    def is_moe(self) -> bool:
        return self.moe is not None

    @property
    def uses_attention(self) -> bool:
        return self.attention != "none"

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)
