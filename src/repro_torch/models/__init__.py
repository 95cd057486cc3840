"""Model definitions: configs, dense-family transformer blocks, forward /
prefill / decode entry points (GQA attention, SwiGLU MLP, RoPE, RMSNorm)."""
