"""Optimizer: AdamW (bf16-state option), schedules, clipping, int8 gradient
compression with error feedback, and the int8 all-reduce over a mesh axis."""

from repro_torch.optim.compression import (compress_with_error_feedback,
                                           dequantize_int8, int8_psum,
                                           quantize_int8)
from repro_torch.optim.optimizer import (AdamWConfig, OptState, adamw_init,
                                         adamw_update, clip_by_global_norm,
                                         constant_schedule, cosine_schedule,
                                         global_norm, linear_schedule)

__all__ = [
    "AdamWConfig", "OptState", "adamw_init", "adamw_update",
    "clip_by_global_norm", "global_norm",
    "cosine_schedule", "linear_schedule", "constant_schedule",
    "quantize_int8", "dequantize_int8", "compress_with_error_feedback",
    "int8_psum",
]
