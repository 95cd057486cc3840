"""Gated MLPs (SwiGLU / GeGLU / GELU)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.launch import collectives as coll
from repro_torch.models.common import ParamDef, dense
from repro_torch.models.config import ModelConfig

__all__ = ["mlp_defs", "mlp_fwd"]


def mlp_defs(cfg: ModelConfig, d_ff: int | None = None) -> dict:
    d = cfg.d_model
    ff = cfg.d_ff if d_ff is None else d_ff
    defs = {
        "w_up": ParamDef((d, ff), ("embed", "mlp")),
        "w_down": ParamDef((ff, d), ("mlp", "embed")),
    }
    if cfg.activation in ("swiglu", "geglu"):
        defs["w_gate"] = ParamDef((d, ff), ("embed", "mlp"))
    return defs


def _act(cfg: ModelConfig, g: torch.Tensor) -> torch.Tensor:
    if cfg.activation == "swiglu":
        return F.silu(g)
    return F.gelu(g, approximate="tanh")


def mlp_fwd(params: dict, x: torch.Tensor, cfg: ModelConfig,
            tp=None) -> torch.Tensor:
    """The gated (or plain) MLP.  With ``tp`` (a mesh; ``common.tp_of``)
    the weights are the rank's ``model`` slice of the hidden units
    (Megatron): ``w_up`` / ``w_gate`` column-parallel, ``w_down``
    row-parallel with one ``all_reduce``."""
    if tp is not None:
        x = coll.copy_to(x, tp)
    up = dense(params["w_up"], x, cfg, name="w_up")
    if "w_gate" in params:
        gate = dense(params["w_gate"], x, cfg, name="w_gate")
        h = _act(cfg, gate) * up
    else:
        h = _act(cfg, up)
    out = dense(params["w_down"], h, cfg, name="w_down")
    return out if tp is None else coll.reduce_from(out, tp)
