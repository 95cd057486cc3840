"""Shared modeling primitives: param definitions, dense layers (with optional
unary-backend quantized execution), norms, embeddings.

Parameters are plain nested dicts of tensors.  Every parameter is declared
through a ``ParamDef``; one walk materializes init values on a device from an
explicit ``torch.Generator``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import threading

import torch

from repro_torch.core import packing
from repro_torch.core.quantization import quantize, quantize_per_row
from repro_torch.models.config import ModelConfig

__all__ = [
    "ParamDef", "init_tree", "dense", "rmsnorm", "embed_lookup",
    "logits_from_embedding", "dtype_of", "activation_scaling",
    "activation_scale_mode",
]

_TLS = threading.local()


# ---------------------------------------------------------------------------
# Parameter definitions
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: tuple[int, ...]
    init: str = "lecun"           # lecun | zeros | ones | normal(σ=0.02) | ssm_a | ssm_dt
    fan_in_axes: tuple[int, ...] = (0,)

    def materialize(self, generator: torch.Generator, device,
                    dtype: torch.dtype) -> torch.Tensor:
        if self.init == "zeros":
            return torch.zeros(self.shape, dtype=dtype, device=device)
        if self.init == "ones":
            return torch.ones(self.shape, dtype=dtype, device=device)
        if self.init == "ssm_a":
            # A_log init: log of [1, 16] over heads (Mamba2 convention),
            # broadcast across any leading (stacked-layer) axes
            base = torch.log(torch.linspace(1.0, 16.0, self.shape[-1],
                                            dtype=torch.float32, device=device))
            return base.expand(self.shape).to(dtype).contiguous()
        if self.init == "ssm_dt":
            # dt bias ~ softplus-inverse of a log-uniform dt in [1e-3, 1e-1]
            u = torch.rand(self.shape, generator=generator, device=device,
                           dtype=torch.float32)
            dt = torch.exp(u * (math.log(0.1) - math.log(0.001))
                           + math.log(0.001))
            return torch.log(torch.expm1(dt)).to(dtype)
        if self.init == "normal":
            scale = 0.02
        elif self.init == "lecun":
            fan_in = 1
            for a in self.fan_in_axes:
                fan_in *= self.shape[a]
            scale = 1.0 / math.sqrt(max(fan_in, 1))
        else:
            raise ValueError(f"unknown init rule {self.init!r}")
        out = torch.randn(self.shape, generator=generator, device=device,
                          dtype=torch.float32)
        return out.mul_(scale).to(dtype)


def init_tree(defs, generator: torch.Generator, device,
              dtype: torch.dtype) -> dict:
    """Materialize a (nested dict) tree of ParamDefs, walking keys in sorted
    order so a seed fixes the parameters independently of dict insertion."""
    if isinstance(defs, ParamDef):
        return defs.materialize(generator, device, dtype)
    return {k: init_tree(defs[k], generator, device, dtype)
            for k in sorted(defs)}


def dtype_of(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16,
            "float16": torch.float16}[name]


# ---------------------------------------------------------------------------
# Activation quantization granularity (backend-execution scopes)
# ---------------------------------------------------------------------------

#: Granularities ``_backend_matmul`` accepts for the activation operand.
_ACT_SCALE_MODES = ("per-tensor", "per-row")


@contextlib.contextmanager
def activation_scaling(mode: str):
    """Select the activation quantization granularity for backend execution.

    ``"per-tensor"`` (default) — one absmax scale across the whole
    activation batch, the paper's INT-inference convention; co-batched rows
    share a grid, so a request's integer codes depend on its batchmates.
    ``"per-row"`` — one scale per activation row, making each co-batched
    request's codes a pure function of its own tokens (the property the
    serving engine's identical-token-stream check needs to be a *strict*
    gate under backend execution).
    """
    if mode not in _ACT_SCALE_MODES:
        raise ValueError(f"activation scaling mode must be one of "
                         f"{_ACT_SCALE_MODES}, got {mode!r}")
    prev = getattr(_TLS, "act_scale", "per-tensor")
    _TLS.act_scale = mode
    try:
        yield
    finally:
        _TLS.act_scale = prev


def activation_scale_mode() -> str:
    """The granularity ``_backend_matmul`` quantizes activations at now."""
    return getattr(_TLS, "act_scale", "per-tensor")


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------

def dense(w: torch.Tensor, x: torch.Tensor, cfg: ModelConfig | None = None,
          name: str | None = None) -> torch.Tensor:
    """x @ w with optional unary-backend quantized execution.

    ``name`` — the weight's parameter-tree leaf key (``"wq"``, ``"w_up"``…).
    Combined with the live ``repro_torch.backends.site_scope`` stack it forms
    the GEMM's *site name* (``"layers/attn/wq"``); see the naming contract in
    ``repro_torch.backends.runtime``.

    Execution precedence:

    1. An active ``repro_torch.backends.use_backend(...)`` /
       ``use_plan(...)`` scope — the scope names the backend for this site
       (a plan may name none, and the site then runs the plain float
       matmul, never precedence 2); both operands are quantized to the
       backend's bit-width and the int tiles are contracted on the backend
       engine (simulated design or CUDA kernel), then dequantized back to
       the activation dtype.
    2. ``cfg.quant_kernel`` — the packed-integer ``quant_gemm`` kernel (the
       paper's PE array stand-in): the weight is quantized per channel at
       ``cfg.quant_bits`` at every call, activations per tensor at
       ``min(2 * quant_bits, 8)``, through ``kernels.ops.quantized_matmul``;
       with ``quant_backend="ugemm"`` activations are quantized per tensor
       at ``quant_bits`` and contracted by ``gemm_sims.ugemm_exact``
       (uGEMM's stochastic multiplier), then rescaled by the two scales in
       turn.
    3. The plain float matmul (default).
    """
    from repro_torch.backends import runtime as backend_runtime
    execution = backend_runtime.active_execution()
    if execution is not None:
        site = backend_runtime.current_site(name)
        backend = execution.backend_for(site)
        if backend is not None:
            return _backend_matmul(execution, backend, site, w, x)
        k = w.shape[0]
        execution.observe(site, m=math.prod(x.shape[:-1]), k=k,
                          n_out=math.prod(w.shape) // k)
        # A live scope owns execution: sites its plan leaves unmatched run
        # FLOAT, never the cfg.quant_kernel path, which would mix a second
        # quantization scheme into the plan's evidence.
        return _plain_matmul(x, w)
    if cfg is not None and cfg.quant_bits is not None and cfg.quant_kernel:
        if packing.is_packed(w):
            raise TypeError(
                "cfg.quant_kernel re-quantizes at cfg.quant_bits, which "
                "would round already-packed codes a second time — execute "
                "packed stores under use_backend at the store's width, or "
                "keep float parameters for the quant-kernel path")
        from repro_torch.kernels import ops as kops
        w2 = w.reshape(w.shape[0], -1) if w.ndim > 2 else w
        wq = quantize(w2.to(torch.float32), bits=cfg.quant_bits)
        if cfg.quant_backend == "ugemm":
            from repro_torch.core import gemm_sims
            xq = quantize(x.reshape(-1, x.shape[-1]).to(torch.float32),
                          bits=cfg.quant_bits, per_channel=False)
            out = gemm_sims.ugemm_exact(xq.values, wq.values,
                                        bits=cfg.quant_bits)
            out = (out * xq.scale * wq.scale.reshape(1, -1)).to(x.dtype)
        else:
            out = kops.quantized_matmul(x, wq,
                                        act_bits=min(cfg.quant_bits * 2, 8))
        return out.reshape(*x.shape[:-1], *w.shape[1:])
    return _plain_matmul(x, w)


def _weight_codes(execution, backend, w2: torch.Tensor):
    """Per-channel codes of a ``(k, n)`` weight at the backend's width.

    Quantized at every call, exactly like the reference — unless the scope
    carries a ``weight_cache`` dict (the serving engine's does), in which
    case each distinct weight storage is quantized once and the identical
    codes and scales are reused.  An entry holds the weight view beside its
    codes, so the storage the key names cannot be freed and its address
    handed to another tensor while the cache lives; parameters must not be
    written in place meanwhile.  Under a PE-array grid backend the cached
    codes are the grid's contiguous shard blocks
    (:class:`~repro_torch.backends.grid.ShardedCodes`; on a rank of a
    distributed grid the rank's own block), in place of the flat matrix.
    """
    cache = execution.weight_cache
    if cache is None:
        return quantize(w2.to(torch.float32), bits=backend.bits)
    grid = getattr(backend, "grid", None)
    key = (w2.data_ptr(), tuple(w2.shape), w2.dtype, backend.bits)
    if grid is not None:
        # a rank of a distributed grid caches its own shard only
        mesh = backend.mesh()
        key += (grid, None if mesh is None else mesh.rank)
    entry = cache.get(key)
    if entry is None:
        wq = quantize(w2.to(torch.float32), bits=backend.bits)
        if grid is not None:
            # a grid keeps its shards' contiguous blocks in place of the
            # flat codes, so no call re-cuts (copies) the weight's bands
            wq = dataclasses.replace(wq, values=backend.shard_codes(wq.values))
        entry = cache[key] = (w2, wq)
    return entry[1]


def _backend_matmul(execution, backend, site: str, w: torch.Tensor,
                    x: torch.Tensor) -> torch.Tensor:
    """Contract ``x @ w`` on ``backend`` as integer tiles.

    Both operands are quantized at the backend's bit-width — weights per
    output channel, activations per tensor by default or per row under
    ``activation_scaling("per-row")``; the integer result is rescaled by
    both quantization scales and cast back to the activation dtype.  The
    two dequant scales are applied sequentially (one multiply per port), in
    the reference's order: a pre-multiplied scale product rounds differently.

    A :class:`~repro_torch.core.packing.PackedQuantized` weight skips the
    weight quantize: its store holds exactly the codes and scales
    ``quantize`` produced at pack time — iff the store's width matches the
    backend's; a mismatch raises rather than re-quantizing.
    """
    x2 = x.reshape(-1, x.shape[-1])
    if packing.is_packed(w):
        if int(w.bits) != int(backend.bits):
            raise ValueError(
                f"site {site!r}: packed store holds {w.bits}-bit codes but "
                f"the backend executes at {backend.bits}-bit — re-quantizing "
                f"packed codes at a second width compounds quantization "
                f"error; repack from the float parameters "
                f"(packed-width-mismatch)")
        wq = w.quantized()
        k, n_out = w.k, w.n_out
    else:
        w2 = w.reshape(w.shape[0], -1) if w.ndim > 2 else w
        wq = _weight_codes(execution, backend, w2)
        k, n_out = w2.shape[0], w2.shape[1]
    if activation_scale_mode() == "per-row":
        xq = quantize_per_row(x2.to(torch.float32), bits=backend.bits)
    else:
        xq = quantize(x2.to(torch.float32), bits=backend.bits,
                      per_channel=False)
    acc = backend.execute(xq.values, wq.values)
    out = acc.to(torch.float32) * xq.scale * wq.scale.reshape(1, -1)
    execution.record(site, m=x2.shape[0], k=k, n_out=n_out, backend=backend,
                     out=acc)
    return out.to(x.dtype).reshape(*x.shape[:-1], *w.shape[1:])


def _plain_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    if packing.is_packed(w):
        # float path over a packed leaf: dequantize the stored codes, the
        # only float matrix the codes can honestly reconstruct
        w = w.dequantize()
    wshape = w.shape
    w2 = w.reshape(wshape[0], -1)
    y = torch.matmul(x, w2.to(x.dtype))
    return y.reshape(*x.shape[:-1], *wshape[1:])


def rmsnorm(scale: torch.Tensor, x: torch.Tensor, eps: float = 1e-5,
            gemma_style: bool = False) -> torch.Tensor:
    """RMS norm, computed in float32 inside and cast back to ``x.dtype``."""
    dt = x.dtype
    x32 = x.to(torch.float32)
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    s = scale.to(torch.float32)
    y = y * (1.0 + s) if gemma_style else y * s
    return y.to(dt)


def embed_lookup(table: torch.Tensor, ids: torch.Tensor,
                 compute_dtype: torch.dtype) -> torch.Tensor:
    return table[ids.long()].to(compute_dtype)


def logits_from_embedding(table: torch.Tensor, x: torch.Tensor,
                          softcap: float | None = None) -> torch.Tensor:
    logits = torch.matmul(x, table.to(x.dtype).transpose(0, 1))
    if softcap is not None:
        logits = torch.tanh(logits / softcap) * softcap
    return logits
