"""Shared modeling primitives: param definitions and their sharding rules,
dense layers (with optional unary-backend quantized execution), norms,
embeddings.

Parameters are plain nested dicts of tensors.  Every parameter is declared
through a ``ParamDef`` carrying its *logical axes*; one walk materializes
init values on a device from an explicit ``torch.Generator``, another maps
the logical axes to mesh axes (:func:`pspec_tree`) by the reference's rules
(:data:`DEFAULT_RULES`, :func:`rules_for`).  A "pspec" is a plain tuple with
one entry a dimension: ``None`` (replicated), a mesh-axis name, or a tuple of
names, over ``launch.mesh.Mesh``.

Under :func:`sharding` (the step builders enter it on a distributed mesh)
each rank holds its own slice of every leaf; :func:`materialize` gathers the
slices a module cannot use as they are, just before use.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import threading

import torch

from repro_torch.core import packing
from repro_torch.core.quantization import quantize, quantize_per_row
from repro_torch.launch import collectives as coll
from repro_torch.models.config import ModelConfig
from repro_torch.runtime import spans

__all__ = [
    "ParamDef", "init_tree", "dense", "rmsnorm", "embed_lookup",
    "logits_from_embedding", "dtype_of", "activation_scaling",
    "activation_scale_mode", "DEFAULT_RULES", "rules_for",
    "shardable_batch_axes", "logical_to_pspec", "pspec_tree", "Sharding",
    "tp_of", "materialize", "TP_LEAVES",
]

_TLS = threading.local()


# ---------------------------------------------------------------------------
# Logical axis rules
# ---------------------------------------------------------------------------

#: logical axis name -> mesh axis (or tuple of axes), the reference's table
DEFAULT_RULES: dict[str, object] = {
    "batch": ("pod", "data"),
    "seq": None,
    "kv_seq": "model",        # decode-time KV cache sequence sharding
    "embed": None,
    "fsdp_embed": "data",     # embed axis when cfg.fsdp is on
    "heads": "model",
    "qkv": None,
    "kv_heads": None,         # kv heads usually < model-axis size: replicate
    "head_dim": None,
    "mlp": "model",
    "vocab": "model",
    "experts": "model",
    "expert_mlp": None,
    "layers": None,
    "conv": None,
    "state": None,
    "lora": None,
}


def rules_for(cfg: ModelConfig) -> dict[str, object]:
    """The rules of ``cfg``: ``embed`` over ``data`` under ``cfg.fsdp``; under
    ``cfg.dp_over_model`` heads, mlp and vocab replicate and the batch splits
    over ``(data, model, pod)`` (``pod`` last, so the divisibility filter
    spends the batch on data x model first)."""
    rules = dict(DEFAULT_RULES)
    if cfg.fsdp:
        rules["embed"] = "data"
    if cfg.dp_over_model:
        rules["batch"] = ("data", "model", "pod")
        rules["heads"] = None
        rules["mlp"] = None
        rules["vocab"] = None
    return rules


def shardable_batch_axes(mesh, batch_size: int,
                         candidates=("pod", "data")) -> tuple[str, ...]:
    """The candidate axes, in order, whose running product divides
    ``batch_size`` (an axis that does not is skipped)."""
    if isinstance(candidates, str):
        candidates = (candidates,)
    keep: list[str] = []
    prod = 1
    for a in candidates or ():
        if a in mesh.axes and batch_size % (prod * mesh.axis_size(a)) == 0:
            keep.append(a)
            prod *= mesh.axis_size(a)
    return tuple(keep)


def logical_to_pspec(logical, rules: dict[str, object],
                     mesh_axes: tuple[str, ...],
                     shape: tuple[int, ...] | None = None,
                     mesh_shape: dict[str, int] | None = None) -> tuple:
    """Map logical axis names to a pspec (one entry a dimension).

    With ``shape`` and ``mesh_shape``, a mesh axis whose size does not
    divide its dimension is dropped (40 RWKV heads on a 16-way ``model``
    axis replicate); a mesh axis serves one dimension at most.
    """
    spec = []
    used: set[str] = set()
    for i, name in enumerate(logical):
        axis = rules.get(name) if name else None
        if axis is None:
            spec.append(None)
            continue
        axes = tuple(a for a in (axis if isinstance(axis, (tuple, list))
                                 else (axis,))
                     if a in mesh_axes and a not in used)
        if shape is not None and mesh_shape is not None:
            kept = []
            prod = 1
            for a in axes:
                if shape[i] % (prod * mesh_shape[a]) == 0:
                    kept.append(a)
                    prod *= mesh_shape[a]
            axes = tuple(kept)
        used.update(axes)
        spec.append(None if not axes else axes[0] if len(axes) == 1 else axes)
    return tuple(spec)


def pspec_tree(defs, rules: dict[str, object], mesh_axes: tuple[str, ...],
               mesh_shape: dict[str, int] | None = None):
    """The pspec of every ``ParamDef`` of a (nested dict) tree."""
    if isinstance(defs, ParamDef):
        return logical_to_pspec(defs.axes, rules, mesh_axes, shape=defs.shape,
                                mesh_shape=mesh_shape)
    return {k: pspec_tree(v, rules, mesh_axes, mesh_shape)
            for k, v in defs.items()}


# ---------------------------------------------------------------------------
# Parameter definitions
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: tuple[int, ...]
    logical: tuple[str | None, ...] | None = None   # None: all replicated
    init: str = "lecun"           # lecun | zeros | ones | normal(σ=0.02) | ssm_a | ssm_dt
    fan_in_axes: tuple[int, ...] = (0,)

    @property
    def axes(self) -> tuple[str | None, ...]:
        """The logical axis of every dimension."""
        return (self.logical if self.logical is not None
                else (None,) * len(self.shape))

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
# Sharded execution: each rank holds its slices of the parameters
# ---------------------------------------------------------------------------

#: (parent key, leaf) of the leaves whose ``model`` slice a module uses as it
#: is (Megatron tensor parallelism, expert parallelism); every other sharded
#: dimension is gathered before use.  Top-level leaves have parent None.
TP_LEAVES = frozenset({
    ("attn", "wq"), ("attn", "wo"), ("attn", "w_uq"), ("attn", "w_uk"),
    ("attn", "w_uv"), ("mlp", "w_up"), ("mlp", "w_gate"), ("mlp", "w_down"),
    ("shared", "w_up"), ("shared", "w_gate"), ("shared", "w_down"),
    ("moe", "w_gate"), ("moe", "w_up"), ("moe", "w_down"),
    (None, "embed"), (None, "lm_head")})
#: a cached call (prefill, decode) gathers the MLA up-projections: the
#: absorbed form reads every head of them
CACHED_GATHERED = frozenset({("attn", "w_uq"), ("attn", "w_uk"),
                             ("attn", "w_uv")})


@dataclasses.dataclass(frozen=True, eq=False)
class Sharding:
    """How a rank's parameter slices lie on a distributed ``mesh``.  The
    model's functions take it as ``sh=`` (None: whole parameters, one
    device); every leaf they are handed is then the rank's slice by its
    pspec (``model.shard_params``).

    ``specs`` — the pspec of every leaf of the whole model (``model``'s
    ``param_pspecs``, a packed store's module replicated); ``shapes`` — the
    whole shapes, same tree; ``batch_axes`` — the mesh axes the batch rows
    split over, in order; ``layer_specs`` — the stacked layers' pspecs
    without their layer axis.
    """

    mesh: object
    specs: dict
    shapes: dict
    batch_axes: tuple[str, ...] = ()
    layer_specs: dict | None = None

    @property
    def batch_shards(self) -> int:
        return math.prod(self.mesh.axis_size(a) for a in self.batch_axes)

    def batch_index(self) -> int:
        """This rank's block of batch rows (row-major over ``batch_axes``)."""
        i = 0
        for a in self.batch_axes:
            i = i * self.mesh.axis_size(a) + self.mesh.axis_index(a)
        return i


def tp_of(sh: Sharding | None, axis):
    """The mesh whose ``model`` ranks each hold a slice of a dimension laid
    out on mesh axis ``axis`` (a pspec entry) — tensor parallelism — else
    None."""
    if sh is None or axis != "model" or sh.mesh.axis_size("model") == 1:
        return None
    return sh.mesh


def materialize(tree, specs, sh: Sharding | None, *, cached: bool = False,
                path=()):
    """``tree`` (the rank's slices) with every sharded dimension gathered
    over its mesh axis, but the ``model`` slices of :data:`TP_LEAVES`, which
    the modules use as they are.  ``specs`` is the matching subtree of
    ``sh``'s (a stacked leaf's without the layer axis).  A gather over a
    batch axis reduce-scatters the gradient; over another axis the rank
    keeps its own slice of it.  Packed stores replicate, as the reference's
    ``adapt_param_pspecs`` has them.
    """
    if sh is None:
        return tree
    if isinstance(tree, dict):
        return {k: materialize(v, specs[k], sh, cached=cached,
                               path=path + (k,)) for k, v in tree.items()}
    if packing.is_packed(tree):
        return tree
    key = (path[-2] if len(path) > 1 else None, path[-1])
    keep_model = key in TP_LEAVES and not (cached and key in CACHED_GATHERED)
    for d, axis in enumerate(specs):
        if axis is None or (axis == "model" and keep_model):
            continue
        tree = coll.gather(tree, sh.mesh, axis, d,
                           reduce_grad=axis in sh.batch_axes)
    return tree


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
    with spans.span("dense"):
        x2 = x.reshape(-1, x.shape[-1])
        if packing.is_packed(w):
            if int(w.bits) != int(backend.bits):
                raise ValueError(
                    f"site {site!r}: packed store holds {w.bits}-bit codes "
                    f"but the backend executes at {backend.bits}-bit — "
                    f"re-quantizing packed codes at a second width compounds "
                    f"quantization error; repack from the float parameters "
                    f"(packed-width-mismatch)")
            wq = w.quantized()
            k, n_out = w.k, w.n_out
        else:
            w2 = w.reshape(w.shape[0], -1) if w.ndim > 2 else w
            wq = _weight_codes(execution, backend, w2)
            k, n_out = w2.shape[0], w2.shape[1]
        with spans.span("dense.quantize"):
            if activation_scale_mode() == "per-row":
                xq = quantize_per_row(x2.to(torch.float32), bits=backend.bits)
            else:
                xq = quantize(x2.to(torch.float32), bits=backend.bits,
                              per_channel=False)
        with spans.span("dense.gemm"):
            acc = backend.execute(xq.values, wq.values)
        with spans.span("dense.dequantize"):
            out = (acc.to(torch.float32) * xq.scale
                   * wq.scale.reshape(1, -1)).to(x.dtype)
        execution.record(site, m=x2.shape[0], k=k, n_out=n_out,
                         backend=backend, out=acc)
    return out.reshape(*x.shape[:-1], *w.shape[1:])


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
