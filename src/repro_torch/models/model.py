"""Top-level language model: embeddings -> layer stack -> norm -> logits.

Entry points:
  * ``forward``       — logits for a full sequence (prefill without caches)
  * ``prefill``       — forward + populated KV caches
  * ``decode_step``   — one token with caches
  * ``loss_fn``       — mean next-token cross-entropy (training)
plus parameter/cache initialization and ``params_from_numpy``, which adopts
the reference package's parameter tree (same keys, same stacked ``(L, ...)``
layout) so both implementations can run on identical weights.

On a distributed mesh (``launch.mesh``) a rank holds its own slice of what
the reference shards: :func:`init_caches` with ``mesh=`` builds the rank's
cache slice (its batch rows over ``data``, its sequence positions over
``model``), and :func:`rank_params` keeps the rank's experts of a MoE tree.
Every other parameter stays replicated.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.models import blocks as blocks_lib
from repro_torch.models.common import (ParamDef, dense, dtype_of,
                                       embed_lookup, init_tree,
                                       logits_from_embedding, rmsnorm)
from repro_torch.models.config import ModelConfig

__all__ = [
    "model_defs", "init_params", "params_from_numpy", "forward", "prefill",
    "decode_step", "init_caches", "count_params", "embed_in", "logits_out",
    "require_device", "loss_fn", "batch_shards", "rank_params",
]


def require_device(device) -> torch.device:
    """Resolve ``device``; a CUDA device must actually be present.

    Entry points default to ``"cuda"`` and never fall back to the CPU on
    their own: callers that want the CPU (the tests) say so.
    """
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' requested but torch.cuda.is_available() is False; "
            "pass device='cpu' explicitly to run on the CPU")
    return device


def model_defs(cfg: ModelConfig) -> dict:
    defs: dict = {
        "embed": ParamDef((cfg.vocab_size, cfg.d_model), init="normal"),
        "final_norm": ParamDef((cfg.d_model,), init="ones"),
        "layers": blocks_lib.stacked_layer_defs(cfg),
    }
    if cfg.family == "hybrid":
        defs["shared"] = blocks_lib.shared_attn_defs(cfg)
    if not cfg.tie_embeddings:
        defs["lm_head"] = ParamDef((cfg.d_model, cfg.vocab_size))
    return defs


def init_params(cfg: ModelConfig, generator: torch.Generator | None = None,
                device="cuda") -> dict:
    """Seeded random parameters drawn on ``device``.

    Same init rules as the reference (``normal`` σ=0.02 embeddings, ``ones``
    norms, LeCun-normal matrices) from a ``torch.Generator`` living on the
    device; the numbers differ from the reference's PRNG by construction —
    use :func:`params_from_numpy` where the two must share weights.
    """
    device = require_device(device)
    if generator is None:
        generator = torch.Generator(device=device)
        generator.manual_seed(0)
    return init_tree(model_defs(cfg), generator, device,
                     dtype_of(cfg.param_dtype))


def params_from_numpy(tree, device="cuda", dtype: torch.dtype | None = None):
    """Nested dicts of numpy arrays -> nested dicts of tensors on ``device``.

    Same keys and the same stacked ``(L, ...)`` layout, so the conversion is
    a plain copy.  ``dtype`` overrides the arrays' own floating dtype.
    """
    device = require_device(device)

    def convert(node):
        if isinstance(node, dict):
            return {k: convert(v) for k, v in node.items()}
        t = torch.from_numpy(np.array(node))    # a copy the port owns
        if dtype is not None and t.is_floating_point():
            t = t.to(dtype)
        return t.to(device)

    return convert(tree)


def _embed_in(params, cfg: ModelConfig, tokens=None, embeds=None):
    compute = dtype_of(cfg.compute_dtype)
    if embeds is not None:
        x = embeds.to(compute)
    else:
        x = embed_lookup(params["embed"], tokens, compute)
    if cfg.scale_embeddings:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=torch.float32,
                             device=x.device).to(compute)
    return x


def _logits_out(params, cfg: ModelConfig, x):
    x = rmsnorm(params["final_norm"], x, cfg.rms_eps)
    if cfg.tie_embeddings:
        # tied head: the transposed-embedding matmul stays float (backend
        # scopes cover weight-stationary GEMM sites)
        return logits_from_embedding(params["embed"], x, cfg.logit_softcap)
    from repro_torch.backends import runtime as backend_runtime
    if backend_runtime.active_execution() is not None:
        # "lm_head" is a dense site only under a backend scope; outside any
        # scope the head keeps its plain-float matmul
        logits = dense(params["lm_head"], x, cfg, name="lm_head")
    else:
        logits = torch.matmul(x, params["lm_head"].to(x.dtype))
    if cfg.logit_softcap is not None:
        logits = torch.tanh(logits / cfg.logit_softcap) * cfg.logit_softcap
    return logits


# Public aliases: the serving engine drives its own ragged paged decode loop
# over the layer stack but must share the embedding/head math with
# decode_step *exactly* — its paged-vs-contiguous probe compares full logits.
embed_in = _embed_in
logits_out = _logits_out


def forward(params: dict, cfg: ModelConfig, tokens=None, *, embeds=None,
            positions=None):
    """Full-sequence logits.  Returns (logits (B,S,V), aux_loss)."""
    x = _embed_in(params, cfg, tokens, embeds)
    if positions is None:
        positions = torch.arange(x.shape[1], device=x.device)[None, :]
    x, _, aux = blocks_lib.stack_fwd(params, x, cfg, positions=positions)
    return _logits_out(params, cfg, x), aux


def batch_shards(mesh, batch: int) -> int:
    """How many ``data`` ranks split a batch of ``batch`` rows under a
    distributed ``mesh``: the ``data`` size when it divides the batch, else
    1 (the batch is replicated), as the reference's ``shardable_batch_axes``
    decides.  A ``pod`` axis above 1 is not served here."""
    if mesh is None or not mesh.distributed:
        return 1
    if "pod" in mesh.axes and mesh.axis_size("pod") > 1:
        raise NotImplementedError("a serving mesh with a pod axis above 1")
    if "data" not in mesh.axes:
        return 1
    n = mesh.axis_size("data")
    return n if batch % n == 0 else 1


def init_caches(cfg: ModelConfig, batch: int, max_len: int,
                dtype: torch.dtype = torch.bfloat16, device="cuda",
                mesh=None) -> dict:
    """Zeroed stacked caches of ``batch`` sequences of ``max_len``.

    With a distributed ``mesh``, this rank's slice: its ``batch /
    batch_shards`` rows and, where the mesh shards the sequence
    (``attention.seq_shards``), its ``max_len / n`` positions.  The
    reference replicates a cache whose length the ``model`` size does not
    divide; here that raises.
    """
    if mesh is not None:
        from repro_torch.models.attention import seq_shards
        n_seq = seq_shards(cfg, mesh)
        if max_len % n_seq:
            raise ValueError(f"a cache of {max_len} positions does not split "
                             f"over {n_seq} model ranks")
        batch //= batch_shards(mesh, batch)
        max_len //= n_seq
    return blocks_lib.init_layer_caches(cfg, batch, max_len, dtype,
                                        require_device(device))


def rank_params(params: dict, cfg: ModelConfig, mesh) -> dict:
    """This rank's parameter tree: a MoE tree keeps the rank's
    ``E / n`` experts of each stacked expert leaf (``moe.ep_shards``; a
    copy, so the whole stack can be freed), everything else as given."""
    from repro_torch.models import moe as moe_lib
    n = moe_lib.ep_shards(cfg, mesh) if cfg.is_moe else 1
    if n == 1:
        return params
    e_local = cfg.moe.num_experts // n
    r = mesh.axis_index("model")
    moe = dict(params["layers"]["moe"])
    for name in moe_lib.EXPERT_LEAVES:
        moe[name] = moe[name][:, r * e_local:(r + 1) * e_local].clone()
    return {**params, "layers": {**params["layers"], "moe": moe}}


def prefill(params: dict, cfg: ModelConfig, tokens=None, *, caches,
            embeds=None):
    """Populate caches (in place) from a prompt: KV, recurrent states, conv
    tails and token-shift buffers.  Returns (logits, caches)."""
    x = _embed_in(params, cfg, tokens, embeds)
    s = x.shape[1]
    positions = torch.arange(s, device=x.device)[None, :]
    valid = torch.full((x.shape[0],), s, dtype=torch.int32, device=x.device)
    x, new_caches, _ = blocks_lib.stack_fwd(
        params, x, cfg, positions=positions, caches=caches, cache_pos=0,
        kv_valid_len=valid)
    return _logits_out(params, cfg, x), new_caches


def decode_step(params: dict, cfg: ModelConfig, tokens, *, caches, cache_pos):
    """One decode step.  tokens: (B, 1); cache_pos: scalar int (shared).

    Returns (logits (B, 1, V), caches) — the caches are updated in place.
    """
    x = _embed_in(params, cfg, tokens)
    cache_pos = int(cache_pos)
    positions = torch.full((x.shape[0], 1), cache_pos, dtype=torch.int32,
                           device=x.device)
    x, new_caches, _ = blocks_lib.stack_fwd(
        params, x, cfg, positions=positions, caches=caches,
        cache_pos=cache_pos, kv_valid_len=cache_pos + 1)
    return _logits_out(params, cfg, x), new_caches


def loss_fn(params: dict, cfg: ModelConfig, tokens, targets, *,
            aux_weight: float = 0.01, embeds=None):
    """Mean next-token cross-entropy (+ aux).  targets: (B, S) int.

    Logits are taken to float32, then ``logsumexp - gold``, averaged.
    Returns ``(loss, {"nll": nll, "aux": aux})``.
    """
    logits, aux = forward(params, cfg, tokens, embeds=embeds)
    logits = logits.to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets.long()[..., None])[..., 0]
    nll = torch.mean(logz - gold)
    return nll + aux_weight * aux, {"nll": nll, "aux": aux}


def count_params(params) -> int:
    if isinstance(params, dict):
        return sum(count_params(v) for v in params.values())
    return int(params.numel())
