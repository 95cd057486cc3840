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
the reference shards, by the reference's logical-axis rules:
:func:`param_pspecs` names the mesh axes of every leaf, :func:`shard_params`
cuts a whole tree to the rank's slices (:func:`gather_params` is its
inverse), and :func:`make_sharding` is what the step builders hand the
model's functions (``sh=``) to run it on them.  Inside, attention,
MLPs, the embedding and the logits run Megatron-style on their ``model``
slices, experts are expert-parallel, and every other sharded leaf (FSDP's
``embed`` over ``data``, a leaf a module has no slice-wise form for) is
gathered just before use (``common.materialize``).  :func:`init_caches`
with ``mesh=`` builds the rank's cache slice (its batch rows over ``pod`` x
``data``, its sequence positions over ``model``).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.models import blocks as blocks_lib
from repro_torch.launch import collectives as coll
from repro_torch.models.common import (ParamDef, Sharding, dense, dtype_of,
                                       embed_lookup, init_tree,
                                       logits_from_embedding, materialize,
                                       pspec_tree, rmsnorm, rules_for,
                                       shardable_batch_axes, tp_of)
from repro_torch.models.config import ModelConfig

__all__ = [
    "model_defs", "init_params", "params_from_numpy", "forward", "prefill",
    "decode_step", "init_caches", "count_params", "embed_in", "logits_out",
    "require_device", "loss_fn", "batch_shards", "batch_axes",
    "rank_params", "param_pspecs", "param_shapes", "shard_params",
    "gather_params", "make_sharding", "map_with_specs", "rank_block",
    "gather_leaf", "adapted_pspecs", "check_slices",
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
        "embed": ParamDef((cfg.vocab_size, cfg.d_model), ("vocab", "embed"),
                          init="normal"),
        "final_norm": ParamDef((cfg.d_model,), ("embed",), init="ones"),
        "layers": blocks_lib.stacked_layer_defs(cfg),
    }
    if cfg.family == "hybrid":
        defs["shared"] = blocks_lib.shared_attn_defs(cfg)
    if not cfg.tie_embeddings:
        defs["lm_head"] = ParamDef((cfg.d_model, cfg.vocab_size),
                                   ("embed", "vocab"))
    return defs


def init_params(cfg: ModelConfig, generator: torch.Generator | None = None,
                device="cuda", mesh=None, phase: str = "train") -> dict:
    """Seeded random parameters drawn on ``device``.

    Same init rules as the reference (``normal`` σ=0.02 embeddings, ``ones``
    norms, LeCun-normal matrices) from a ``torch.Generator`` living on the
    device; the numbers differ from the reference's PRNG by construction —
    use :func:`params_from_numpy` where the two must share weights.  With a
    distributed ``mesh`` each leaf is drawn whole, in the same order, and
    cut to the rank's slice (:func:`param_pspecs` at ``phase``) before the
    next is drawn: the slices of the one-device tree, at the memory of the
    largest leaf.
    """
    device = require_device(device)
    if generator is None:
        generator = torch.Generator(device=device)
        generator.manual_seed(0)
    dtype = dtype_of(cfg.param_dtype)
    if mesh is None or not mesh.distributed:
        return init_tree(model_defs(cfg), generator, device, dtype)

    def draw(defs, specs):
        if isinstance(defs, ParamDef):
            return _rank_slice(defs.materialize(generator, device, dtype),
                               specs, mesh)
        return {k: draw(defs[k], specs[k]) for k in sorted(defs)}

    return draw(model_defs(cfg), param_pspecs(cfg, mesh, phase))


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


def _top(params, name: str, sh):
    """A top-level leaf, its non-tensor-parallel slices gathered, and the
    ``tp`` of its vocabulary dimension (``common.tp_of``)."""
    if sh is None:
        return params[name], None
    vocab_dim = 1 if name == "lm_head" else 0
    leaf = materialize({name: params[name]}, {name: sh.specs[name]}, sh,
                       cached=True)[name]
    return leaf, tp_of(sh, sh.specs[name][vocab_dim])


def _embed_in(params, cfg: ModelConfig, tokens=None, embeds=None, sh=None):
    compute = dtype_of(cfg.compute_dtype)
    if embeds is not None:
        x = embeds.to(compute)
    else:
        table, tp = _top(params, "embed", sh)
        if tp is None:
            x = embed_lookup(table, tokens, compute)
        else:
            # vocab-parallel lookup: the rank's rows, zero elsewhere, summed
            mesh, r = tp, tp.axis_index("model")
            local = tokens.long() - r * table.shape[0]
            hit = (local >= 0) & (local < table.shape[0])
            x = embed_lookup(table, torch.where(hit, local, 0), compute)
            x = coll.reduce_from(x * hit[..., None].to(compute), mesh)
    if cfg.scale_embeddings:
        # filled on the device (no host copy, so a decode step that embeds
        # can be captured as a CUDA graph), rounded to float32 first
        x = x * torch.full((), math.sqrt(cfg.d_model), dtype=torch.float32,
                           device=x.device).to(compute)
    return x


def _logits_out(params, cfg: ModelConfig, x, vocab_local: bool = False,
                sh=None):
    """Logits over the whole vocabulary; with ``vocab_local`` a
    vocab-parallel rank's own columns (the sharded loss reads them so)."""
    x = rmsnorm(_top(params, "final_norm", sh)[0], x, cfg.rms_eps)
    w, tp = _top(params, "embed" if cfg.tie_embeddings else "lm_head", sh)
    if tp is not None:
        x = coll.copy_to(x, tp)
    if cfg.tie_embeddings:
        # tied head: the transposed-embedding matmul stays float (backend
        # scopes cover weight-stationary GEMM sites)
        logits = logits_from_embedding(w, x, cfg.logit_softcap)
    else:
        from repro_torch.backends import runtime as backend_runtime
        if backend_runtime.active_execution() is not None:
            # "lm_head" is a dense site only under a backend scope; outside
            # any scope the head keeps its plain-float matmul
            logits = dense(w, x, cfg, name="lm_head")
        else:
            logits = torch.matmul(x, w.to(x.dtype))
        if cfg.logit_softcap is not None:
            logits = torch.tanh(logits / cfg.logit_softcap) * cfg.logit_softcap
    if tp is not None and not vocab_local:
        logits = coll.gather(logits, tp, "model", logits.ndim - 1,
                             reduce_grad=False)
    return logits


# Public aliases: the serving engine drives its own ragged paged decode loop
# over the layer stack but must share the embedding/head math with
# decode_step *exactly* — its paged-vs-contiguous probe compares full logits.
embed_in = _embed_in
logits_out = _logits_out


def forward(params: dict, cfg: ModelConfig, tokens=None, *, embeds=None,
            positions=None, vocab_local: bool = False, sh=None):
    """Full-sequence logits.  Returns (logits (B,S,V), aux_loss); with
    ``vocab_local`` a vocab-parallel rank's own columns.  ``sh``: the
    rank's :class:`~repro_torch.models.common.Sharding` (``params`` its
    slices, ``tokens`` its rows), or None."""
    x = _embed_in(params, cfg, tokens, embeds, sh)
    if positions is None:
        positions = torch.arange(x.shape[1], device=x.device)[None, :]
    x, _, aux = blocks_lib.stack_fwd(params, x, cfg, positions=positions,
                                     sh=sh)
    return _logits_out(params, cfg, x, vocab_local, sh), aux


def batch_axes(mesh, batch: int, candidates=("pod", "data")) -> tuple:
    """The axes of a distributed ``mesh`` a batch of ``batch`` rows splits
    over (the reference's ``shardable_batch_axes``; () without a mesh)."""
    if mesh is None or not mesh.distributed:
        return ()
    return shardable_batch_axes(mesh, batch, candidates)


def batch_shards(mesh, batch: int) -> int:
    """How many blocks a served batch of ``batch`` rows splits into under a
    distributed ``mesh``: over ``pod`` x ``data`` where they divide it
    (:func:`batch_axes`), else 1 (replicated)."""
    return math.prod(mesh.axis_size(a) for a in batch_axes(mesh, batch))


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


def param_pspecs(cfg: ModelConfig, mesh, phase: str = "train") -> dict:
    """The pspec of every leaf (see ``models.common``) on ``mesh``.  At
    ``phase="inference"`` an FSDP config replicates over ``data`` unless
    ``cfg.fsdp_inference``, as the reference's serving layout does."""
    rules = rules_for(cfg)
    if phase == "inference" and cfg.fsdp and not cfg.fsdp_inference:
        rules["embed"] = None
    return pspec_tree(model_defs(cfg), rules, mesh.axes,
                      dict(zip(mesh.axes, mesh.shape)))


def param_shapes(cfg: ModelConfig) -> dict:
    """The whole shape of every leaf."""
    def walk(defs):
        if isinstance(defs, ParamDef):
            return tuple(defs.shape)
        return {k: walk(v) for k, v in defs.items()}
    return walk(model_defs(cfg))


def rank_block(spec, shape, mesh) -> tuple[slice, ...]:
    """The index of this rank's block of a whole leaf of ``shape`` laid out
    by ``spec``."""
    out = []
    for axis, size in zip(spec, shape):
        if axis is None:
            out.append(slice(None))
            continue
        size //= mesh.axis_size(axis)
        i = mesh.axis_index(axis)
        out.append(slice(i * size, (i + 1) * size))
    return tuple(out)


def _rank_slice(t: torch.Tensor, spec, mesh) -> torch.Tensor:
    """This rank's block of a whole leaf ``t`` (a copy the rank owns)."""
    if all(axis is None for axis in spec):
        return t
    return t[rank_block(spec, t.shape, mesh)].clone()


@torch.no_grad()
def gather_leaf(leaf: torch.Tensor, spec, mesh) -> torch.Tensor:
    """The whole leaf from every rank's block of it (every rank of
    ``mesh`` calls it)."""
    for d, axis in enumerate(spec):
        if axis is not None:
            leaf = coll.gather(leaf, mesh, axis, d, reduce_grad=False)
    return leaf.detach()


def map_with_specs(fn, tree, specs, shapes):
    """``fn(leaf, pspec, whole shape)`` over a tree of the parameters'
    layout, with :func:`param_pspecs`' and :func:`param_shapes`' trees."""
    if isinstance(tree, dict):
        return {k: map_with_specs(fn, v, specs[k], shapes[k])
                for k, v in tree.items()}
    return fn(tree, specs, shapes)


def adapted_pspecs(params: dict, cfg: ModelConfig, mesh,
                   phase: str = "train") -> dict:
    """:func:`param_pspecs` for a tree that may hold packed stores: a packed
    store replicates (the reference's ``adapt_param_pspecs``), and so does
    every ``model``-split leaf of its module, which shares its heads or
    hidden units."""
    from repro_torch.core import packing

    def adapt(tree, specs):
        if not isinstance(tree, dict):
            return specs
        out = {k: adapt(v, specs[k]) for k, v in tree.items()}
        if any(packing.is_packed(v) for v in tree.values()):
            out = {k: v if isinstance(v, dict) else
                   (None,) * len(v) if packing.is_packed(tree[k]) else
                   tuple(None if a == "model" else a for a in v)
                   for k, v in out.items()}
        return out

    return adapt(params, param_pspecs(cfg, mesh, phase))


def shard_params(params: dict, cfg: ModelConfig, mesh,
                 phase: str = "train") -> dict:
    """This rank's slices of a whole parameter tree (or of any tree of its
    layout: AdamW's moments, gradients) by :func:`adapted_pspecs` at
    ``phase``; a local mesh keeps the whole tree."""
    if mesh is None or not mesh.distributed:
        return params
    from repro_torch.core import packing

    def one(leaf, spec, shape):
        if packing.is_packed(leaf):
            return leaf
        if tuple(leaf.shape) != tuple(shape):
            raise ValueError(f"a leaf of shape {tuple(leaf.shape)} where the "
                             f"whole is {tuple(shape)}: shard_params cuts a "
                             f"whole tree")
        return _rank_slice(leaf, spec, mesh)

    specs = adapted_pspecs(params, cfg, mesh, phase)
    return map_with_specs(one, params, specs, param_shapes(cfg))


def check_slices(params: dict, sh: Sharding) -> None:
    """Raise unless every leaf of ``params`` is the rank's slice under
    ``sh`` (:func:`shard_params`, :func:`rank_params`)."""
    from repro_torch.core import packing

    def one(leaf, spec, shape):
        if packing.is_packed(leaf):
            return
        want = tuple(n // (1 if a is None else sh.mesh.axis_size(a))
                     for a, n in zip(spec, shape))
        if tuple(leaf.shape) != want:
            raise ValueError(f"a leaf of shape {tuple(leaf.shape)} where this "
                             f"rank's slice is {want}: pass the rank's tree "
                             f"(shard_params / rank_params)")

    map_with_specs(one, params, sh.specs, sh.shapes)


def rank_params(params: dict, cfg: ModelConfig, mesh) -> dict:
    """The rank's serving tree: :func:`shard_params` at
    ``phase="inference"``."""
    return shard_params(params, cfg, mesh, phase="inference")


@torch.no_grad()
def gather_params(params: dict, cfg: ModelConfig, mesh,
                  phase: str = "train") -> dict:
    """The whole tree from every rank's slices (the inverse of
    :func:`shard_params`; every rank of the mesh must call it)."""
    if mesh is None or not mesh.distributed:
        return params
    from repro_torch.core import packing

    def one(leaf, spec, shape):
        if packing.is_packed(leaf):
            return leaf
        return gather_leaf(leaf, spec, mesh)

    specs = adapted_pspecs(params, cfg, mesh, phase)
    return map_with_specs(one, params, specs, param_shapes(cfg))


def _strip_layer(tree):
    if isinstance(tree, dict):
        return {k: _strip_layer(v) for k, v in tree.items()}
    return tuple(tree[1:])


def make_sharding(cfg: ModelConfig, mesh, phase: str, batch: int,
                  params: dict | None = None) -> Sharding | None:
    """What a step hands the model (``sh=``) to run ``cfg`` on a rank's
    slices of a distributed ``mesh`` (None on a local mesh): the pspecs at
    ``phase`` (:func:`adapted_pspecs` of ``params``, when given) and the
    batch axes of ``batch`` rows — the config's (``rules_for``) in
    training, ``pod`` x ``data`` in serving."""
    if mesh is None or not mesh.distributed:
        return None
    if phase == "train":
        axes = batch_axes(mesh, batch, rules_for(cfg)["batch"])
        if cfg.is_moe and "model" in axes:
            raise NotImplementedError("a MoE config whose batch splits over "
                                      "the model axis (dp_over_model)")
    else:
        axes = batch_axes(mesh, batch)
    specs = (param_pspecs(cfg, mesh, phase) if params is None
             else adapted_pspecs(params, cfg, mesh, phase))
    return Sharding(mesh, specs, param_shapes(cfg), axes,
                    layer_specs=_strip_layer(specs["layers"]))


def prefill(params: dict, cfg: ModelConfig, tokens=None, *, caches,
            embeds=None, sh=None, serving=None):
    """Populate caches (in place) from a prompt: KV, recurrent states, conv
    tails and token-shift buffers.  Returns (logits, caches).  ``sh`` as in
    :func:`forward`; ``serving`` (a ``moe.Serving``, the serving engine's)
    runs an MoE stack's experts through ``moe.moe_serve``."""
    x = _embed_in(params, cfg, tokens, embeds, sh)
    s = x.shape[1]
    positions = torch.arange(s, device=x.device)[None, :]
    valid = torch.full((x.shape[0],), s, dtype=torch.int32, device=x.device)
    x, new_caches, _ = blocks_lib.stack_fwd(
        params, x, cfg, positions=positions, caches=caches, cache_pos=0,
        kv_valid_len=valid, sh=sh, serving=serving)
    return _logits_out(params, cfg, x, sh=sh), new_caches


def decode_step(params: dict, cfg: ModelConfig, tokens, *, caches, cache_pos,
                sh=None):
    """One decode step.  tokens: (B, 1); cache_pos: scalar int (shared).

    Returns (logits (B, 1, V), caches) — the caches are updated in place.
    ``sh`` as in :func:`forward`.
    """
    x = _embed_in(params, cfg, tokens, sh=sh)
    cache_pos = int(cache_pos)
    positions = torch.full((x.shape[0], 1), cache_pos, dtype=torch.int32,
                           device=x.device)
    x, new_caches, _ = blocks_lib.stack_fwd(
        params, x, cfg, positions=positions, caches=caches,
        cache_pos=cache_pos, kv_valid_len=cache_pos + 1, sh=sh)
    return _logits_out(params, cfg, x, sh=sh), new_caches


def loss_fn(params: dict, cfg: ModelConfig, tokens, targets, *,
            aux_weight: float = 0.01, embeds=None, sh=None):
    """Mean next-token cross-entropy (+ aux).  targets: (B, S) int.

    Logits are taken to float32, then ``logsumexp - gold``, averaged.
    Returns ``(loss, {"nll": nll, "aux": aux})``.

    Under a :class:`~repro_torch.models.common.Sharding` ``sh`` the
    parameters are the rank's slices, the batch its rows, and the logits
    may be its vocabulary columns: the returned
    loss is then the rank's share of the objective (its rows' summed
    cross-entropy over the global token count, plus the aux term), whose
    gradients summed over the batch axes are the whole batch's; ``parts``
    adds ``"loss"``, the whole batch's loss, for the metrics.
    """
    logits, aux = forward(params, cfg, tokens, embeds=embeds,
                          vocab_local=sh is not None, sh=sh)
    logits = logits.to(torch.float32)
    if sh is None:
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, targets.long()[..., None])[..., 0]
        nll = torch.mean(logz - gold)
        return nll + aux_weight * aux, {"nll": nll, "aux": aux}
    tgt = targets.long()
    tp = tp_of(sh, sh.specs["embed"][0] if cfg.tie_embeddings
               else sh.specs["lm_head"][1])
    if tp is None:
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, tgt[..., None])[..., 0]
    else:
        # vocab-parallel cross-entropy: global max, summed exp, gold column
        mesh, r = tp, tp.axis_index("model")
        v = logits.shape[-1]
        m = coll.max_over(logits.amax(dim=-1), mesh, "model")
        se = coll.reduce_from(torch.exp(logits - m[..., None]).sum(dim=-1),
                              mesh)
        logz = torch.log(se) + m
        local = tgt - r * v
        hit = (local >= 0) & (local < v)
        gold = torch.gather(logits, -1, torch.where(hit, local, 0)[..., None])
        gold = coll.reduce_from(gold[..., 0] * hit, mesh)
    share = torch.sum(logz - gold) / (tgt.numel() * sh.batch_shards)
    nll = share.detach().clone()
    for axis in sh.batch_axes:
        group = coll.axis_group(sh.mesh, axis)
        if group is not None:
            coll.all_reduce_(nll, group)
    aux_d = aux.detach()
    return share + aux_weight * aux, {"nll": nll, "aux": aux_d,
                                      "loss": nll + aux_weight * aux_d}


def count_params(params) -> int:
    if isinstance(params, dict):
        return sum(count_params(v) for v in params.values())
    return int(params.numel())
