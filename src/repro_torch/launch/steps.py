"""Steps: training (``TrainState``, ``make_train_step``) on one device or
on a distributed mesh, and inference on a mesh (``make_prefill_step``,
``make_decode_step``).

The reference jits a sharded ``(state, batch) -> (state, metrics)`` over a
mesh.  Here every step runs eagerly, SPMD: each rank of a distributed mesh
(``launch.mesh``) calls it with the same inputs and its own slices of what
the reference shards, by the reference's rules (``model.param_pspecs``,
:func:`train_state_pspecs`, :func:`batch_pspecs`).  Training: the rank
holds its slices of the parameters and of AdamW's ``m``, ``v`` (and
``ef``), takes its rows of the batch, runs the model on its slices
(``model.make_sharding``), sums the gradients over the batch axes in
float32, and updates its slices with the global gradient norm.  Inference:
the rank's parameter slices (``model.rank_params``) and cache slice
(``model.init_caches(..., mesh=)``); the batch splits over ``pod`` x
``data``, the caches' sequence over ``model`` (the sharded decodes of
``models/attention.py``) and a MoE's experts over ``model``; every rank gets
the whole batch's logits.  Gradients come from ``torch.autograd.grad`` of
``models.model.loss_fn`` with respect to the parameter leaves, and AdamW
updates the state's tensors in place (``optim.optimizer``).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.launch import collectives as coll
from repro_torch.models import model as model_lib
from repro_torch.models.common import (logical_to_pspec, rules_for,
                                       shardable_batch_axes)
from repro_torch.models.config import ModelConfig
from repro_torch.optim import AdamWConfig, OptState, adamw_init, adamw_update

__all__ = ["TrainState", "init_train_state", "train_state_from_numpy",
           "loss_and_grads", "make_train_step", "input_specs",
           "step_inputs", "cache_input_specs", "make_prefill_step",
           "make_decode_step", "train_state_pspecs", "batch_pspecs",
           "shard_train_state", "gather_train_state", "StateShards",
           "mesh_loss_and_grads"]


@dataclasses.dataclass
class TrainState:
    params: dict
    opt: OptState
    step: torch.Tensor          # 0-dim int32, on the host


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def _trainable(params: dict) -> dict:
    for _, p in _leaves(params):
        p.requires_grad_(True)
    return params


#: the whole bytes of a leaf's leading rows a sharded save gathers at once
CHECKPOINT_BLOCK_BYTES = 256 * 2**20


@dataclasses.dataclass(frozen=True, eq=False)
class StateShards:
    """The checkpoint manager's hooks for a train state sharded over a
    distributed ``mesh`` (``checkpoint.CheckpointManager(shards=)``): where
    each leaf's slices lie, one whole leaf gathered to the writer's host,
    the rank's block cut from a stored whole array.  Rank 0 writes.

    A leaf whose leading dimension is not split (every stacked layer leaf)
    is gathered :data:`CHECKPOINT_BLOCK_BYTES` of it at a time, each block
    contiguous on the card and copied into the host buffer, so the card
    holds one block and the host one whole leaf; a leaf split on its
    leading dimension comes whole and contiguous out of the gather."""

    cfg: ModelConfig
    mesh: object

    @property
    def writer(self) -> bool:
        return self.mesh.rank == 0

    def places(self, state: TrainState) -> dict:
        """Checkpoint key -> pspec of every leaf of the parameters' layout
        (parameters and moments); the step counters replicate and have
        none."""
        from repro_torch.checkpoint.manager import _flatten
        specs = model_lib.param_pspecs(self.cfg, self.mesh)
        shapes = model_lib.param_shapes(self.cfg)

        def place(tree):
            return None if tree is None else model_lib.map_with_specs(
                lambda _, spec, shape: _Place(spec), tree, specs, shapes)
        opt = state.opt
        tree = TrainState(params=place(state.params),
                          opt=OptState(step=None, m=place(opt.m),
                                       v=place(opt.v), ef=place(opt.ef)),
                          step=None)
        return {key: p.spec for key, p in _flatten(tree)}

    def gather(self, leaf: torch.Tensor, spec, host: bool = True):
        """The whole ``leaf`` as a host tensor (every rank calls it; a rank
        with ``host`` False takes part in the collectives and gets None)."""
        if spec is None or all(a is None for a in spec):
            return leaf.detach().cpu() if host else None
        shape = [n * (1 if a is None else self.mesh.axis_size(a))
                 for a, n in zip(spec, leaf.shape)]
        out = (torch.empty(shape, dtype=leaf.dtype, device="cpu")
               if host else None)
        rows = leaf.shape[0]
        if spec[0] is None:
            row_bytes = math.prod(shape[1:]) * leaf.element_size()
            rows = max(1, CHECKPOINT_BLOCK_BYTES // max(1, row_bytes))
        for i in range(0, leaf.shape[0], rows):
            block = model_lib.gather_leaf(leaf[i:i + rows], spec, self.mesh)
            if host:
                out[i:i + block.shape[0]].copy_(block.contiguous())
            elif block.is_cuda:
                # wait until the writer has taken this block: gathers queued
                # ahead of it would hold their buffers on the card
                torch.cuda.synchronize(block.device)
            del block
        return out

    def cut(self, arr, spec):
        return arr if spec is None else arr[model_lib.rank_block(
            spec, arr.shape, self.mesh)]

    def barrier(self) -> None:
        coll.barrier(self.mesh)


class _Place:
    """A pspec as a checkpoint-tree leaf (a tuple would be walked into)."""

    __slots__ = ("spec",)

    def __init__(self, spec):
        self.spec = spec


def train_state_pspecs(cfg: ModelConfig, mesh,
                       compress_grads: bool = False) -> TrainState:
    """The pspecs of a train state: the parameters', and the same for
    AdamW's ``m`` and ``v`` (and ``ef`` under ``compress_grads``); the step
    counters replicate (``()``)."""
    p = model_lib.param_pspecs(cfg, mesh)
    return TrainState(params=p, opt=OptState(step=(), m=p, v=p,
                                             ef=p if compress_grads else None),
                      step=())


def batch_pspecs(cfg: ModelConfig, mesh, with_embeds: bool | None = None,
                 batch_size: int | None = None) -> dict:
    """The pspecs of a training batch: rows over the config's batch axes
    (those that divide ``batch_size``, when given)."""
    rules = rules_for(cfg)
    if batch_size is not None:
        rules["batch"] = shardable_batch_axes(mesh, batch_size,
                                              candidates=rules["batch"])
    bspec = logical_to_pspec(("batch", "seq"), rules, mesh.axes)
    out = {"tokens": bspec, "targets": bspec}
    if cfg.frontend_stub if with_embeds is None else with_embeds:
        out["embeds"] = logical_to_pspec(("batch", "seq", None), rules,
                                         mesh.axes)
        del out["tokens"]
    return out


def init_train_state(cfg: ModelConfig, opt_cfg: AdamWConfig,
                     generator: torch.Generator | None = None,
                     device="cuda", mesh=None) -> TrainState:
    """Seeded parameters on ``device`` (see ``model.init_params``) and zeroed
    optimizer state; with a distributed ``mesh`` the rank's slices of both
    (the one-device tree's slices)."""
    params = _trainable(model_lib.init_params(cfg, generator, device=device,
                                              mesh=mesh))
    return TrainState(params=params, opt=adamw_init(params, opt_cfg),
                      step=torch.zeros((), dtype=torch.int32))


def shard_train_state(state: TrainState, cfg: ModelConfig, mesh) -> TrainState:
    """The rank's slices of a whole train state (parameters and moments)."""
    def cut(tree):
        return None if tree is None else model_lib.shard_params(tree, cfg, mesh)
    opt = state.opt
    return TrainState(params=_trainable(cut(state.params)),
                      opt=OptState(step=opt.step, m=cut(opt.m), v=cut(opt.v),
                                   ef=cut(opt.ef)),
                      step=state.step)


def gather_train_state(state: TrainState, cfg: ModelConfig,
                       mesh) -> TrainState:
    """The whole train state from the ranks' slices (every rank calls it)."""
    def whole(tree):
        return None if tree is None else model_lib.gather_params(tree, cfg,
                                                                 mesh)
    opt = state.opt
    return TrainState(params=whole(state.params),
                      opt=OptState(step=opt.step, m=whole(opt.m),
                                   v=whole(opt.v), ef=whole(opt.ef)),
                      step=state.step)


def train_state_from_numpy(params, opt, device="cuda",
                           step=None) -> TrainState:
    """A reference ``TrainState``, as numpy, carried into the port's.

    ``params`` is the parameter tree and ``opt`` anything with ``step``,
    ``m``, ``v`` and ``ef`` (the reference's ``OptState``), their leaves
    numpy arrays; the training step counter defaults to ``opt.step``.
    """
    def scalar(x):
        return torch.tensor(int(x), dtype=torch.int32)

    ef = opt.ef
    state_opt = OptState(
        step=scalar(opt.step),
        m=model_lib.params_from_numpy(opt.m, device),
        v=model_lib.params_from_numpy(opt.v, device),
        ef=None if ef is None else model_lib.params_from_numpy(ef, device))
    return TrainState(
        params=_trainable(model_lib.params_from_numpy(params, device)),
        opt=state_opt, step=scalar(opt.step if step is None else step))


def loss_and_grads(cfg: ModelConfig, params: dict, batch: dict, sh=None):
    """(loss, {"nll", "aux"}, grads) for one batch; grads mirror ``params``.
    ``sh``: the rank's sharding (``model.make_sharding``), or None."""
    loss, parts = model_lib.loss_fn(params, cfg, batch.get("tokens"),
                                    batch["targets"], embeds=batch.get("embeds"),
                                    sh=sh)
    paths, leaves = zip(*_leaves(params))
    # fed embeddings with an untied head, the loss never reads the token
    # table: it gets a zero gradient, as jax.grad gives it; every other leaf
    # must be read
    unread = (("embed",) if batch.get("embeds") is not None
              and not cfg.tie_embeddings else None)
    read = [leaf for path, leaf in zip(paths, leaves) if path != unread]
    read_grads = iter(torch.autograd.grad(loss, read))
    grads_flat = [torch.zeros_like(leaf) if path == unread else next(read_grads)
                  for path, leaf in zip(paths, leaves)]
    grads: dict = {}
    for path, g in zip(paths, grads_flat):
        node = grads
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = g
    return loss.detach(), {k: v.detach() for k, v in parts.items()}, grads


def input_specs(cfg: ModelConfig, shape_name: str, device="meta") -> dict:
    """Inputs of one dry-run cell (``configs.SHAPES``), as tensors on
    ``device`` (``meta``: shapes only).

    train   : {"tokens"|"embeds", "targets"}
    prefill : {"tokens"|"embeds"} (+ caches built via cache_input_specs)
    decode  : {"tokens" (B,1), "cache_pos" 0-dim} (+ caches)
    """
    from repro_torch.configs import SHAPES

    sh = SHAPES[shape_name]
    return step_inputs(cfg, sh["step"], sh["global_batch"], sh["seq_len"],
                       device=device)


def step_inputs(cfg: ModelConfig, step: str, batch: int, seq_len: int,
                device="meta") -> dict:
    """:func:`input_specs` of a ``step`` ("train", "prefill" or "decode")
    at any ``batch`` x ``seq_len``."""
    def spec(shape, dtype):
        return torch.empty(shape, dtype=dtype, device=device)

    b, s, i32 = batch, seq_len, torch.int32
    if step == "train":
        if cfg.frontend_stub:
            return {"embeds": spec((b, s, cfg.d_model), torch.bfloat16),
                    "targets": spec((b, s), i32)}
        return {"tokens": spec((b, s), i32), "targets": spec((b, s), i32)}
    if step == "prefill":
        if cfg.frontend_stub:
            return {"embeds": spec((b, s, cfg.d_model), torch.bfloat16)}
        return {"tokens": spec((b, s), i32)}
    # decode: one new token against a seq_len cache
    return {"tokens": spec((b, 1), i32), "cache_pos": spec((), i32)}


def cache_input_specs(cfg: ModelConfig, batch: int, max_len: int,
                      device="meta") -> dict:
    """The caches of ``batch`` sequences of ``max_len``, bf16, on
    ``device`` (``meta``: no allocation)."""
    return model_lib.init_caches(cfg, batch, max_len, dtype=torch.bfloat16,
                                 device=device)


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig, lr_schedule=None,
                    mesh=None):
    """Returns ``(state, batch, attempt=None) -> (state, metrics)``; metrics
    hold ``loss``, ``nll``, ``aux``, ``lr`` and ``grad_norm`` as 0-dim
    tensors.  The returned state shares (updated) tensors with the one
    passed in.

    ``attempt(fn)``, if given, runs the gradient computation ``fn()`` (a
    retry wrapper, say).  That is the only part of the step that may run
    more than once: it leaves the state untouched, while the AdamW update
    that follows changes it in place, leaf by leaf, and runs exactly once.

    With a distributed ``mesh`` every rank calls the step with the whole
    batch and its own slices of the state (:func:`init_train_state` or
    :func:`shard_train_state` with the mesh); the metrics are the whole
    batch's, the same on every rank.
    """
    if lr_schedule is None:
        lr_schedule = lambda step: torch.tensor(opt_cfg.lr, dtype=torch.float32)
    def step_fn(state: TrainState, batch: dict, attempt=None):
        sh = model_lib.make_sharding(cfg, mesh, "train",
                                     batch["targets"].shape[0])
        if sh is not None:
            model_lib.check_slices(state.params, sh)
        batch = {k: _rank_rows(v, sh) for k, v in batch.items()}

        def grads_fn():
            if sh is None:
                return loss_and_grads(cfg, state.params, batch)
            return mesh_loss_and_grads(cfg, sh, state.params, batch)

        loss, parts, grads = attempt(grads_fn) if attempt else grads_fn()
        lr = lr_schedule(state.step)
        params, opt, om = adamw_update(
            grads, state.opt, state.params, opt_cfg, lr,
            sharded=None if sh is None else (sh.mesh, sh.specs))
        del grads
        metrics = {"loss": loss, "nll": parts["nll"], "aux": parts["aux"],
                   "lr": lr, **om}
        return TrainState(params=params, opt=opt, step=state.step + 1), metrics

    return step_fn


def mesh_loss_and_grads(cfg: ModelConfig, sh, params: dict, batch: dict):
    """:func:`loss_and_grads` of a rank's slices ``params`` and its rows
    ``batch`` under the sharding ``sh`` (``model.make_sharding``): the whole
    batch's loss and parts, and the rank's slices of the whole batch's
    gradients."""
    with sh.mesh:
        _, parts, grads = loss_and_grads(cfg, params, batch, sh)
    return parts.pop("loss"), parts, _sum_over_batch(grads, sh)


def _sum_over_batch(grads: dict, sh) -> dict:
    """Each leaf's gradient summed in float32 over the batch axes it is not
    sliced on (a slice gathered over a batch axis had its gradient
    reduce-scattered there already)."""
    def one(g, spec, shape):
        axes = [a for a in sh.batch_axes if a not in spec]
        if not axes:
            return g
        g = g.to(torch.float32)
        for axis in axes:
            group = coll.axis_group(sh.mesh, axis)
            if group is not None:
                coll.all_reduce_(g, group)
        return g
    return model_lib.map_with_specs(one, grads, sh.specs, sh.shapes)


def _rank_rows(x, sh):
    """This rank's block of batch rows of a batch-leading input (all of it
    when the batch is replicated)."""
    if x is None or sh is None or sh.batch_shards == 1:
        return x
    rows = x.shape[0] // sh.batch_shards
    i = sh.batch_index()
    return x[i * rows:(i + 1) * rows]


def _all_rows(x: torch.Tensor, sh) -> torch.Tensor:
    """The whole batch of a per-rank output, gathered over the batch axes
    (innermost first, so blocks land in row-major order)."""
    if sh is None or sh.batch_shards == 1:
        return x
    for axis in reversed(sh.batch_axes):
        x = coll.gather(x, sh.mesh, axis, 0, reduce_grad=False)
    return x


def _check_caches(caches, cfg: ModelConfig, mesh, batch_size, max_len):
    """The rank's caches must be the slice ``init_caches(mesh=)`` builds."""
    if batch_size is None or max_len is None:
        return
    want = model_lib.init_caches(cfg, batch_size, max_len, device="meta",
                                 mesh=mesh)
    for path, leaf in _leaves(want):
        got = caches
        for k in path:
            got = got[k]
        if tuple(got.shape) != tuple(leaf.shape):
            raise ValueError(f"cache {'/'.join(path)} has shape "
                             f"{tuple(got.shape)}; this rank's slice of "
                             f"{batch_size} x {max_len} is {tuple(leaf.shape)}")


def _serving_sharding(cfg: ModelConfig, mesh, batch: int, params: dict):
    """The inference sharding of ``params``, checked to be the rank's
    slices (None on a local mesh)."""
    sh = model_lib.make_sharding(cfg, mesh, "inference", batch, params)
    if sh is not None:
        model_lib.check_slices(params, sh)
    return sh


def _check_params_like(params_like) -> None:
    if params_like is not None and not isinstance(params_like, dict):
        raise TypeError("params_like must be a parameter tree")


def make_prefill_step(cfg: ModelConfig, mesh, batch_size: int | None = None,
                      max_len: int | None = None, params_like=None):
    """``(params, inputs, caches) -> (logits, caches)`` on ``mesh``.

    ``inputs`` holds ``tokens`` (B, S) or ``embeds`` (B, S, D), the same on
    every rank; ``params`` is the rank's slices by
    ``model.param_pspecs(cfg, mesh, phase="inference")``
    (``model.rank_params``), and ``caches`` its slice of ``batch_size`` x
    ``max_len`` (filled in place).  Returns the whole batch's logits.
    ``params_like`` is the reference's argument for trees with packed
    stores: a packed store replicates with its module
    (``model.adapted_pspecs``), so here it is only checked to be a tree.
    """
    _check_params_like(params_like)

    @torch.no_grad()
    def step_fn(params, inputs, caches):
        tokens, embeds = inputs.get("tokens"), inputs.get("embeds")
        lead = (tokens if tokens is not None else embeds).shape[0]
        sh = _serving_sharding(cfg, mesh, lead, params)
        _check_caches(caches, cfg, mesh, batch_size, max_len)
        with mesh:
            logits, caches = model_lib.prefill(
                params, cfg, _rank_rows(tokens, sh), caches=caches,
                embeds=_rank_rows(embeds, sh), sh=sh)
        return _all_rows(logits, sh), caches

    return step_fn


def make_decode_step(cfg: ModelConfig, mesh, batch_size: int | None = None,
                     max_len: int | None = None, params_like=None):
    """``(params, tokens (B, 1), caches, cache_pos) -> (logits, caches)`` on
    ``mesh``, as :func:`make_prefill_step`: the same tokens on every rank,
    the rank's tree and cache slice (updated in place), the whole batch's
    logits back.  A mesh whose ``model`` axis shards the caches takes the
    sequence-sharded decode."""
    _check_params_like(params_like)

    @torch.no_grad()
    def step_fn(params, tokens, caches, cache_pos):
        sh = _serving_sharding(cfg, mesh, tokens.shape[0], params)
        _check_caches(caches, cfg, mesh, batch_size, max_len)
        with mesh:
            logits, caches = model_lib.decode_step(
                params, cfg, _rank_rows(tokens, sh), caches=caches,
                cache_pos=cache_pos, sh=sh)
        return _all_rows(logits, sh), caches

    return step_fn
