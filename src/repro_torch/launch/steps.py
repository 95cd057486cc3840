"""Training step on one device: ``TrainState`` and ``make_train_step``.

The reference jits a sharded ``(state, batch) -> (state, metrics)`` over a
mesh; here the step runs eagerly on the device the state lives on, with no
sharding.  Gradients come from ``torch.autograd.grad`` of
``models.model.loss_fn`` with respect to the parameter leaves, and AdamW
updates the state's tensors in place (``optim.optimizer``).
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.models import model as model_lib
from repro_torch.models.config import ModelConfig
from repro_torch.optim import AdamWConfig, OptState, adamw_init, adamw_update

__all__ = ["TrainState", "init_train_state", "train_state_from_numpy",
           "loss_and_grads", "make_train_step", "input_specs",
           "step_inputs", "cache_input_specs"]


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


def init_train_state(cfg: ModelConfig, opt_cfg: AdamWConfig,
                     generator: torch.Generator | None = None,
                     device="cuda") -> TrainState:
    """Seeded parameters on ``device`` (see ``model.init_params``) and zeroed
    optimizer state."""
    params = _trainable(model_lib.init_params(cfg, generator, device=device))
    return TrainState(params=params, opt=adamw_init(params, opt_cfg),
                      step=torch.zeros((), dtype=torch.int32))


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


def loss_and_grads(cfg: ModelConfig, params: dict, batch: dict):
    """(loss, {"nll", "aux"}, grads) for one batch; grads mirror ``params``."""
    loss, parts = model_lib.loss_fn(params, cfg, batch.get("tokens"),
                                    batch["targets"], embeds=batch.get("embeds"))
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


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig, lr_schedule=None):
    """Returns ``(state, batch, attempt=None) -> (state, metrics)``; metrics
    hold ``loss``, ``nll``, ``aux``, ``lr`` and ``grad_norm`` as 0-dim
    tensors.  The returned state shares (updated) tensors with the one
    passed in.

    ``attempt(fn)``, if given, runs the gradient computation ``fn()`` (a
    retry wrapper, say).  That is the only part of the step that may run
    more than once: it leaves the state untouched, while the AdamW update
    that follows changes it in place, leaf by leaf, and runs exactly once.
    """
    if lr_schedule is None:
        lr_schedule = lambda step: torch.tensor(opt_cfg.lr, dtype=torch.float32)

    def step_fn(state: TrainState, batch: dict, attempt=None):
        grads_fn = lambda: loss_and_grads(cfg, state.params, batch)
        loss, parts, grads = attempt(grads_fn) if attempt else grads_fn()
        lr = lr_schedule(state.step)
        params, opt, om = adamw_update(grads, state.opt, state.params,
                                       opt_cfg, lr)
        del grads
        metrics = {"loss": loss, "nll": parts["nll"], "aux": parts["aux"],
                   "lr": lr, **om}
        return TrainState(params=params, opt=opt, step=state.step + 1), metrics

    return step_fn
