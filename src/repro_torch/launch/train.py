"""End-to-end training loop with fault tolerance, on one device or on a
``torch.distributed`` mesh.

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3-8b --smoke \
        --steps 20 --device cpu
    PYTHONPATH=src torchrun --standalone --nproc-per-node 4 \
        -m repro_torch.launch.train --smoke --device cpu --mesh-shape 2,2

Runs on the card by default (``--device cuda``); on the card the no-cache
attention of every layer goes through the hand-written flash kernels,
forward and backward.  Features as in the reference: auto-resume from the
latest COMPLETE checkpoint (the reference's on-disk layout, so a reference
checkpoint resumes here), keep-k async checkpointing, straggler watchdog,
retry of a step's gradient computation, and optional int8 gradient
compression with error feedback.  Training follows ``cfg.compute_dtype``.

On a mesh (``--mesh pod|multipod``: the reference's 16x16 or 2x16x16, in a
world of that many ranks; ``--mesh-shape D,M``: a ``("data", "model")``
mesh of the world's size) every rank holds its slices of the state by the
reference's sharding rules (``launch.steps``), draws the same global batch
and trains on its rows; checkpoints hold the whole arrays, which rank 0
writes, and restore to each rank's slices.
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import os
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch.checkpoint import CheckpointManager
from repro_torch.data import DataConfig, make_pipeline
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import steps as steps_lib
from repro_torch.models.model import require_device
from repro_torch.optim import AdamWConfig, cosine_schedule
from repro_torch.runtime import StepTimer, StragglerWatchdog, retry_with_backoff

log = logging.getLogger("repro_torch.train")


@dataclasses.dataclass
class TrainLoopConfig:
    steps: int = 100
    log_every: int = 10
    ckpt_every: int = 50
    ckpt_dir: str | None = None
    keep: int = 3
    seed: int = 0
    batch: int = 8
    seq: int = 128
    lr: float = 3e-4
    warmup: int = 20
    compress_grads: bool = False
    inject_failures: float = 0.0    # probability of a synthetic step failure


def train(cfg, loop: TrainLoopConfig, device="cuda", mesh=None):
    """Train ``cfg`` on one device, or on a distributed ``mesh`` (every rank
    calls this; ``device`` is the rank's).  Returns (state, history,
    watchdog); on a mesh ``state`` holds the rank's slices.

    ``history`` holds ``(step, metrics)`` at every ``log_every``-th step
    (and the first), the metrics as floats plus ``step_s``, the step's wall
    seconds.  On a CUDA device each step ends in a synchronise, so the
    watchdog and ``step_s`` see the device's work, not its enqueueing.
    """
    device = require_device(device)
    if mesh is not None and not mesh.distributed:
        mesh = None
    opt_cfg = AdamWConfig(lr=loop.lr, compress_grads=loop.compress_grads)
    sched = cosine_schedule(loop.lr, loop.warmup, loop.steps)
    step_fn = steps_lib.make_train_step(cfg, opt_cfg, sched, mesh=mesh)

    data_cfg = DataConfig(batch_size=loop.batch, seq_len=loop.seq + 1,
                          vocab_size=cfg.vocab_size, seed=loop.seed,
                          embed_dim=cfg.d_model if cfg.frontend_stub else None)
    data = make_pipeline(data_cfg)

    shards = None if mesh is None else steps_lib.StateShards(cfg, mesh)
    mgr = (CheckpointManager(loop.ckpt_dir, keep=loop.keep, shards=shards)
           if loop.ckpt_dir else None)
    generator = torch.Generator(device=device)
    generator.manual_seed(loop.seed)
    state = steps_lib.init_train_state(cfg, opt_cfg, generator, device,
                                       mesh=mesh)
    start = 0
    if mgr is not None and mgr.has_checkpoint():
        t0 = time.perf_counter()
        state, start, _ = mgr.restore_latest(state)
        if mesh is None or mesh.rank == 0:
            log.info("auto-resumed from step %d (%.1f s)", start,
                     time.perf_counter() - t0)

    watchdog = StragglerWatchdog()
    rng = np.random.default_rng(loop.seed + 1)
    history = []
    for i in range(start, loop.steps):
        batch_np = next(data)
        batch = {k: torch.from_numpy(v).to(device) for k, v in batch_np.items()
                 if k in ("tokens", "targets", "embeds")}
        if cfg.frontend_stub:
            batch.pop("tokens", None)

        def attempt(grads_fn):
            # Only the gradient computation is retried: it leaves the state
            # untouched.  The in-place update runs once; a failure there
            # ends the run, which then resumes from the latest checkpoint.
            def once():
                if loop.inject_failures and rng.random() < loop.inject_failures:
                    raise RuntimeError("synthetic node failure (injected)")
                out = grads_fn()
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
                return out
            return retry_with_backoff(once, retries=3, base_delay=0.01)

        with StepTimer(watchdog) as timer:
            try:
                state, metrics = step_fn(state, batch, attempt)
            except BaseException:
                if mgr is not None:
                    mgr.wait()      # let a pending save finish before failing
                raise
            if device.type == "cuda":
                torch.cuda.synchronize(device)
        if (i + 1) % loop.log_every == 0 or i == start:
            m = {k: float(v) for k, v in metrics.items()}
            m["step_s"] = timer.elapsed
            history.append((i + 1, m))
            if mesh is None or mesh.rank == 0:
                    log.info("step %d loss=%.4f nll=%.4f gnorm=%.2f lr=%.2e",
                         i + 1, m["loss"], m["nll"], m["grad_norm"], m["lr"])
        if mgr is not None and (i + 1) % loop.ckpt_every == 0:
            _save(mgr, i + 1, state, mesh,
                  extras={"loss": float(metrics["loss"])})
    if mgr is not None:
        _save(mgr, loop.steps, state, mesh)
        mgr.wait()
    return state, history, watchdog


def _save(mgr, step: int, state, mesh, extras=None) -> None:
    """``mgr.save``, its wall logged (on a mesh the whole blocking save; on
    one device the host snapshot, the write goes on in the background)."""
    t0 = time.perf_counter()
    mgr.save(step, state, extras=extras)
    if mesh is None or mesh.rank == 0:
        log.info("checkpoint step %d: save() %.1f s", step,
                 time.perf_counter() - t0)


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="llama3-8b", choices=list(configs.ARCH_IDS))
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-trainable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--inject-failures", type=float, default=0.0)
    ap.add_argument("--mesh", default="single",
                    choices=["single", "pod", "multipod"])
    ap.add_argument("--mesh-shape", default=None,
                    help="D,M: train on a (data, model) mesh of D x M ranks "
                         "(under torchrun with D x M processes)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (default: cuda; 'cpu' runs "
                         "the kernels' plain versions)")
    args = ap.parse_args(argv)

    mesh, device = None, args.device
    if args.mesh != "single" or args.mesh_shape:
        if "WORLD_SIZE" in os.environ and not mesh_lib.distributed():
            device = mesh_lib.init_distributed(args.device)
        if args.mesh_shape:
            shape = tuple(int(v) for v in args.mesh_shape.split(","))
            mesh = mesh_lib.make_mesh(shape, ("data", "model"), args.device)
        else:
            mesh = mesh_lib.make_production_mesh(
                multi_pod=args.mesh == "multipod", device=args.device)
    cfg = (configs.get_smoke_config(args.arch) if args.smoke
           else configs.get_config(args.arch))
    loop = TrainLoopConfig(steps=args.steps, batch=args.batch, seq=args.seq,
                           lr=args.lr, ckpt_dir=args.ckpt_dir,
                           ckpt_every=args.ckpt_every,
                           compress_grads=args.compress_grads,
                           inject_failures=args.inject_failures)
    t0 = time.time()
    try:
        state, history, watchdog = train(cfg, loop, device, mesh=mesh)
    finally:
        if mesh is not None:
            torch.distributed.destroy_process_group()
    if history and (mesh is None or mesh.rank == 0):
        where = args.device if mesh is None else (
            f"a {'x'.join(map(str, mesh.shape))} {args.device} mesh")
        first, last = history[0][1]["loss"], history[-1][1]["loss"]
        peak = (f", peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB"
                f"{' a card' if mesh is not None else ''}"
                if torch.device(device).type == "cuda" else "")
        print(f"trained {args.arch} ({'smoke' if args.smoke else 'full'}) on "
              f"{where}: loss {first:.4f} -> {last:.4f} in "
              f"{time.time()-t0:.1f}s ({watchdog.slow_steps} straggler steps"
              f"{peak})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
