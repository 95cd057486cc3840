"""Fault-tolerant checkpointing: atomic save/restore, keep-last-k, async
writer, auto-resume -- in the reference's on-disk layout:

    <dir>/step_000000042/
        manifest.json      # {"step", "extras", "leaves": {key: {file, shape, dtype}}}
        leaf_00000.npy     # one file per leaf, in the reference's leaf order
        COMPLETE           # written last; restore ignores dirs without it

A leaf's key is its ``/``-joined path: dict keys in sorted order, a
dataclass's fields (``TrainState``, ``OptState``) by position, ``None``
fields holding no leaf -- the key paths ``jax.tree_util`` gives the
reference's pytrees, so either package restores the other's checkpoints.
bfloat16 leaves are written as float32 (numpy has no bfloat16); ``restore``
casts every leaf to its target's dtype.  Saves go to ``step_X.tmp`` and are
renamed into place, so a crash mid-save never corrupts the latest one.

A state sharded over a distributed mesh is saved in the same layout, one
leaf at a time: the manager's ``shards`` (``launch.steps.StateShards``)
gather one whole leaf into the writing rank's host memory, a block of rows
at a time on the card, and it is written and freed before the next, so no
rank holds more than one whole leaf.  A restore maps each file and copies
out the rank's slice alone.  A one-device or reference checkpoint resumes on a mesh and back.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import shutil
import threading
from typing import Any

import numpy as np
import torch

__all__ = ["save", "restore", "latest_step", "CheckpointManager"]

_STEP_RE = re.compile(r"^step_(\d+)$")


def _children(node):
    """(key, child) pairs in flatten order, or None for a leaf."""
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node)]
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        return [(str(i), getattr(node, f.name))
                for i, f in enumerate(dataclasses.fields(node))]
    if isinstance(node, (list, tuple)):
        return [(str(i), c) for i, c in enumerate(node)]
    return None


def _flatten(tree, prefix: tuple = ()) -> list:
    kids = _children(tree)
    if kids is None:
        return [] if tree is None else [("/".join(prefix), tree)]
    return [leaf for key, child in kids for leaf in _flatten(child, prefix + (key,))]


def _rebuild(node, fn, prefix: tuple = ()):
    """``node``'s structure with every leaf replaced by ``fn(key, leaf)``."""
    if _children(node) is None:
        return None if node is None else fn("/".join(prefix), node)
    if isinstance(node, dict):
        return {k: _rebuild(v, fn, prefix + (str(k),)) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return type(node)(_rebuild(c, fn, prefix + (str(i),))
                          for i, c in enumerate(node))
    return dataclasses.replace(node, **{
        f.name: _rebuild(getattr(node, f.name), fn, prefix + (str(i),))
        for i, f in enumerate(dataclasses.fields(node))})


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            t = t.to(torch.float32)
        return t.to("cpu", copy=True).numpy()   # a snapshot, never a view
    return np.asarray(leaf)


def save(ckpt_dir: str, step: int, tree: Any, extras: dict | None = None) -> str:
    """Blocking atomic save.  Returns the final directory path."""
    return _write(ckpt_dir, step, _flatten(tree), extras)


def _write(ckpt_dir: str, step: int, leaves, extras: dict | None) -> str:
    """:func:`save` of ``(key, leaf)`` pairs in flatten order, each one
    written (and dropped) before the next is drawn."""
    final = os.path.join(ckpt_dir, f"step_{step:09d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    manifest = {"step": step, "extras": extras or {}, "leaves": {}}
    # no enumerate: its cached result tuple would keep the last leaf alive
    # while the next one is drawn
    for key, leaf in leaves:
        arr = _to_numpy(leaf)
        del leaf
        fname = f"leaf_{len(manifest['leaves']):05d}.npy"
        np.save(os.path.join(tmp, fname), arr)
        manifest["leaves"][key] = {
            "file": fname, "shape": list(arr.shape), "dtype": str(arr.dtype)}
        del arr
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    with open(os.path.join(tmp, "COMPLETE"), "w") as f:
        f.write("ok")
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def latest_step(ckpt_dir: str) -> int | None:
    """Newest step with a COMPLETE marker (ignores partial/corrupt saves)."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = []
    for name in os.listdir(ckpt_dir):
        m = _STEP_RE.match(name)
        if m and os.path.exists(os.path.join(ckpt_dir, name, "COMPLETE")):
            steps.append(int(m.group(1)))
    return max(steps) if steps else None


def restore(ckpt_dir: str, target: Any, step: int | None = None,
            device=None, cut=None) -> tuple[Any, int, dict]:
    """Restore into the structure of ``target`` (tensor leaves).

    Every leaf takes its target's dtype and ``requires_grad`` and lands on
    ``device`` (default: the target leaf's device).  ``cut(key, array)``,
    if given, takes the part of a (memory-mapped) stored array that the
    target leaf holds; only that part is read.  Returns (tree, step,
    extras).
    """
    step = latest_step(ckpt_dir) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no complete checkpoint under {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step:09d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)

    def load(key, tgt):
        ent = manifest["leaves"].get(key)
        if ent is None:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        arr = np.load(os.path.join(d, ent["file"]), mmap_mode="r")
        if cut is not None:
            arr = cut(key, arr)
        if tuple(arr.shape) != tuple(tgt.shape):
            raise ValueError(f"shape mismatch for {key}: ckpt {arr.shape} "
                             f"vs target {tuple(tgt.shape)}")
        out = torch.from_numpy(np.array(arr)).to(
            device=tgt.device if device is None else device, dtype=tgt.dtype)
        return out.requires_grad_(tgt.requires_grad)

    return _rebuild(target, load), step, manifest.get("extras", {})


class CheckpointManager:
    """keep-last-k retention + optional async (background-thread) saves."""

    def __init__(self, ckpt_dir: str, keep: int = 3, async_save: bool = True,
                 shards=None):
        """``shards``: for a state sharded over a mesh, an object with
        ``places(tree)`` (checkpoint key -> where the leaf's slices lie, for
        the sliced leaves), ``gather(leaf, place, host)`` (the whole leaf
        on the host when ``host``; every rank calls it), ``cut(array,
        place)`` (the rank's slice of a whole array), ``writer`` (whether
        this rank writes) and ``barrier()``.  A sharded save is blocking."""
        self.dir = ckpt_dir
        self.keep = keep
        self.async_save = async_save
        self.shards = shards
        self._thread: threading.Thread | None = None
        os.makedirs(ckpt_dir, exist_ok=True)

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def save(self, step: int, tree: Any, extras: dict | None = None):
        if self.shards is not None:
            self.wait()
            self._save_sharded(step, tree, extras)
            return
        # copy to host before returning: the training loop updates its
        # tensors in place right after
        host_tree = _rebuild(tree, lambda _, leaf: _to_numpy(leaf))

        def work():
            save(self.dir, step, host_tree, extras)
            self._gc()

        self.wait()
        if self.async_save:
            self._thread = threading.Thread(target=work, daemon=True)
            self._thread.start()
        else:
            work()

    def _save_sharded(self, step: int, tree: Any, extras: dict | None):
        """One whole leaf at a time: gathered to the writer's host (a block
        of it at a time on the card), written, freed before the next."""
        shards = self.shards
        places = shards.places(tree)
        if shards.writer:
            _write(self.dir, step, ((key, shards.gather(leaf, places.get(key)))
                                    for key, leaf in _flatten(tree)), extras)
            self._gc()
        else:
            for key, leaf in _flatten(tree):
                shards.gather(leaf, places.get(key), host=False)
        shards.barrier()            # the checkpoint is complete on every rank

    def restore_latest(self, target: Any, device=None):
        self.wait()
        cut = None
        if self.shards is not None:
            places = self.shards.places(target)
            cut = lambda key, arr: self.shards.cut(arr, places.get(key))
        return restore(self.dir, target, device=device, cut=cut)

    def has_checkpoint(self) -> bool:
        return latest_step(self.dir) is not None

    def _gc(self):
        steps = sorted(
            int(m.group(1)) for m in
            (_STEP_RE.match(n) for n in os.listdir(self.dir)) if m)
        for s in steps[:-self.keep] if self.keep > 0 else []:
            p = os.path.join(self.dir, f"step_{s:09d}")
            if os.path.exists(os.path.join(p, "COMPLETE")):
                shutil.rmtree(p, ignore_errors=True)
