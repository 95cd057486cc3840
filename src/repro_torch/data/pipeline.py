"""Data pipeline: synthetic + file-backed token streams, host-sharded, with
background prefetch.

Every source yields dicts of numpy arrays ``{"tokens": (B, S), "targets":
(B, S)}`` (or ``{"embeds": (B, S, D), ...}`` for frontend-stub archs).  The
loader shards deterministically by (host_index, host_count) so multi-host
launches read disjoint data, and a daemon thread keeps ``prefetch`` batches
ahead of the training loop.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Iterator

import numpy as np

__all__ = ["DataConfig", "SyntheticLM", "TokenFile", "Prefetcher", "make_pipeline"]


@dataclasses.dataclass(frozen=True)
class DataConfig:
    batch_size: int = 8                # per-host batch
    seq_len: int = 128
    vocab_size: int = 1024
    seed: int = 0
    host_index: int = 0
    host_count: int = 1
    embed_dim: int | None = None       # set for frontend-stub archs
    path: str | None = None            # token file (np.int32 flat) if given


class SyntheticLM:
    """Deterministic synthetic LM stream with learnable structure.

    Tokens follow a noisy order-1 Markov chain (so loss can actually go
    down during example training runs, unlike pure uniform noise).
    """

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        base = np.random.default_rng(cfg.seed)
        v = cfg.vocab_size
        # sparse-ish transition structure shared across hosts
        self._shift = base.integers(1, v, size=16)
        self._step = 0

    def __iter__(self) -> Iterator[dict]:
        cfg = self.cfg
        rng = np.random.default_rng(
            (cfg.seed * 1_000_003 + cfg.host_index) & 0x7FFFFFFF)
        v = cfg.vocab_size
        while True:
            b, s = cfg.batch_size, cfg.seq_len
            first = rng.integers(0, v, size=(b, 1))
            noise = rng.random((b, s - 1))
            shift = self._shift[rng.integers(0, len(self._shift), size=(b, s - 1))]
            toks = np.empty((b, s), np.int32)
            toks[:, :1] = first
            for t in range(1, s):
                det = (toks[:, t - 1] + shift[:, t - 1]) % v
                rand = rng.integers(0, v, size=b)
                toks[:, t] = np.where(noise[:, t - 1] < 0.8, det, rand)
            batch = {"tokens": toks[:, :-1].copy(), "targets": toks[:, 1:].copy()}
            if cfg.embed_dim is not None:
                # frontend stub: precomputed frame/patch embeddings
                batch["embeds"] = rng.standard_normal(
                    (b, s - 1, cfg.embed_dim)).astype(np.float32)
            self._step += 1
            yield batch


class TokenFile:
    """Flat int32 token file, chunked into sequences, host-sharded."""

    def __init__(self, cfg: DataConfig):
        if cfg.path is None:
            raise ValueError("TokenFile needs cfg.path")
        self.cfg = cfg
        self.tokens = np.memmap(cfg.path, dtype=np.int32, mode="r")

    def __iter__(self) -> Iterator[dict]:
        cfg = self.cfg
        stride = cfg.seq_len + 1
        n_seq = len(self.tokens) // stride
        order = np.random.default_rng(cfg.seed).permutation(n_seq)
        order = order[cfg.host_index::cfg.host_count]
        i = 0
        while True:
            idxs = []
            while len(idxs) < cfg.batch_size:
                idxs.append(order[i % len(order)])
                i += 1
            seqs = np.stack([self.tokens[j * stride:(j + 1) * stride] for j in idxs])
            yield {"tokens": seqs[:, :-1].astype(np.int32),
                   "targets": seqs[:, 1:].astype(np.int32)}


class Prefetcher:
    """Daemon-thread prefetch queue in front of any batch iterator."""

    def __init__(self, it: Iterator[dict], prefetch: int = 2):
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._err: list[BaseException] = []

        def run():
            try:
                for item in it:
                    self._q.put(item)
            except BaseException as e:  # surfaced on next()
                self._err.append(e)
                self._q.put(None)

        self._t = threading.Thread(target=run, daemon=True)
        self._t.start()

    def __iter__(self):
        return self

    def __next__(self) -> dict:
        item = self._q.get()
        if item is None:
            raise self._err[0] if self._err else StopIteration
        return item


def make_pipeline(cfg: DataConfig, prefetch: int = 2) -> Iterator[dict]:
    src = TokenFile(cfg) if cfg.path else SyntheticLM(cfg)
    return Prefetcher(iter(src), prefetch=prefetch)
