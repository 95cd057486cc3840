"""Unary encodings: temporal-unary, 2-unary (tubGEMM), and rate-coded bitstreams.

Encoding conventions (bipolar / signed-magnitude, per the paper's non-scaled
bipolar compute):

* **temporal-unary** — a w-bit signed value ``v`` with ``|v| <= Vmax = 2^(w-1)-1``
  is a stream of ``2^(w-1)`` slots: ``|v|`` consecutive 1s followed by 0s,
  plus a sign wire.
* **2-unary (tubGEMM)** — ``|v| = 2*v1 + v0`` where ``v1`` streams over
  ``2^(w-2)`` slots with weight 2 and ``v0 ∈ {0,1}`` rides the first slot
  with weight 1.
* **rate-unary (uGEMM)** — ``2^w`` slots; slot t is 1 iff ``ldseq(t) < p``
  where ``p`` is the normalized magnitude and ``ldseq`` is the base-2 van der
  Corput sequence.  Value is recovered as the 1s-frequency.

Streams are materialized on a new leading axis of length ``stream_len``.
These are *simulation* utilities: the serving path never materializes
streams; the cycle-faithful simulators and the tests do.  Every function is
integer or dyadic arithmetic, so each equals its reference bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.quantization import vmax

__all__ = [
    "temporal_stream_len",
    "tub_stream_len",
    "rate_stream_len",
    "encode_temporal",
    "decode_temporal",
    "encode_tub",
    "decode_tub",
    "van_der_corput",
    "encode_rate",
    "decode_rate",
    "ones_count",
    "bit_sparsity_of_stream",
]


def temporal_stream_len(bits: int) -> int:
    """tuGEMM stream slots: 2^(w-1), matching the paper's latency formulas."""
    return 2 ** (bits - 1)


def tub_stream_len(bits: int) -> int:
    """tubGEMM 2-unary stream slots (halved via the weight-2 encoding)."""
    return max(1, 2 ** (bits - 2))


def rate_stream_len(bits: int) -> int:
    """uGEMM rate-coded stream slots."""
    return 2 ** bits


def _slots(n: int, ndim: int, device) -> torch.Tensor:
    return torch.arange(n, dtype=torch.int32, device=device).reshape(
        (-1,) + (1,) * ndim)


def encode_temporal(q: torch.Tensor, bits: int) -> tuple[torch.Tensor, torch.Tensor]:
    """q (int) -> (stream[L, ...] of 0/1 int32, sign[...] int32), L = 2^(w-1)."""
    q = q.to(torch.int32)
    mag, sign = torch.abs(q), torch.sign(q)
    stream = (_slots(temporal_stream_len(bits), q.ndim, q.device)
              < mag[None]).to(torch.int32)
    return stream, sign


def decode_temporal(stream: torch.Tensor, sign: torch.Tensor) -> torch.Tensor:
    return sign * torch.sum(stream, dim=0, dtype=torch.int32)


def encode_tub(q: torch.Tensor, bits: int
               ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """q -> (stream2[L2,...] weight-2 slots, lsb[...] weight-1 bit, sign[...])."""
    q = q.to(torch.int32)
    mag, sign = torch.abs(q), torch.sign(q)
    v1, v0 = mag // 2, mag % 2
    stream2 = (_slots(tub_stream_len(bits), q.ndim, q.device)
               < v1[None]).to(torch.int32)
    return stream2, v0, sign


def decode_tub(stream2: torch.Tensor, lsb: torch.Tensor,
               sign: torch.Tensor) -> torch.Tensor:
    return sign * (2 * torch.sum(stream2, dim=0, dtype=torch.int32) + lsb)


def van_der_corput(n: int, device=None) -> torch.Tensor:
    """First ``n`` points of the base-2 van der Corput sequence, float32.

    The 32-bit reversal of the index, scaled by 2^-32 (the reference's
    uint32 arithmetic, carried out in int64 here).
    """
    v = torch.arange(n, dtype=torch.int64, device=device)
    v = ((v >> 1) & 0x55555555) | ((v & 0x55555555) << 1)
    v = ((v >> 2) & 0x33333333) | ((v & 0x33333333) << 2)
    v = ((v >> 4) & 0x0F0F0F0F) | ((v & 0x0F0F0F0F) << 4)
    v = ((v >> 8) & 0x00FF00FF) | ((v & 0x00FF00FF) << 8)
    v = ((v >> 16) | (v << 16)) & 0xFFFFFFFF
    # the reference converts the uint32 to float32 (one rounding), then
    # divides by 2^32 (exact)
    return v.to(torch.float32) / torch.tensor(2.0 ** 32, dtype=torch.float32,
                                              device=device)


def encode_rate(q: torch.Tensor, bits: int, phase: int = 0,
                reflect: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """q -> (rate stream[2^w, ...] int32, sign[...] int32).

    ``phase`` rotates the comparator sequence by that many slots (the
    1s-count is phase-invariant); ``reflect`` mirrors it (``1 - seq``).
    """
    q = q.to(torch.int32)
    L = rate_stream_len(bits)
    p = torch.abs(q).to(torch.float32) / torch.tensor(
        float(vmax(bits)), dtype=torch.float32, device=q.device)
    seq = van_der_corput(L, device=q.device)
    if phase:
        seq = torch.roll(seq, phase)
    if reflect:
        seq = 1.0 - seq
    seq = seq.reshape((-1,) + (1,) * q.ndim)
    stream = (seq < p[None]).to(torch.int32)
    return stream, torch.sign(q)


def decode_rate(stream: torch.Tensor, sign: torch.Tensor, bits: int) -> torch.Tensor:
    L = stream.shape[0]
    dev = stream.device
    freq = torch.sum(stream, dim=0).to(torch.float32) / torch.tensor(
        float(L), dtype=torch.float32, device=dev)
    return sign.to(torch.float32) * freq * torch.tensor(
        float(vmax(bits)), dtype=torch.float32, device=dev)


def ones_count(stream: torch.Tensor) -> torch.Tensor:
    return torch.sum(stream, dim=0, dtype=torch.int32)


def bit_sparsity_of_stream(q: torch.Tensor, bits: int,
                           scheme: str = "temporal") -> torch.Tensor:
    """Fraction of 0 slots in the unary stream of ``q`` (paper's bit sparsity)."""
    mag = torch.abs(q.to(torch.int64))
    if scheme == "temporal":
        L = temporal_stream_len(bits)
        ones = mag
    elif scheme == "tub":
        L = tub_stream_len(bits)
        ones = (mag + 1) // 2
    else:
        raise ValueError(f"unknown scheme {scheme!r}")
    # the slot counts are integers: their sum is exact, and the reference's
    # float32 mean compiles to sum * fl32(1 / count)
    mean = np.float32(int(ones.sum())) * (np.float32(1.0)
                                          / np.float32(ones.numel()))
    return torch.tensor(np.float32(1.0) - mean / np.float32(L),
                        device=q.device)
