"""Unary bitstream generation on tensors (UnarySim RNG / SourceGen / BSGen).

The UnarySim hardware decomposition splits a bitstream source into three
stages, all kept here:

* **RNG** — a shared pseudo-random *integer* sequence ``r[t] in [0, 2^bits)``
  per cycle: a Sobol low-discrepancy sequence (the uGEMM paper's choice) or
  a maximal-length Fibonacci LFSR.
* **SourceGen** — probability pre-scaling: a value is converted once to an
  integer comparator threshold ``tau = round(p * 2^bits)`` (unipolar) or
  ``round((x+1)/2 * 2^bits)`` (bipolar), so the per-cycle datapath is
  integer-only.
* **BSGen** — the per-cycle comparator ``bit[t] = r[t] < tau``.

Everything is seeded and deterministic: sequences derive from a
SplitMix-style integer hash of ``(seed, dim, period)``, with no global RNG
state.  The RNG stage is numpy integer arithmetic, a copy of the
reference's (``SOBOL_DIMS``, ``LFSR_TAPS``, ``_hash64``, the direction
numbers and period masks), so sequences equal the reference's bit for bit.
Operand decorrelation comes from distinct Sobol dimensions.

Two execution forms, tested bit-identical:

* the **vectorized** form — the whole ``(L, ...)`` bitstream tensor from
  one broadcast comparator;
* the **per-cycle reference** — a loop that re-derives each ``r[t]`` from
  the cycle counter (Sobol: XOR-fold of direction numbers over the
  counter's set bits; LFSR: stepping the shift register), the
  hardware-faithful slow path.

Sobol sequences use binary (non-Gray) indexing, so the first full period
``2^bits`` is a permutation of ``[0, 2^bits)``; streams longer than one
period re-scramble each period with a fresh XOR digital shift.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

__all__ = [
    "SOBOL_DIMS", "LFSR_TAPS",
    "sobol_direction_numbers", "sobol_sequence", "lfsr_sequence",
    "rng_sequence", "rng_sequence_scan",
    "source_gen", "source_gen_codes", "decode_counts",
    "bsgen", "bsgen_scan", "unipolar_and", "bipolar_xnor",
]

_M64 = (1 << 64) - 1


def _hash64(*keys: int) -> int:
    """Deterministic 64-bit mix of integer keys (SplitMix64 finalizer)."""
    h = 0x9E3779B97F4A7C15
    for k in keys:
        h = (h ^ (int(k) & _M64)) * 0xBF58476D1CE4E5B9 & _M64
        h ^= h >> 27
        h = h * 0x94D049BB133111EB & _M64
        h ^= h >> 31
    return h


# ---------------------------------------------------------------------------
# RNG stage: Sobol direction numbers + LFSR taps
# ---------------------------------------------------------------------------

#: Joe-Kuo primitive-polynomial parameters ``(s, a, m_init)`` per Sobol
#: dimension.  Dimension 0 is the degenerate bit-reversal (van der Corput
#: base 2) dimension; its generator matrix is the identity.
SOBOL_DIMS: tuple[tuple[int, int, tuple[int, ...]], ...] = (
    (0, 0, ()),                 # dim 0: van der Corput
    (1, 0, (1,)),               # dim 1
    (2, 1, (1, 3)),             # dim 2
    (3, 1, (1, 3, 1)),          # dim 3
    (3, 2, (1, 1, 1)),          # dim 4
    (4, 1, (1, 1, 3, 3)),       # dim 5
    (4, 4, (1, 3, 5, 13)),      # dim 6
    (5, 2, (1, 1, 5, 5, 17)),   # dim 7
)

#: Maximal-length Fibonacci LFSR tap positions (1-indexed, MSB first) per
#: register width; period ``2^bits - 1`` (the all-zero state never occurs).
LFSR_TAPS: dict[int, tuple[int, ...]] = {
    2: (2, 1), 3: (3, 2), 4: (4, 3), 5: (5, 3),
    6: (6, 5), 7: (7, 6), 8: (8, 6, 5, 4),
}


@functools.lru_cache(maxsize=None)
def sobol_direction_numbers(bits: int, dim: int) -> tuple[int, ...]:
    """Direction numbers ``v_j`` (``j = 0..bits-1``) for one Sobol dimension.

    ``v_j = m_j << (bits - 1 - j)`` with odd ``m_j < 2^(j+1)``, so the
    generator matrix is unit upper triangular — each dimension's first
    ``2^bits`` points are a permutation of ``[0, 2^bits)``.
    """
    if not 0 <= dim < len(SOBOL_DIMS):
        raise ValueError(f"sobol dim {dim} not in [0, {len(SOBOL_DIMS)})")
    if dim == 0:
        return tuple(1 << (bits - 1 - j) for j in range(bits))
    s, a, m_init = SOBOL_DIMS[dim]
    m = list(m_init)
    while len(m) < bits:
        j = len(m)
        val = m[j - s] ^ (m[j - s] << s)
        for k in range(1, s):
            if (a >> (s - 1 - k)) & 1:
                val ^= m[j - k] << k
        m.append(val)
    return tuple(m[j] << (bits - 1 - j) for j in range(bits))


def _period_masks(bits: int, dim: int, seed: int, periods: int) -> np.ndarray:
    """XOR digital-shift masks, one per ``2^bits`` period of the stream."""
    mask = (1 << bits) - 1
    return np.asarray([_hash64(seed, dim, p) & mask for p in range(periods)],
                      np.int32)


def sobol_sequence(bits: int, length: int, *, dim: int = 0,
                   seed: int = 0) -> np.ndarray:
    """``length`` Sobol integers in ``[0, 2^bits)`` (binary indexing).

    Each ``2^bits`` period is the full permutation, XOR-scrambled by a
    per-``(seed, dim, period)`` digital shift.
    """
    period = 1 << bits
    dirs = sobol_direction_numbers(bits, dim)
    n = np.arange(period, dtype=np.int64)
    base = np.zeros(period, np.int64)
    for j in range(bits):
        base ^= np.where((n >> j) & 1, dirs[j], 0)
    masks = _period_masks(bits, dim, seed, -(-length // period))
    out = (base[None, :] ^ masks[:, None].astype(np.int64)).reshape(-1)
    return out[:length].astype(np.int32)


def lfsr_sequence(bits: int, length: int, *, dim: int = 0,
                  seed: int = 0) -> np.ndarray:
    """``length`` states of a maximal Fibonacci LFSR in ``[1, 2^bits)``.

    The register restarts from a fresh hashed nonzero state every
    ``2^bits - 1`` cycles.  Unlike Sobol, the all-zero value never appears,
    so unipolar decode carries an O(1/2^bits) bias — Sobol is the default
    RNG; the LFSR is the cheap-hardware alternative.
    """
    if bits not in LFSR_TAPS:
        raise ValueError(f"no maximal LFSR taps for bits={bits}")
    taps = LFSR_TAPS[bits]
    period = (1 << bits) - 1
    out = np.empty(length, np.int32)
    state = 0
    for t in range(length):
        if t % period == 0:
            state = (_hash64(seed, dim, t // period) % period) + 1
        out[t] = state
        fb = 0
        for pos in taps:
            fb ^= (state >> (pos - 1)) & 1
        state = ((state << 1) | fb) & ((1 << bits) - 1)
    return out


def rng_sequence(kind: str, bits: int, length: int, *, dim: int = 0,
                 seed: int = 0, device=None) -> torch.Tensor:
    """The shared RNG stage: ``(length,)`` int32 comparator inputs."""
    if kind == "sobol":
        seq = sobol_sequence(bits, length, dim=dim, seed=seed)
    elif kind == "lfsr":
        seq = lfsr_sequence(bits, length, dim=dim, seed=seed)
    else:
        raise ValueError(f"unknown RNG kind {kind!r} (sobol|lfsr)")
    return torch.from_numpy(np.asarray(seq, np.int32)).to(device)


# ---------------------------------------------------------------------------
# Per-cycle reference: re-derive r[t] from the cycle counter
# ---------------------------------------------------------------------------

def _sobol_point(n: int, dirs: tuple[int, ...], bits: int) -> int:
    """XOR-fold of direction numbers over the set bits of counter ``n``."""
    x = 0
    for j in range(bits):
        if (n >> j) & 1:
            x ^= dirs[j]
    return x


def rng_sequence_scan(kind: str, bits: int, length: int, *, dim: int = 0,
                      seed: int = 0) -> torch.Tensor:
    """Per-cycle re-derivation of :func:`rng_sequence`.

    The hardware-faithful slow path: Sobol points are rebuilt from the
    cycle counter, the LFSR steps its register — one value per cycle.
    """
    out = []
    if kind == "sobol":
        period = 1 << bits
        dirs = sobol_direction_numbers(bits, dim)
        masks = _period_masks(bits, dim, seed, -(-length // period))
        for n in range(length):
            out.append(_sobol_point(n % period, dirs, bits)
                       ^ int(masks[n // period]))
    elif kind == "lfsr":
        if bits not in LFSR_TAPS:
            raise ValueError(f"no maximal LFSR taps for bits={bits}")
        period = (1 << bits) - 1
        taps = LFSR_TAPS[bits]
        state = 1
        for n in range(length):
            if n % period == 0:
                state = (_hash64(seed, dim, n // period) % period) + 1
            out.append(state)
            fb = 0
            for pos in taps:
                fb ^= (state >> (pos - 1)) & 1
            state = ((state << 1) | fb) & ((1 << bits) - 1)
    else:
        raise ValueError(f"unknown RNG kind {kind!r} (sobol|lfsr)")
    return torch.tensor(out, dtype=torch.int32)


# ---------------------------------------------------------------------------
# SourceGen: probability pre-scaling to integer thresholds
# ---------------------------------------------------------------------------

def source_gen(prob, bits: int, mode: str = "unipolar") -> torch.Tensor:
    """Pre-scale values to integer comparator thresholds in ``[0, 2^bits]``.

    * ``unipolar`` — ``prob`` holds probabilities in [0, 1];
      ``tau = round(p * 2^bits)``.
    * ``bipolar`` — ``prob`` holds values in [-1, 1], mapped through
      ``p = (x + 1) / 2`` first; multiplication is XNOR
      (:func:`bipolar_xnor`).
    """
    p = torch.as_tensor(prob).to(torch.float32)
    if mode == "bipolar":
        p = (p + 1.0) * 0.5
    elif mode != "unipolar":
        raise ValueError(f"unknown mode {mode!r} (unipolar|bipolar)")
    period = 1 << bits
    return torch.clamp(torch.round(p * period), 0, period).to(torch.int32)


def source_gen_codes(mags, bits: int) -> torch.Tensor:
    """SourceGen for signed-magnitude integer codes.

    ``mags`` are magnitudes ``|q| in [0, vmax]``; the threshold is
    ``round(|q| * 2^bits / vmax)`` computed exactly in integers.
    """
    period = 1 << bits
    v = (1 << (bits - 1)) - 1
    m = torch.as_tensor(mags).to(torch.int32)
    return torch.div(2 * m * period + v, 2 * v, rounding_mode="floor")


def decode_counts(counts, stream_len: int, mode: str = "unipolar"):
    """Invert SourceGen: slot counts back to probabilities / values."""
    p = torch.as_tensor(counts).to(torch.float32) / stream_len
    return 2.0 * p - 1.0 if mode == "bipolar" else p


# ---------------------------------------------------------------------------
# BSGen: the per-cycle comparator
# ---------------------------------------------------------------------------

def bsgen(thresholds, rng_seq) -> torch.Tensor:
    """Comparator bitstreams: ``bit[t, ...] = rng_seq[t] < thresholds[...]``.

    Returns an int8 tensor of shape ``(len(rng_seq), *thresholds.shape)``
    with values in {0, 1} — the whole stream from one broadcast compare.
    """
    tau = torch.as_tensor(thresholds).to(torch.int32)
    seq = torch.as_tensor(rng_seq).to(device=tau.device, dtype=torch.int32)
    seq = seq.reshape((seq.shape[0],) + (1,) * tau.ndim)
    return (seq < tau[None]).to(torch.int8)


def bsgen_scan(thresholds, *, kind: str, bits: int, length: int,
               dim: int = 0, seed: int = 0) -> torch.Tensor:
    """Per-cycle BSGen: RNG stepping and one comparison per cycle, as the
    hardware would issue them — the slow reference for :func:`bsgen` of
    :func:`rng_sequence`."""
    tau = torch.as_tensor(thresholds).to(torch.int32)
    seq = rng_sequence_scan(kind, bits, length, dim=dim, seed=seed)
    return torch.stack([(int(seq[t]) < tau).to(torch.int8)
                        for t in range(length)])


def unipolar_and(bit_a, bit_b) -> torch.Tensor:
    """Unipolar multiply: AND gate (``p_out = p_a * p_b`` for independent
    streams)."""
    return torch.as_tensor(bit_a) * torch.as_tensor(bit_b)


def bipolar_xnor(bit_a, bit_b) -> torch.Tensor:
    """Bipolar multiply: XNOR gate (``x_out = x_a * x_b`` in value space)."""
    a = torch.as_tensor(bit_a)
    b = torch.as_tensor(bit_b)
    return (1 - (a ^ b)).to(torch.int8)
