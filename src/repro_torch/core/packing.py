"""Bit-packed weight stores: int2/int4/int8 codes in int32 words.

A float parameter leaf is re-quantized on every call and occupies 4 bytes
per element whatever width a site runs at.  This module freezes a weight at
its width as a :class:`PackedQuantized` store: the *exact* int8 codes the
quantizer produces, packed ``32 // bits`` to an int32 word, with the
per-channel scales carried alongside.

**Word layout.**  Along the packed axis (the contraction/K axis, ``-2`` of
the ``(k, n)`` weight view), each group of ``cpw = 32 // bits`` consecutive
codes forms one int32 word; code ``j`` of the group occupies bit lanes
``[j*bits, (j+1)*bits)`` — lowest lanes first, matching the byte-level
crumb/nibble order of :func:`repro_torch.kernels.ops.pack_values`.  Words
are assembled in int64 and narrowed to int32 by two's complement, so the
top lane may set the sign bit without any shift overflowing; unpacking
sign-extends each field, so the round trip is exact for every signed
``bits``-wide code, ``-2^(bits-1)`` included.  Lengths that do not divide
``cpw`` are zero-padded into the last word and truncated back on unpack.

**Scale placement.**  ``scale`` is stored verbatim from the quantizer —
per output channel, ``(…, 1, n)`` — so :meth:`PackedQuantized.dequantize`
is bit-identical to ``Quantized.dequantize()`` on the same codes.

**Grid shard packing** (``grid_x > 1``).  ``GridBackend.execute`` splits
the contraction dim into ``grid_x`` ceil-sized row bands.  A grid store
packs each band's codes *separately* (``packed`` gains a shard axis:
``(*lead, grid_x, shard_words, n)``), so no int32 word straddles a shard
boundary and every unit can decode its own rows without touching a
neighbour's words.  The reassembled codes equal the full-weight
quantization codes — the same quantize-then-slice contract
``GridBackend.execute`` applies — so grid execution from the packed store
stays bit-identical.

``PackedQuantized`` is a plain dataclass of tensors; ``store[i]`` slices a
stacked store ``(L, words, n)`` along its leading axis, as the layer loop
does.  The logical ``shape`` / ``ndim`` / ``reshape`` report the
*unpacked* weight geometry, so shape-driven code keeps working.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.core.quantization import Quantized, _absmax_scale, _codes

__all__ = [
    "PACK_BITS",
    "PackedQuantized",
    "codes_per_word",
    "is_packed",
    "pack_codes",
    "unpack_codes",
    "unpack_fields",
    "from_quantized",
    "pack_quantized",
    "packed_widths",
]

#: operand widths with a whole number of codes per int32 word
PACK_BITS = (2, 4, 8)

def codes_per_word(bits: int) -> int:
    """How many ``bits``-wide codes one int32 word holds (16 / 8 / 4)."""
    if bits not in PACK_BITS:
        raise ValueError(f"packable widths are {PACK_BITS}, got bits={bits}")
    return 32 // bits


def pack_codes(codes: torch.Tensor, bits: int, axis: int = -2) -> torch.Tensor:
    """Pack signed ``bits``-wide codes into int32 words along ``axis``.

    ``codes`` — any integer tensor whose values fit ``bits`` signed bits
    (the int8 container ``quantize`` emits).  The packed axis shrinks to
    ``ceil(len / cpw)`` words; a non-divisible length is zero-padded into
    the last word.  Exact inverse: :func:`unpack_codes` with the original
    length.
    """
    cpw = codes_per_word(bits)
    ax = axis % codes.ndim
    x = torch.movedim(codes, ax, -1).to(torch.int64)
    n = x.shape[-1]
    words = -(-n // cpw)
    x = torch.nn.functional.pad(x, (0, words * cpw - n))
    x = x.reshape(*x.shape[:-1], words, cpw)
    shifts = torch.arange(cpw, dtype=torch.int64, device=x.device) * bits
    # disjoint bit fields: the sum is the unsigned 32-bit word pattern
    word = torch.sum((x & ((1 << bits) - 1)) << shifts, dim=-1)
    word = torch.where(word >= 2 ** 31, word - 2 ** 32, word)
    # row-major words: the packed GEMM reads (words, n) without a copy
    return torch.movedim(word.to(torch.int32), -1, ax).contiguous()


def unpack_codes(packed: torch.Tensor, bits: int, length: int,
                 axis: int = -2) -> torch.Tensor:
    """Exact inverse of :func:`pack_codes`: int8 codes of ``length`` along
    ``axis``, each field sign-extended."""
    cpw = codes_per_word(bits)
    ax = axis % packed.ndim
    x = torch.movedim(packed, ax, -1).to(torch.int64) & 0xFFFFFFFF
    flat = unpack_fields(x, bits, cpw).reshape(*x.shape[:-1], x.shape[-1] * cpw)
    return torch.movedim(flat[..., :length].to(torch.int8), -1, ax)


def unpack_fields(v: torch.Tensor, bits: int, count: int) -> torch.Tensor:
    """The ``count`` sign-extended ``bits``-wide fields of the unsigned
    containers ``v`` (int64), lowest field first, on a new last axis."""
    shifts = torch.arange(count, dtype=torch.int64, device=v.device) * bits
    field = (v[..., None] >> shifts) & ((1 << bits) - 1)
    return field - ((field >> (bits - 1)) << bits)


@dataclasses.dataclass
class PackedQuantized:
    """A weight frozen at its width: packed int32 codes + scales.

    ``packed`` — int32 words, ``(*lead, words, n)`` (flat) or
    ``(*lead, grid_x, shard_words, n)`` (grid store); ``scale`` — the
    quantizer's float32 scales, broadcastable against the unpacked
    ``(*lead, k, n)`` codes; ``bits`` / ``k`` / ``tail`` / ``grid_x``:
    operand width, logical length of the packed axis, the logical trailing
    dims (``prod(tail) == n``) the 2-D code view folds, and the number of
    K bands; ``k_shape``: the logical dims folding to ``k`` (``()`` = the
    single axis ``(k,)``).
    """

    packed: torch.Tensor
    scale: torch.Tensor
    bits: int
    k: int
    tail: tuple[int, ...]
    grid_x: int = 1
    k_shape: tuple[int, ...] = ()

    # -- logical geometry (the *unpacked* weight's) -------------------------

    @property
    def _lead_ndim(self) -> int:
        return self.packed.ndim - (3 if self.grid_x > 1 else 2)

    @property
    def shape(self) -> tuple[int, ...]:
        return (*self.packed.shape[:self._lead_ndim],
                *(self.k_shape or (self.k,)), *self.tail)

    def reshape(self, *shape) -> "PackedQuantized":
        """Metadata-only regroup of the logical dims (no data movement):
        the target must regroup into ``(*k_dims, *tail_dims)`` with the
        tail folding to ``n_out`` and the rest to ``k``; only unstacked
        stores reshape."""
        if len(shape) == 1 and isinstance(shape[0], (tuple, list, torch.Size)):
            shape = tuple(shape[0])
        shape = tuple(int(s) for s in shape)
        if self._lead_ndim:
            raise ValueError(
                f"cannot reshape a stacked packed store (lead dims "
                f"{tuple(self.packed.shape[:self._lead_ndim])}); slice it "
                f"first")
        tail_len, prod = 0, 1
        while prod < self.n_out and tail_len < len(shape):
            tail_len += 1
            prod *= shape[len(shape) - tail_len]
        k_dims = shape[:len(shape) - tail_len]
        if prod != self.n_out or math.prod(k_dims) != self.k:
            raise ValueError(
                f"cannot reshape packed store of logical shape {self.shape} "
                f"(k={self.k}, n_out={self.n_out}) to {shape}: the target "
                f"must regroup into (k dims, tail dims) without mixing the "
                f"contraction and output axes")
        return dataclasses.replace(
            self, tail=shape[len(shape) - tail_len:],
            k_shape=() if k_dims == (self.k,) else k_dims)

    def __getitem__(self, i: int) -> "PackedQuantized":
        """Slice ``i`` of a stacked store's leading axis (a view, like a
        tensor's ``[i]``)."""
        if not self._lead_ndim:
            raise IndexError("only a stacked packed store has a leading "
                             "axis to index")
        return dataclasses.replace(self, packed=self.packed[i],
                                   scale=self.scale[i])

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def size(self) -> int:
        return math.prod(self.shape)

    @property
    def n_out(self) -> int:
        return math.prod(self.tail)

    # -- bytes accounting ---------------------------------------------------

    @property
    def stored_bytes(self) -> int:
        """Bytes the packed store actually occupies (words + scales)."""
        return (self.packed.numel() * 4
                + self.scale.numel() * self.scale.element_size())

    @property
    def float32_bytes(self) -> int:
        """Bytes the float32 leaf it replaced occupied."""
        return self.size * 4

    # -- decode -------------------------------------------------------------

    def codes(self) -> torch.Tensor:
        """The exact int8 quantizer codes, ``(*lead, k, n)``."""
        if self.grid_x > 1:
            ks = -(-self.k // self.grid_x)
            sub = unpack_codes(self.packed, self.bits, ks, axis=-2)
            full = sub.reshape(*sub.shape[:-3], self.grid_x * ks,
                               sub.shape[-1])
            return full[..., :self.k, :]
        return unpack_codes(self.packed, self.bits, self.k, axis=-2)

    def quantized(self) -> Quantized:
        """The equivalent :class:`Quantized` — what ``quantize(w, bits)``
        produced before packing."""
        return Quantized(values=self.codes(), scale=self.scale, bits=self.bits)

    def dequantize(self) -> torch.Tensor:
        """Float32 weight in the logical shape (codes x scale)."""
        dq = self.codes().to(self.scale.dtype) * self.scale
        return dq.reshape(self.shape)


def is_packed(leaf) -> bool:
    """True iff ``leaf`` is a :class:`PackedQuantized` store."""
    return isinstance(leaf, PackedQuantized)


def from_quantized(q: Quantized, *, tail: tuple[int, ...] | None = None,
                   k_shape: tuple[int, ...] = (),
                   grid_x: int = 1) -> PackedQuantized:
    """Pack an existing :class:`Quantized` (codes ``(*lead, k, n)``).

    ``tail`` defaults to ``(n,)``; ``k_shape`` names the logical dims the
    packed axis folds (``()`` = the single axis); ``grid_x`` > 1 packs per
    K band as described in the module docstring.
    """
    values = q.values
    if values.ndim < 2:
        raise ValueError(f"packing wants (…, k, n) codes, got {tuple(values.shape)}")
    k, n = int(values.shape[-2]), int(values.shape[-1])
    tail = (n,) if tail is None else tuple(int(t) for t in tail)
    if math.prod(tail) != n:
        raise ValueError(f"tail {tail} does not fold the {n} output columns")
    k_shape = tuple(int(s) for s in k_shape)
    if k_shape and math.prod(k_shape) != k:
        raise ValueError(f"k_shape {k_shape} does not fold the packed "
                         f"length {k}")
    return PackedQuantized(packed=_pack_bands(values, q.bits, grid_x),
                           scale=q.scale, bits=int(q.bits), k=k, tail=tail,
                           grid_x=int(grid_x), k_shape=k_shape)


def _pack_bands(values: torch.Tensor, bits: int, grid_x: int) -> torch.Tensor:
    """Words of ``(*lead, k, n)`` codes: flat ``(*lead, words, n)``, or per
    ceil-sized K band ``(*lead, grid_x, shard_words, n)`` when ``grid_x >
    1`` (the last bands zero-padded to the band length)."""
    if grid_x < 1:
        raise ValueError(f"grid_x must be >= 1, got {grid_x}")
    if grid_x == 1:
        return pack_codes(values, bits, axis=-2)
    k = values.shape[-2]
    ks = -(-k // grid_x)
    banded = torch.nn.functional.pad(values, (0, 0, 0, grid_x * ks - k))
    return pack_codes(banded.reshape(*values.shape[:-2], grid_x, ks,
                                     values.shape[-1]), bits, axis=-2)


def pack_quantized(w: torch.Tensor, *, bits: int, k: int | None = None,
                   n_out: int | None = None,
                   grid_x: int = 1) -> PackedQuantized:
    """Quantize a float leaf exactly as ``models/common.dense`` would and
    freeze the codes packed.

    ``w`` — a ``(…, k, *tail)`` float leaf (a dense weight, possibly
    stacked along leading axes).  ``k`` / ``n_out`` name the per-call
    contraction geometry; they default to ``w.shape[0]`` / ``w.numel() //
    k`` — the unstacked case.  Each ``(k, n_out)`` slice is quantized per
    output channel with its *own* scales, so packed execution is
    bit-identical to quantize-on-the-fly execution.  ``grid_x`` > 1 packs
    each slice per K band (the module docstring's grid stores).
    """
    if is_packed(w):
        raise ValueError(
            f"leaf is already a PackedQuantized store at {w.bits}-bit — "
            "packing packed codes at a second width compounds quantization "
            "error; pack from the float parameters")
    if w.ndim < 2:
        raise ValueError(f"packing wants a >=2-D weight, got shape {tuple(w.shape)}")
    k = int(w.shape[0]) if k is None else int(k)
    n_out = w.numel() // k if n_out is None else int(n_out)
    # Split shape into (*lead, *k_dims, *tail): the trailing dims fold to
    # n_out, the middle ones to k (possibly several — e.g. the attention
    # out-projection's (heads, head_dim)), the rest are stack dims.
    tail_len, prod = 0, 1
    while prod < n_out and tail_len < w.ndim:
        tail_len += 1
        prod *= int(w.shape[w.ndim - tail_len])
    bad = prod != n_out
    k_len, kprod = 0, 1
    while not bad and kprod < k and k_len + tail_len < w.ndim:
        k_len += 1
        kprod *= int(w.shape[w.ndim - tail_len - k_len])
    lead_len = w.ndim - tail_len - k_len
    if (bad or kprod != k
            or math.prod(w.shape[:lead_len]) * k * n_out != w.numel()):
        raise ValueError(
            f"leaf shape {tuple(w.shape)} is not a stack of "
            f"(k={k}, n_out={n_out}) matrices")
    lead = tuple(int(s) for s in w.shape[:lead_len])
    k_dims = tuple(int(s) for s in w.shape[lead_len:lead_len + k_len])
    tail = tuple(int(t) for t in w.shape[lead_len + k_len:])
    # One (k, n_out) slice at a time, each per output channel with its own
    # scales: assembling the words of a whole stacked leaf at once would
    # hold int64 temporaries of 8 bytes an element.
    words, scales = [], []
    for w2 in w.reshape(-1, k, n_out):
        w2 = w2.to(torch.float32)
        scale = _absmax_scale(w2, bits, axes=(0,))
        words.append(_pack_bands(_codes(w2, scale, bits), bits, grid_x))
        scales.append(scale)
    word_shape = words[0].shape[:-1]       # (words,) or (grid_x, shard_words)
    return PackedQuantized(
        packed=torch.stack(words).reshape(*lead, *word_shape, n_out),
        scale=torch.stack(scales).reshape(*lead, 1, n_out), bits=int(bits),
        k=k, tail=tail, grid_x=int(grid_x),
        k_shape=() if k_dims == (k,) else k_dims)


def packed_widths(params) -> dict[str, int]:
    """``{site-path: bits}`` for every packed store in a nested-dict
    parameter tree (paths join the sorted keys with ``/``)."""
    out: dict[str, int] = {}

    def walk(tree, prefix):
        if is_packed(tree):
            out["/".join(prefix)] = int(tree.bits)
        elif isinstance(tree, dict):
            for key in sorted(tree):
                walk(tree[key], prefix + (str(key),))
        elif isinstance(tree, (list, tuple)):
            for i, leaf in enumerate(tree):
                walk(leaf, prefix + (str(i),))

    walk(params, ())
    return out
