"""Plain reference of the served model: a dense GQA decoder whose every dense
site is a w-bit integer product.

Plain PyTorch in float32 with TF32 off, written from the published equations
and the quantizer the program states, and importing nothing of the program:

* weights per output channel and activations per row, symmetric, w bits:
  ``scale = max(amax, tiny) * fl32(1 / Vmax)`` (a scale under ``tiny`` is
  flushed to 0 and its codes are 0), ``codes = clamp(round(x / scale),
  -Vmax, Vmax)`` rounding half to even, ``Vmax = 2^(w-1) - 1``;
* a site's output is the integer product of the codes (exact in float32:
  every partial sum is an integer under 2^24 at these widths) times the row
  scale, then times the column scale, in that order;
* RMSNorm ``x * rsqrt(mean(x^2) + eps) * g``; rotary embeddings on the two
  halves of each head; causal softmax attention in float32 with ``-1e30``
  masks; the gated MLP ``silu(x Wg) * (x Wu)`` then ``Wd``; untied head.

Every site the program contracts is a site here: ``wq``, ``wk``, ``wv``,
``wo`` (the heads flattened), ``w_gate``, ``w_up``, ``w_down`` of each layer
and ``lm_head``.  The forward runs layer by layer over several sequences
at once, each at its own length, so that one quantized copy of a layer's
weights serves them all.

``precision="tf32"`` is the control: the same computation with the float
products (attention's two) in TF32, the next precision below what the
configuration states.  On a CUDA device it switches TF32 on; on the CPU,
which has none, the operands of those products are rounded to TF32's
10-bit mantissa first.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch

__all__ = ["Reference", "prompt_tokens", "SITES"]

MASK = -1e30
#: the dense sites of one layer, in the order the program contracts them
SITES = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


def prompt_tokens(prompt_seed: int, req_id: int, length: int,
                  vocab: int) -> np.ndarray:
    """The synthetic prompt the benchmark hands the program for a request:
    ``default_rng([prompt_seed, req_id])`` integers below ``vocab``."""
    rng = np.random.default_rng([int(prompt_seed), int(req_id)])
    return rng.integers(0, vocab, length).astype(np.int32)


def _vmax(bits: int) -> int:
    return 2 ** (bits - 1) - 1


def _scale(amax: torch.Tensor, bits: int) -> torch.Tensor:
    tiny = torch.finfo(torch.float32).tiny
    inv = float(np.float32(1.0) / np.float32(_vmax(bits)))
    scale = torch.clamp(amax, min=tiny) * inv
    return torch.where(scale < tiny, torch.zeros_like(scale), scale)


def _codes(x: torch.Tensor, scale: torch.Tensor, bits: int) -> torch.Tensor:
    v = _vmax(bits)
    safe = torch.where(scale == 0, torch.ones_like(scale), scale)
    return torch.clamp(torch.round(x / safe), -v, v)


def quantize_columns(w: torch.Tensor, bits: int):
    """(K, N) float32 -> float32 codes, (N,) scales."""
    scale = _scale(torch.amax(torch.abs(w), dim=0, keepdim=True), bits)
    return _codes(w, scale, bits), scale.reshape(-1)


def quantize_rows(x: torch.Tensor, bits: int):
    """(M, K) float32 -> float32 codes, (M, 1) scales."""
    scale = _scale(torch.amax(torch.abs(x), dim=-1, keepdim=True), bits)
    return _codes(x, scale, bits), scale


def _to_tf32(x: torch.Tensor) -> torch.Tensor:
    """Round float32 to TF32's 10-bit mantissa (to nearest, ties away)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


class Reference:
    """The model of one configuration's sizes on given float32 weights.

    ``sizes``: ``d_model``, ``num_heads``, ``num_kv_heads``, ``head_dim``,
    ``num_layers``, ``vocab_size``, ``rope_theta``, ``rms_eps``.
    ``params``: the weight tree the benchmark made (``embed`` (V, D),
    ``lm_head`` (D, V), ``final_norm``; under ``layers`` stacked ``ln1``,
    ``ln2``, ``attn/{wq,wk,wv}`` (L, D, heads, hd), ``attn/wo`` (L, H, hd,
    D), ``mlp/{w_gate,w_up}`` (L, D, F), ``mlp/w_down`` (L, F, D)).
    """

    def __init__(self, sizes: dict, params: dict, bits: int,
                 precision: str = "fp32") -> None:
        if precision not in ("fp32", "tf32"):
            raise ValueError(f"precision must be fp32 or tf32, got {precision!r}")
        self.s = sizes
        self.p = params
        self.bits = bits
        self.precision = precision

    # -- pieces ---------------------------------------------------------------

    @contextlib.contextmanager
    def _matmul_precision(self):
        old = (torch.backends.cuda.matmul.allow_tf32,
               torch.backends.cudnn.allow_tf32)
        tf32 = self.precision == "tf32"
        torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.backends.cudnn.allow_tf32 = tf32
        try:
            yield
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = old

    def _float_operand(self, x: torch.Tensor) -> torch.Tensor:
        if self.precision == "tf32" and x.device.type != "cuda":
            return _to_tf32(x)
        return x

    def _site(self, x: torch.Tensor, w_codes, w_scale):
        """(rows, float output, integer product) of one dense site."""
        xc, xs = quantize_rows(x, self.bits)
        acc = xc @ w_codes
        return acc * xs * w_scale.reshape(1, -1), acc

    def _rmsnorm(self, g: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        var = torch.mean(torch.square(x), dim=-1, keepdim=True)
        return x * torch.rsqrt(var + self.s["rms_eps"]) * g

    def _rope(self, x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
        d = x.shape[-1]
        half = d // 2
        exponent = torch.arange(0, half, dtype=torch.float32,
                                device=x.device) / half
        inv = 1.0 / (float(self.s["rope_theta"]) ** exponent)
        angles = (positions.to(torch.float32)[:, None] * inv)[:, None, :]
        sin, cos = torch.sin(angles), torch.cos(angles)
        x1, x2 = x[..., :half], x[..., half:]
        return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)

    def _attention(self, q, k, v) -> torch.Tensor:
        """q (S, H, hd), k / v (S, KVH, hd), causal -> (S, H, hd)."""
        s, h, d = q.shape
        group = h // k.shape[1]
        k = k.repeat_interleave(group, dim=1)
        v = v.repeat_interleave(group, dim=1)
        q, k, v = (self._float_operand(t) for t in (q, k, v))
        scores = torch.einsum("qhd,khd->hqk", q, k) / math.sqrt(d)
        pos = torch.arange(s, device=q.device)
        causal = pos[:, None] >= pos[None, :]
        scores = torch.where(causal[None], scores,
                             torch.full((), MASK, device=q.device))
        w = self._float_operand(torch.softmax(scores, dim=-1))
        return torch.einsum("hqk,khd->qhd", w, v)

    # -- the forward ----------------------------------------------------------

    @torch.no_grad()
    def run(self, sequences: list[torch.Tensor], logit_rows: list,
            keep: dict | None = None, layers=(0,)):
        """Run every sequence (1-D token ids) through the model.

        ``logit_rows[i]``: the positions of sequence ``i`` whose logits are
        returned (a 1-D index tensor).  ``keep``: ``{i: positions}`` of the
        rows whose integer products at the sites of ``layers`` are kept.
        Returns ``(logits list, {layer: {i: {site: (rows, N) float32}}})``.
        """
        p, s = self.p, self.s
        h, kvh, hd = s["num_heads"], s["num_kv_heads"], s["head_dim"]
        lay = p["layers"]
        keep = keep or {}
        products: dict = {li: {i: {} for i in keep} for li in layers}
        with self._matmul_precision():
            xs = [p["embed"][t.long()].to(torch.float32) for t in sequences]
            pos = [torch.arange(t.shape[0], device=t.device) for t in sequences]
            for li in range(s["num_layers"]):
                codes = {}
                for grp, name in (("attn", "wq"), ("attn", "wk"), ("attn", "wv"),
                                  ("attn", "wo"), ("mlp", "w_gate"),
                                  ("mlp", "w_up"), ("mlp", "w_down")):
                    w = lay[grp][name][li]
                    codes[name] = quantize_columns(
                        w.reshape(-1, w.shape[-1]) if name == "wo"
                        else w.reshape(w.shape[0], -1), self.bits)
                for i, x in enumerate(xs):
                    store = (products[li][i] if li in products and i in keep
                             else None)

                    def site(name, inp):
                        out, acc = self._site(inp, *codes[name])
                        if store is not None:
                            store[name] = acc[keep[i]]
                        return out

                    n = x.shape[0]
                    a = self._rmsnorm(lay["ln1"][li], x)
                    q = site("wq", a).reshape(n, h, hd)
                    k = site("wk", a).reshape(n, kvh, hd)
                    v = site("wv", a).reshape(n, kvh, hd)
                    q = self._rope(q, pos[i])
                    k = self._rope(k, pos[i])
                    o = self._attention(q, k, v).reshape(n, h * hd)
                    x = x + site("wo", o)
                    m = self._rmsnorm(lay["ln2"][li], x)
                    g = site("w_gate", m)
                    u = site("w_up", m)
                    x = x + site("w_down", torch.nn.functional.silu(g) * u)
                    xs[i] = x
                del codes
            head = quantize_columns(p["lm_head"], self.bits)
            logits = []
            for x, rows in zip(xs, logit_rows):
                y = self._rmsnorm(p["final_norm"], x[rows])
                logits.append(self._site(y, *head)[0])
        return logits, products
