"""Plain reference of the served mixture-of-experts model: Phi-3.5-MoE's
decoder (GQA attention, sparsemixer top-2 over SwiGLU experts, no shared
expert), its attention sites and routed experts as w-bit integer products.

Plain PyTorch in float32 with TF32 off, written from the published
equations and the quantizer the program states, and importing nothing of
the program.  The attention half of a layer, the quantizer, RMSNorm, RoPE
and the untied head are ``bench/reference.py``'s; here:

* the router is a float matmul ``h @ W_router`` (D, E), not a site: its
  float32 logits are the products' sum accumulated in float64 and rounded
  once, which no row's neighbours can change;
* sparsemixer at inference (``modeling_phimoe.py``, without training's
  jitter): the first expert ``e1`` is the best logit ``m1``, weighted by the
  softmax at ``e1`` of the logits with every ``j`` masked where
  ``(m1 - s_j) / max(|s_j|, m1) > 2 eps``; the second ``e2`` is the best of
  the rest, weighted the same way over the rest (``eps`` the published
  ``router_jitter_noise``); no renormalization; ties to the lower index;
* each expert computes ``w_down(silu(x w_gate) * (x w_up))``, every matmul
  a site (weights per output channel, activations per row), on exactly
  the rows routed to it, scaled by their weights and added to those rows.

Expert parallelism: the weights a rank is handed hold its ``E / world``
experts of every layer (``layers/moe/w_*`` of shape (L, E / world, ...)),
experts ``rank * E / world`` onwards.  Each rank computes its experts' part
of every sequence's rows and the ranks' parts are added with
``torch.distributed.all_reduce`` (SUM), once a layer; attention, the router,
the embedding and the head are computed whole on every rank.

``SITES``: the sites the check compares at layer 0, those the probe can
place by counting calls of a name (an expert's sites are called once per
local expert a layer, so they are held bit for bit by the CPU tests
instead).  ``precision="tf32"`` is the control, as in ``bench/reference.py``:
attention's two float products in TF32, and the router's operands rounded
to TF32's 10-bit mantissa.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from bench.reference import (Reference as _Attention, _to_tf32,
                             prompt_tokens, quantize_columns, quantize_rows)

__all__ = ["Reference", "prompt_tokens", "SITES", "sparsemixer",
           "expert_layer"]

SITES = ("wq", "wk", "wv", "wo")
#: an expert's sites, in the order the program contracts them
EXPERT_SITES = ("w_gate", "w_up", "w_down")


def sparsemixer(logits: torch.Tensor, eps: float):
    """(experts (T, 2), weights (T, 2)) of the router's float logits."""
    picked, weights = [], []
    rest = logits.clone()
    for _ in range(2):
        best, at = torch.max(rest, dim=-1, keepdim=True)
        scale = torch.maximum(torch.abs(logits), best)
        far = (best - logits) / scale > 2.0 * eps
        kept = torch.where(far, torch.full_like(rest, float("-inf")), rest)
        weights.append(torch.gather(torch.softmax(kept, dim=-1), -1, at))
        picked.append(at)
        rest = rest.scatter(-1, at, float("-inf"))
    return torch.cat(picked, dim=-1), torch.cat(weights, dim=-1)


def _codes(w: torch.Tensor, bits: int | None):
    """(codes, scales) of a (K, N) weight; (the weight, None) in float."""
    return (w, None) if bits is None else quantize_columns(w, bits)


def _site(x: torch.Tensor, codes, scale, bits: int | None):
    """(float output, integer product) of one site; (x @ w, None) with
    ``bits`` None, the float model the CPU tests hold the engine to."""
    if bits is None:
        return x @ codes, None
    xc, xs = quantize_rows(x, bits)
    acc = xc @ codes
    return acc * xs * scale.reshape(1, -1), acc


def router_logits(h: torch.Tensor, router: torch.Tensor,
                  tf32: bool = False) -> torch.Tensor:
    """float32 logits ``h @ router``, accumulated in float64; ``tf32``: the
    operands rounded to TF32 first."""
    if tf32:
        h, router = _to_tf32(h), _to_tf32(router)
    return (h.to(torch.float64) @ router.to(torch.float64)).to(torch.float32)


def expert_layer(h: torch.Tensor, router: torch.Tensor, experts: tuple,
                 eps: float, bits: int | None, first: int = 0,
                 tf32: bool = False, products: dict | None = None):
    """The routed experts' part of ``h`` (T, D) held by one rank: the
    router's logits (:func:`router_logits`), sparsemixer, then each local
    expert (``experts``: the (E_local, ...) ``w_gate``, ``w_up``,
    ``w_down`` stacks; ``first`` the global index of the first) on exactly
    its routed rows.  ``bits`` None computes the experts in float32.
    ``products`` (a dict) receives ``{(global expert, site): (rows routed
    to it, integer product)}``."""
    logits = router_logits(h, router, tf32)
    idx, w = sparsemixer(logits, eps)
    out = torch.zeros_like(h)
    wg, wu, wd = experts
    for j in range(wg.shape[0]):
        hit = idx == first + j
        rows = torch.nonzero(hit.any(dim=-1)).flatten()
        if rows.numel() == 0:
            continue
        weight = (w * hit).sum(dim=-1)[rows]
        x = h[rows]
        mats = {"w_gate": wg[j], "w_up": wu[j], "w_down": wd[j]}

        def site(name, inp):
            y, acc = _site(inp, *_codes(mats[name], bits), bits)
            if products is not None and acc is not None:
                products[(first + j, name)] = (rows, acc)
            return y

        y = site("w_down", F.silu(site("w_gate", x)) * site("w_up", x))
        out.index_add_(0, rows, y * weight[:, None])
    return out


class Reference(_Attention):
    """The model of one configuration's sizes on one rank's float32 weights
    (``bits`` None: every site a float matmul).

    ``sizes``: ``bench/families/moe.py``'s (``d_model``, ``num_heads``,
    ``num_kv_heads``, ``head_dim``, ``num_layers``, ``vocab_size``,
    ``rope_theta``, ``rms_eps``, ``num_experts``, ``jitter_eps``).
    ``params``: the rank's weight tree (``embed``, ``lm_head``,
    ``final_norm``; under ``layers`` stacked ``ln1``, ``ln2``,
    ``attn/{wq,wk,wv,wo}`` as in ``bench/reference.py``, ``moe/router``
    (L, D, E), ``moe/{w_gate,w_up}`` (L, E / world, D, F), ``moe/w_down``
    (L, E / world, F, D)).  ``rank`` of ``world``: the process's card, whose
    experts it computes; with ``world`` above 1 a ``torch.distributed``
    process group of ``world`` ranks is up.
    """

    def __init__(self, sizes: dict, params: dict, bits: int,
                 precision: str = "fp32", rank: int = 0,
                 world: int = 1) -> None:
        super().__init__(sizes, params, bits, precision, rank, world)
        self.rank, self.world = rank, world
        local = params["layers"]["moe"]["w_gate"].shape[1]
        if local * world != sizes["num_experts"]:
            raise ValueError(f"{local} experts a rank on {world} ranks, not "
                             f"{sizes['num_experts']}")

    def _experts(self, li: int, h: torch.Tensor) -> torch.Tensor:
        moe = self.p["layers"]["moe"]
        local = moe["w_gate"].shape[1]
        out = expert_layer(
            h, moe["router"][li],
            tuple(moe[name][li] for name in EXPERT_SITES),
            self.s["jitter_eps"], self.bits, self.rank * local,
            self.precision == "tf32")
        if self.world > 1:
            torch.distributed.all_reduce(out)
        return out

    @torch.no_grad()
    def run(self, sequences: list[torch.Tensor], logit_rows: list,
            keep: dict | None = None, layers=(0,)):
        """As ``bench/reference.py``'s ``run``; the kept products are those
        of :data:`SITES`.  A layer's experts run once over every sequence's
        rows (one exchange a layer)."""
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
                for name in SITES:
                    w = lay["attn"][name][li]
                    codes[name] = _codes(
                        w.reshape(-1, w.shape[-1]) if name == "wo"
                        else w.reshape(w.shape[0], -1), self.bits)
                for i, x in enumerate(xs):
                    store = (products[li][i] if li in products and i in keep
                             else None)

                    def site(name, inp):
                        out, acc = _site(inp, *codes[name], self.bits)
                        if store is not None and acc is not None:
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
                    xs[i] = x + site("wo", o)
                del codes
                m = torch.cat([self._rmsnorm(lay["ln2"][li], x) for x in xs])
                parts = torch.split(self._experts(li, m),
                                    [x.shape[0] for x in xs])
                xs = [x + y for x, y in zip(xs, parts)]
            head = _codes(p["lm_head"], self.bits)
            logits = []
            for x, rows in zip(xs, logit_rows):
                y = self._rmsnorm(p["final_norm"], x[rows])
                logits.append(_site(y, *head, self.bits)[0])
        return logits, products
