"""Cost of one eager step, counted from the operations it dispatches.

Where the reference parses the compiled, partitioned XLA HLO text (and
scales each loop body by its trip count), the port runs the step on the
``meta`` device under a ``TorchDispatchMode`` and counts what eager
execution would do, operation by operation — every layer, expert and
recomputed (remat) forward is dispatched, so there is no loop to scale:

* **flops** — every ``mm`` / ``bmm`` / ``addmm`` / ``baddbmm`` /
  ``_int_mm`` counted as ``2 * |result| * K``, and each flash kernel's
  operation as :func:`~repro_torch.kernels.flash_attention.flash_ops`
  counts it at its operands' shapes.  Elementwise flops are ignored, as in
  the reference.
* **bytes** — per dispatched operation that is not a view (nor an
  ``empty`` allocation), its tensor operands' bytes plus its results'
  bytes: what eager execution moves, with no fusion.
* **collective bytes** — 0: one device runs no collective (see
  :mod:`repro_torch.launch.hlo_stats`).
* **peak live bytes** — the most bytes the step's own results held at
  once (each result counted from its creation until its tensor is freed),
  on top of the arguments.

On ``meta`` the model's uncached attention takes the flash wrappers, as
on the card, and each flash kernel is one operation
(``repro_torch::flash_fwd``, ``flash_bwd_dq``, ``flash_bwd_dkv``): its
operands read once and its outputs written once, with no score tile, as
the kernel moves them.  What the card runs as PyTorch operations is
counted as such, unfused: the cached path's attention (prefill and decode
against a cache) is the model's plain einsum attention there as here.
"""

from __future__ import annotations

import collections
import dataclasses
import weakref

import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.kernels.flash_attention import flash_ops
from repro_torch.launch.hlo_stats import COLLECTIVES

__all__ = ["analyze", "HloCost", "CostCounter", "PRODUCTS"]

#: matrix products: op name -> positions of (lhs, rhs) in its arguments
#: (``analysis/jaxpr_scan`` reads the same table)
PRODUCTS = {"mm": (0, 1), "bmm": (0, 1), "_int_mm": (0, 1),
            "addmm": (1, 2), "baddbmm": (1, 2)}
#: the flash kernels' ``meta`` operations, named as their wrappers
_FLASH = frozenset({"flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"})
#: operations that allocate without moving bytes, or only relabel
#: (``_unsafe_view`` is a view its schema does not mark as one)
_NO_TRAFFIC = frozenset({"empty", "empty_like", "empty_strided", "new_empty",
                         "new_empty_strided", "detach", "alias",
                         "lift_fresh", "_unsafe_view"})


@dataclasses.dataclass
class HloCost:
    flops: float
    bytes_accessed: float
    collective_bytes: float
    coll_by_op: dict[str, float]
    coll_counts: dict[str, float]
    dot_flops_by_comp: dict[str, float]     # by op ("mm", "bmm", "flash_fwd", ...)
    # (total_bytes, count, op, result shape, "eager") of the top byte
    # contributors, grouped by (op, result shape)
    top_bytes: list = dataclasses.field(default_factory=list)
    top_coll: list = dataclasses.field(default_factory=list)
    peak_live_bytes: float = 0.0
    ops: int = 0


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class CostCounter(TorchDispatchMode):
    """Counts flops, bytes and live result bytes of what it dispatches;
    :meth:`cost` reads them as an :class:`HloCost`."""

    def __init__(self) -> None:
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.ops = 0
        self.dot_flops: dict[str, float] = collections.defaultdict(float)
        self.contrib: dict[tuple, list] = {}
        self.live = 0
        self.peak = 0
        self._finalizers: list[weakref.finalize] = []

    def _free(self, n: int) -> None:
        self.live -= n

    def __exit__(self, *exc):
        # the counts are final: no callback of a result freed later fires
        for fin in self._finalizers:
            fin.detach()
        self._finalizers.clear()
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func.overloadpacket.__name__
        self.ops += 1
        if name in PRODUCTS:
            lhs = args[PRODUCTS[name][0]]
            f = 2.0 * out.numel() * lhs.shape[-1]
            self.flops += f
            self.dot_flops[name] += f
        elif func.namespace == "repro_torch" and name in _FLASH:
            q, k, causal = args[0], args[1], args[-1]
            f = flash_ops(q.shape[0], q.shape[1], k.shape[1], q.shape[2],
                          causal=causal)[name]
            self.flops += f
            self.dot_flops[name] += f
        if func.is_view or name in _NO_TRAFFIC:
            return out
        inputs = [t for t in pytree.tree_leaves((args, kwargs))
                  if isinstance(t, torch.Tensor)]
        results = [t for t in pytree.tree_leaves(out)
                   if isinstance(t, torch.Tensor)]
        b = sum(map(_nbytes, inputs)) + sum(map(_nbytes, results))
        self.bytes += b
        key = (name, str(tuple(results[0].shape)) if results else "()")
        slot = self.contrib.setdefault(key, [0.0, 0])
        slot[0] += b
        slot[1] += 1
        for t in results:
            if any(t is a for a in inputs):
                continue                      # written in place
            n = _nbytes(t)
            self.live += n
            self.peak = max(self.peak, self.live)
            self._finalizers.append(weakref.finalize(t, self._free, n))
        return out

    def cost(self, top_n: int = 24) -> HloCost:
        top = sorted(((b, n, op, shape, "eager")
                      for (op, shape), (b, n) in self.contrib.items()),
                     reverse=True)[:top_n]
        return HloCost(flops=self.flops, bytes_accessed=self.bytes,
                       collective_bytes=0.0,
                       coll_by_op={c: 0.0 for c in COLLECTIVES},
                       coll_counts={c: 0.0 for c in COLLECTIVES},
                       dot_flops_by_comp=dict(self.dot_flops),
                       top_bytes=top, top_coll=[],
                       peak_live_bytes=float(self.peak), ops=self.ops)


def analyze(fn, *args, top_n: int = 24, **kwargs) -> HloCost:
    """Run ``fn(*args, **kwargs)`` under a :class:`CostCounter` and return
    its cost.  Give it ``meta`` tensors to count without computing."""
    counter = CostCounter()
    with counter:
        fn(*args, **kwargs)
    return counter.cost(top_n)
