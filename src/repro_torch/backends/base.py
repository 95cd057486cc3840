"""The :class:`GemmBackend` object: one GEMM engine at a fixed bit-width.

A backend bundles, behind one typed interface:

* **execution** — :meth:`GemmBackend.execute` (fast functional GEMM, 2-D or
  batched) and :meth:`GemmBackend.stream` (schedule-faithful run returning
  ``(out, cycles)``);
* **cost** — :meth:`GemmBackend.cycles` (worst case), :meth:`GemmBackend.dyn_cycles`
  (Eq. 1 from a sparsity statistic, or operand-driven from a concrete
  quantized tile) and :meth:`GemmBackend.price` (a whole model workload on
  ``core.accounting``'s DLA tiling);
* **metadata** — ``name``, ``bits``, ``exact`` (deterministic integer result,
  bit-identical to the binary oracle) and ``has_synthesis_data`` (the paper
  published post-synthesis PPA for this design under its own name).

Backends are immutable values: constructing one never mutates any global
registry, and two backends with the same construction arguments compare
equal.  Construct them with :func:`repro_torch.backends.resolve`.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.analysis import ranges
from repro_torch.core import gemm_sims

__all__ = ["GemmBackend"]


@dataclasses.dataclass(frozen=True)
class GemmBackend:
    """A GEMM execution engine (simulated or CUDA kernel) at a fixed bit-width.

    ``pricing_design`` is the calibrated design name :meth:`price`,
    :meth:`cycles` and :meth:`dyn_cycles` charge against — the backend's own
    name for the four paper designs, the simulator sibling for the CUDA
    mirrors (one cost model, two execution engines).
    """

    name: str
    bits: int
    exact: bool
    has_synthesis_data: bool
    pricing_design: str
    # Execution engine.  Excluded from equality/hash: mirror specs hold
    # per-resolve closures, and the value identity of a backend is fully
    # determined by the other fields.
    spec: gemm_sims.DesignSpec = dataclasses.field(repr=False, compare=False)
    # Rate-coded stream length (the ``ugemm_stochastic`` family's
    # accuracy/energy knob); None for every count-exact design.
    stream_len: int | None = None

    def __post_init__(self) -> None:
        if self.bits < 2:
            raise ValueError(f"bits must be >= 2, got {self.bits}")
        if self.stream_len is not None and self.stream_len < 1:
            raise ValueError(
                f"stream_len must be >= 1, got {self.stream_len}")

    # -- execution ----------------------------------------------------------

    def execute(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """Functional GEMM on already-quantized integer codes.

        ``a``: (M, K) codes, or (B, M, K) for a batch of problems; ``b``:
        (K, N), or (B, K, N) per-problem, or (K, N) shared across the batch
        (the weight-stationary serving case).  Returns (…, M, N) — int32
        for exact designs, float32 estimate for uGEMM and its rate-coded
        family.

        Raises ``ValueError`` when the contraction length leaves the
        design's validated accumulator envelope (uGEMM's exact-count window
        ``L*K < 2^24``, int32 partial sums for the exact designs).
        """
        self._guard_envelope(a.shape[-1])
        if a.ndim == 2:
            return self.spec.exact_fn(a, b, self.bits)
        if a.ndim != 3:
            raise ValueError(
                f"execute wants (M, K) or (B, M, K) operands, got "
                f"{tuple(a.shape)}")
        if b.ndim == 2:   # shared weight: one (B*M, K) problem
            nb, m, k = a.shape
            out = self.spec.exact_fn(a.reshape(nb * m, k), b, self.bits)
            return out.reshape(nb, m, -1)
        return torch.stack([self.spec.exact_fn(a[i], b[i], self.bits)
                            for i in range(a.shape[0])])

    def stream(self, a: torch.Tensor, b: torch.Tensor):
        """Schedule-faithful run: ``(out, cycles)``.

        ``cycles`` equals :meth:`cycles` of the contraction length — the
        executed schedules are worst-case.  Same accumulator-envelope guard
        as :meth:`execute`.
        """
        self._guard_envelope(a.shape[-1])
        return self.spec.stream_fn(a, b, self.bits)

    def _guard_envelope(self, k: int) -> None:
        """Static numeric-safety check (see ``repro_torch.analysis.ranges``)."""
        # Stream-coded backends check their own stream-aware envelope (the
        # per-step count is the stream length, not the pricing design's
        # 2^bits slots); everything else checks as the design it prices as.
        design = self.name if self.stream_len is not None \
            else self.pricing_design
        ranges.assert_within_envelope(design, self.bits, int(k),
                                      where=f"backend {self.name}",
                                      stream_len=self.stream_len)

    # -- cost ---------------------------------------------------------------

    @property
    def cycle_scale(self) -> float:
        """Per-tile cycle multiplier vs ``pricing_design``'s wc formula.

        1.0 for every design priced under its own name.  The stochastic
        family prices as uGEMM (identical rate-coded datapath; k-independent
        cycles) scaled by ``stream_len / 2^bits``: energy and latency are
        linear in slot count.
        """
        if self.stream_len is None:
            return 1.0
        return self.stream_len / float(2 ** self.bits)

    def cycles(self, common_dim: int) -> int:
        """Worst-case clock cycles for one GEMM streaming over ``common_dim``."""
        return self.spec.wc_cycles_fn(self.bits, common_dim)

    def dyn_cycles(self, common_dim: int | None = None, *,
                   bit_sparsity: float | None = None,
                   operand=None) -> float:
        """Dynamic (early-terminating) cycles for one GEMM.

        Exactly one source of dynamism:

        * ``operand`` — a concrete quantized temporal-operand tile, shape
          (K, n) or (K,); cycles follow the per-outer-product-step max
          magnitudes (the largest value in flight gates every lane).
        * ``bit_sparsity`` — paper Eq. 1: ``wc * (1 - bit_sparsity)``
          (requires ``common_dim``; only sparsity-aware designs benefit).
        * neither — worst case (requires ``common_dim``).
        """
        if operand is not None:
            if bit_sparsity is not None:
                raise ValueError("pass either operand or bit_sparsity, not both")
            q = torch.as_tensor(operand).to(torch.int32)
            if q.ndim == 1:
                q = q[:, None]
            k = q.shape[0]
            if self.spec.dyn_operand_fn is None:
                return float(self.spec.wc_cycles_fn(self.bits, k))
            step_max = torch.amax(torch.abs(q), dim=tuple(range(1, q.ndim)))
            return float(self.spec.dyn_operand_fn(self.bits, step_max))
        if common_dim is None:
            raise ValueError("common_dim is required without an operand")
        wc = self.cycles(common_dim)
        if bit_sparsity is not None and self.spec.sparsity_aware:
            return wc * (1.0 - float(bit_sparsity))
        return float(wc)

    def price(self, workload, *, unit_n: int = 128, num_units: int = 1):
        """Price a model workload on a DLA built from this design.

        ``workload`` — a list of ``core.accounting.GemmCall`` or a
        ``GemmWorkloadRecorder``.  Returns a ``core.accounting.ModelCost``.
        CUDA mirrors price as their simulator sibling (same silicon, same
        schedule — a different execution engine doesn't change PPA).
        """
        from repro_torch.core import accounting
        calls = getattr(workload, "calls", workload)
        return accounting.price_workload(calls, design=self, bits=self.bits,
                                         unit_n=unit_n, num_units=num_units)
