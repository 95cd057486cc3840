"""Functional GEMMs + cycle models for the paper's GEMM units.

Each design consumes *already-quantized* integer matrices ``a: (M, K)`` and
``b: (K, N)`` (int8 container holding w-bit values) and produces the unit's
output in int32, together with the latency the unit would incur.

For tuGEMM/tubGEMM/bGEMM the hardware is deterministic, so the exact
functional result *is* integer GEMM; the value of the unary designs lies in
the PPA/latency model (see ``core.ppa``) and in the slot schedule the CUDA
kernels in ``repro_torch.kernels.unary_gemm`` execute literally.

Latency formulas (paper §II, outer-product dataflow, ``N`` = common dim = K):

    bGEMM    : K
    uGEMM    : 2^w
    tuGEMM   : K * (2^(w-1))^2
    tubGEMM  : K * 2^(w-2)

Designs are dispatched through a registry (:func:`register_design`); the
built-in four register at import, in the reference's order.  uGEMM is
registered with its cycle formula only (so the PPA tables and pricing cover
all four designs); its stochastic multiplier and the cycle-faithful
``*_stream`` simulators are not ported yet and raise ``NotImplementedError``.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable

import torch

__all__ = [
    "DESIGNS",
    "DesignSpec",
    "register_design",
    "get_design",
    "registry_snapshot",
    "registry_restore",
    "scoped_registry",
    "wc_cycles",
    "dynamic_cycles_from_sparsity",
    "rel_rmse",
    "bgemm_exact",
    "tugemm_exact",
    "tubgemm_exact",
]


# ---------------------------------------------------------------------------
# Design registry
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DesignSpec:
    """Everything the dispatch layer needs to know about one PE-array design.

    ``exact_fn(a, b, bits)`` — fast functional GEMM.
    ``stream_fn(a, b, bits)`` — schedule-faithful run, returns ``(out, cycles)``.
    ``wc_cycles_fn(bits, common_dim)`` — worst-case latency formula.
    ``sparsity_aware`` — True iff the unit early-terminates on bit sparsity
    (paper Eq. 1 applies); False runs at worst case regardless of operands.
    ``dyn_operand_fn(bits, step_max)`` — dynamic cycles from the per-outer-
    product-step max magnitudes ``step_max: (K,)``; None means worst case.
    ``exact`` — True iff the functional result is deterministic integer GEMM
    (bit-identical to the binary oracle); False for stochastic designs.
    """

    name: str
    exact_fn: Callable[[torch.Tensor, torch.Tensor, int], torch.Tensor]
    stream_fn: Callable[[torch.Tensor, torch.Tensor, int], tuple]
    wc_cycles_fn: Callable[[int, int], int]
    sparsity_aware: bool = False
    dyn_operand_fn: Callable[[int, torch.Tensor], torch.Tensor] | None = None
    exact: bool = True


_REGISTRY: dict[str, DesignSpec] = {}

# Canonical design order (rebuilt by register_design; kept a plain tuple for
# the call sites that iterate over it).
DESIGNS: tuple[str, ...] = ()


def register_design(name: str,
                    exact_fn: Callable,
                    stream_fn: Callable,
                    wc_cycles_fn: Callable[[int, int], int],
                    *,
                    sparsity_aware: bool = False,
                    dyn_operand_fn: Callable | None = None,
                    exact: bool = True,
                    overwrite: bool = False) -> DesignSpec:
    """Register a GEMM unit design with the dispatch layer.

    PPA *pricing* additionally needs paper-calibrated synthesis data, which
    ``core.ppa`` only has for the built-in four — pricing an uncalibrated
    design raises a clear error.  Consumers holding a from-import snapshot of
    ``DESIGNS`` won't see later registrations; read ``gemm_sims.DESIGNS`` via
    the module attribute for a live view.
    """
    global DESIGNS
    if name in _REGISTRY and not overwrite:
        raise ValueError(f"design {name!r} already registered")
    spec = DesignSpec(name=name, exact_fn=exact_fn, stream_fn=stream_fn,
                      wc_cycles_fn=wc_cycles_fn,
                      sparsity_aware=sparsity_aware,
                      dyn_operand_fn=dyn_operand_fn,
                      exact=exact)
    _REGISTRY[name] = spec  # analysis: allow-registry-mutation (this is the registry's own module)
    DESIGNS = tuple(_REGISTRY)
    return spec


def get_design(name: str) -> DesignSpec:
    """Look up a registered :class:`DesignSpec` by name (ValueError if absent)."""
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(f"unknown design {name!r}") from None


def registry_snapshot() -> dict[str, DesignSpec]:
    """Copy of the current design registry, for :func:`registry_restore`."""
    return dict(_REGISTRY)


def registry_restore(snapshot: dict[str, DesignSpec]) -> None:
    """Reset the registry (and ``DESIGNS``) to a :func:`registry_snapshot`."""
    global DESIGNS
    _REGISTRY.clear()
    _REGISTRY.update(snapshot)
    DESIGNS = tuple(_REGISTRY)


@contextlib.contextmanager
def scoped_registry():
    """Context manager: registry mutations inside the block don't escape it.

    Snapshots on entry and restores on exit (exception-safe, nestable).
    Yields the snapshot taken at entry.
    """
    snapshot = registry_snapshot()
    try:
        yield snapshot
    finally:
        registry_restore(snapshot)


# ---------------------------------------------------------------------------
# Latency model
# ---------------------------------------------------------------------------

def wc_cycles(design: str, bits: int, common_dim: int) -> int:
    """Worst-case cycles for one (n x n x common_dim) GEMM on the unit.

    §II formulas: bGEMM K, uGEMM 2^w, tuGEMM K*(2^(w-1))^2, tubGEMM
    K*2^(w-2).  Dimensionless count — multiply by ``ppa.CLOCK_PERIOD_NS``.
    """
    return get_design(design).wc_cycles_fn(bits, common_dim)


def dynamic_cycles_from_sparsity(design: str, bits: int, common_dim: int,
                                 bit_sparsity: float) -> float:
    """Paper Eq. 1: dynamic latency = WC latency * (1 - bit_sparsity).

    Only the temporal designs (tuGEMM, tubGEMM) exploit bit sparsity; uGEMM
    and bGEMM run at worst case regardless of operand values.
    """
    wc = wc_cycles(design, bits, common_dim)
    if get_design(design).sparsity_aware:
        return wc * (1.0 - float(bit_sparsity))
    return float(wc)


def _tugemm_dyn(bits: int, step_max: torch.Tensor) -> torch.Tensor:
    # outer stream gates inner full pass
    return torch.sum((2 ** (bits - 1)) * step_max)


def _tubgemm_dyn(bits: int, step_max: torch.Tensor) -> torch.Tensor:
    # 2-unary stream slots actually used
    per_step = torch.ceil(step_max.to(torch.float32) / 2.0)
    return torch.sum(torch.clamp(per_step, min=1))


def rel_rmse(est, oracle) -> float:
    """Relative RMSE of an estimate vs its oracle (0.0 means bit-exact).

    Computed in float64 on the tensors' device; guarded against an
    all-zero oracle.
    """
    est = torch.as_tensor(est).to(torch.float64)
    oracle = torch.as_tensor(oracle).to(device=est.device, dtype=torch.float64)
    denom = float(torch.sqrt(torch.mean(oracle ** 2)))
    return float(torch.sqrt(torch.mean((est - oracle) ** 2))) / max(denom, 1e-12)


# ---------------------------------------------------------------------------
# Fast functional paths
# ---------------------------------------------------------------------------

#: K-chunk inside which an fp32 product of int8 codes is exact in any
#: summation order: 512 * 128 * 128 = 2^23 < 2^24.
_FP32_EXACT_CHUNK = 512


def bgemm_exact(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:  # analysis: allow-float-accumulation (int32 matmul on the CPU; on CUDA K-chunked fp32 partial sums < 2^24 are exact integers)
    """Conventional binary GEMM: the int32 oracle every exact design equals.

    Args: ``a`` (M, K) and ``b`` (K, N) integer matrices (any int dtype
    holding int8-range codes).  Returns: (M, N) int32 product.

    CPU tensors use the integer matmul directly.  CUDA has no int32
    ``matmul``, so device tensors go through K-chunked fp32 products — each
    chunk's partial sums stay below 2^24, where fp32 (and TF32, which holds
    int8 values exactly) is exact in any order — summed in int32.
    ``torch._int_mm`` is not used: cuBLASLt on the H100 refuses row counts
    its shape rules admit (M = 24, 27), which a plan's prefill reaches.
    """
    if a.device.type != "cuda":
        return torch.matmul(a.to(torch.int32), b.to(torch.int32))
    out = torch.zeros((a.shape[0], b.shape[1]), dtype=torch.int32,
                      device=a.device)
    for lo in range(0, a.shape[1], _FP32_EXACT_CHUNK):
        hi = lo + _FP32_EXACT_CHUNK
        part = torch.matmul(a[:, lo:hi].to(torch.float32),
                            b[lo:hi].to(torch.float32))
        out += part.to(torch.int32)
    return out


def tugemm_exact(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """tuGEMM is deterministic: functional result == integer GEMM."""
    return bgemm_exact(a, b)


def tubgemm_exact(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """tubGEMM is deterministic: functional result == integer GEMM."""
    return bgemm_exact(a, b)


def _not_ported(what: str):
    def fn(*_args, **_kw):
        raise NotImplementedError(
            f"{what} is not ported yet (stochastic uGEMM and the "
            f"cycle-faithful stream simulators arrive in a later slice)")
    return fn


# ---------------------------------------------------------------------------
# Built-in designs (paper §II), in the reference's registration order
# ---------------------------------------------------------------------------

register_design(
    "ugemm",
    exact_fn=_not_ported("ugemm_exact"),
    stream_fn=_not_ported("ugemm_stream"),
    wc_cycles_fn=lambda bits, common_dim: 2 ** bits,
    exact=False,   # stochastic multiplier: estimate, not the int32 oracle
)

register_design(
    "tugemm",
    exact_fn=lambda a, b, bits: tugemm_exact(a, b),
    stream_fn=_not_ported("tugemm_stream"),
    wc_cycles_fn=lambda bits, common_dim: common_dim * (2 ** (bits - 1)) ** 2,
    sparsity_aware=True,
    dyn_operand_fn=_tugemm_dyn,
)

register_design(
    "tubgemm",
    exact_fn=lambda a, b, bits: tubgemm_exact(a, b),
    stream_fn=_not_ported("tubgemm_stream"),
    wc_cycles_fn=lambda bits, common_dim: common_dim * 2 ** (bits - 2),
    sparsity_aware=True,
    dyn_operand_fn=_tubgemm_dyn,
)

register_design(
    "bgemm",
    exact_fn=lambda a, b, bits: bgemm_exact(a, b),
    stream_fn=lambda a, b, bits: (bgemm_exact(a, b), a.shape[1]),
    wc_cycles_fn=lambda bits, common_dim: common_dim,
)
