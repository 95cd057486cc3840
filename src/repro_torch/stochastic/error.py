"""Measured accuracy of the stochastic engine against exact uGEMM.

``eval.planner`` plans ``(design, bits, stream_len)`` assignments; the
stream-length axis needs an accuracy statistic per site.  This module is
the *measured* side: seeded, deterministic RMSE-vs-exact-uGEMM curves over
stream length, on a site's actual quantized weight codes against seeded
calibration activations.  The analytic expected and tail envelopes live in
``repro_torch.analysis.ranges.stochastic_error_bound``.

Everything keys off ``(seed, bits, stream_len)`` only: the same inputs
always give the same curve.  Calibration codes come from numpy (the
reference's draw); the GEMMs run on the weight's device.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import gemm_sims
from repro_torch.core.quantization import quantize, vmax
from repro_torch.stochastic import sgemm

__all__ = [
    "calibration_codes", "measured_rel_rmse", "rmse_curve", "site_rmse_curve",
]


def calibration_codes(rows: int, cols: int, bits: int, *,
                      seed: int = 0) -> np.ndarray:
    """Deterministic uniform integer codes in ``[-vmax, vmax]``."""
    rng = np.random.default_rng(seed)
    v = vmax(bits)
    return rng.integers(-v, v + 1, size=(rows, cols)).astype(np.int32)


def measured_rel_rmse(a, b, bits: int, stream_len: int, *,
                      seed: int = 0, rng_kind: str = "sobol") -> float:
    """Relative RMSE of the stochastic engine against ``ugemm_exact``;
    ``a`` and ``b`` must lie on one device."""
    a, b = torch.as_tensor(a), torch.as_tensor(b)
    est = sgemm.stochastic_gemm(a, b, bits, stream_len=stream_len, seed=seed,
                                rng_kind=rng_kind)
    oracle = gemm_sims.ugemm_exact(a, b, bits=bits)
    return gemm_sims.rel_rmse(est, oracle)


def rmse_curve(bits: int, stream_lens, *, m: int = 8, k: int = 64,
               n: int = 32, seed: int = 0,
               rng_kind: str = "sobol") -> list[tuple[int, float]]:
    """``(stream_len, rel_rmse)`` pairs on seeded calibration operands."""
    a = torch.from_numpy(calibration_codes(m, k, bits, seed=seed))
    b = torch.from_numpy(calibration_codes(k, n, bits, seed=seed + 1))
    return [(int(L), measured_rel_rmse(a, b, bits, int(L), seed=seed,
                                       rng_kind=rng_kind))
            for L in stream_lens]


def site_rmse_curve(weight: torch.Tensor, bits: int, stream_lens, *,
                    rows: int = 4, max_cols: int = 64, seed: int = 0,
                    rng_kind: str = "sobol") -> list[tuple[int, float]]:
    """Per-site curve: the site's real weight, seeded activations.

    ``weight`` is the float ``(k, n_out)`` site matrix (on any device); its
    first ``max_cols`` columns are quantized per output channel at ``bits``
    — the codes backend execution contracts — and multiplied by ``rows``
    seeded calibration activations on the weight's device.
    """
    cols = min(weight.shape[1], max_cols)
    wq = quantize(weight[:, :cols].to(torch.float32), bits=bits)
    a = torch.from_numpy(calibration_codes(rows, weight.shape[0], bits,
                                           seed=seed)).to(weight.device)
    return [(int(L), measured_rel_rmse(a, wq.values, bits, int(L), seed=seed,
                                       rng_kind=rng_kind))
            for L in stream_lens]
