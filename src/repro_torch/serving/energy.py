"""Energy-per-token accounting for the serving loop (Eq. 1 pricing).

The engine charges every scheduler step the Eq.-1 dynamic energy of the
weight GEMMs it actually ran, priced through ``core.accounting``:

* weights are walked and sparsity-profiled ONCE at engine start (the
  block-max bit-sparsity statistic the paper's cost tables use), on the
  device the parameters live on — only scalars reach the host;
* a decode step with ``m`` active requests prices the per-layer workload at
  ``m`` GEMM rows (one token per active request);
* an admission prices the prompt's prefill at ``prompt_len`` rows;
* energy-per-token = total dynamic energy / tokens generated.

Costs are cached per row count ``m``, so a whole trace re-prices nothing.

:func:`iter_weight_matrices` is the single canonical walk: sorted-key order
of the parameter tree (the reference's pytree order), stacked leaves of rank
> 2 reshaped to ``(-1, last_dim)``, so both implementations price identical
matrices in identical order.
"""

from __future__ import annotations

import torch

from repro_torch import backends as backends_lib
from repro_torch.core import accounting, sparsity

__all__ = ["iter_weight_matrices", "EnergyModel"]


def _walk(tree, prefix=()):
    for key in sorted(tree):
        node = tree[key]
        if isinstance(node, dict):
            yield from _walk(node, prefix + (str(key),))
        else:
            yield "/".join(prefix + (str(key),)), node


def iter_weight_matrices(cfg, params):
    """Yield ``(name, (k, n_out) weight view)`` for every priced matmul.

    ``name`` is the "/"-joined parameter-tree path (the site-naming
    contract).  Names containing ``embed`` are skipped when the embeddings
    are untied (an ``lm_head`` leaf exists), mirroring which matmuls the
    backend scope contracts.  The yielded matrix is a view on the
    parameter's own device, in its own dtype.
    """
    for name, leaf in _walk(params):
        if not hasattr(leaf, "ndim") or leaf.ndim < 2:
            continue
        if "embed" in name and not cfg.tie_embeddings:
            continue
        w = leaf.reshape(leaf.shape[0], -1) if leaf.ndim == 2 \
            else leaf.reshape(-1, leaf.shape[-1])
        yield name, w


class EnergyModel:
    """Prices one forward step of the model at ``m`` rows on one design."""

    def __init__(self, cfg, params, *, design: str = "tubgemm", bits: int = 4,
                 unit_n: int = 64, num_units: int = 64,
                 grid: tuple[int, int] | None = None) -> None:
        self.design = design
        self.bits = bits
        self.unit_n = unit_n
        self.num_units = num_units
        backend = backends_lib.resolve(design, bits=bits)
        if grid is not None:
            backend = backends_lib.as_grid(backend, *grid)
        self._backend = backend
        self._shapes = []
        for name, w in iter_weight_matrices(cfg, params):
            # profile in float32 like the reference, one chunk at a time
            st = sparsity.profile_tensor(
                w if w.dtype == torch.float32 else w.to(torch.float32),
                bits=bits)
            self._shapes.append((name, w.shape[0], w.shape[1], st.bit_blockmax))
        self._costs: dict[int, accounting.ModelCost] = {}

    def step_cost(self, m: int) -> accounting.ModelCost:
        """ModelCost of one forward step contracting ``m`` rows per site."""
        cost = self._costs.get(m)
        if cost is None:
            rec = accounting.GemmWorkloadRecorder()
            for name, k, n_out, bit_blockmax in self._shapes:
                rec.record(name, m=m, k=k, n_out=n_out,
                           bit_sparsity=bit_blockmax, count=1)
            cost = self._backend.price(rec.calls, unit_n=self.unit_n,
                                       num_units=self.num_units)
            self._costs[m] = cost
        return cost

    def decode_energy_uj(self, n_active: int) -> float:
        """Dynamic energy of one decode step with ``n_active`` requests."""
        return 0.0 if n_active == 0 else self.step_cost(n_active).dyn_energy_uj

    def prefill_energy_uj(self, prompt_len: int) -> float:
        """Dynamic energy of prefilling one ``prompt_len``-token prompt."""
        return self.step_cost(prompt_len).dyn_energy_uj
