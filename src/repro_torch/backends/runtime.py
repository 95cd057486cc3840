"""Scoped backend execution: :func:`use_backend` threads a GEMM engine into
``models/common.dense`` so the quantized forward pass actually contracts its
integer tiles on the selected unary engine.

Scopes live on one thread-local stack (nestable, exception-safe, the
innermost scope wins).  Inside a scope, every ``dense`` call asks the scope
for the backend of its *site* (see the naming contract below), quantizes both
operands to that backend's bit-width, contracts the int tiles with
:meth:`GemmBackend.execute`, and dequantizes back to the activation dtype;
outside any scope the float path runs untouched.

**Site-naming contract.**  A GEMM site is the parameter-tree path of its
weight, ``"/"``-joined:

* model code pushes path segments with :func:`site_scope` (``"layers"`` around
  the layer stack, ``"attn"`` / ``"mlp"`` around the sub-module) and passes
  the weight's leaf key as ``dense(..., name="wq")``;
* :func:`current_site` joins the live stack with the leaf name, yielding
  exactly the names of the parameter tree's leaves (``"layers/attn/wq"``,
  ``"layers/mlp/w_up"``, ``"lm_head"``, …) — the same names the energy
  model's weight walk uses, so profiling, pricing and execution key on one
  name;
* an un-named ``dense`` outside any :func:`site_scope` has site ``""``.

The port runs eagerly, so ``calls`` records one entry per *executed* GEMM: a
layer body looped over L layers appears L times (the reference, traced under
``lax.scan``, records it once).  An ``on_output(site, out)`` callback, when
given, sees each site's raw int32 GEMM output as it is produced, which is
what the parity tests and the on-card tub-vs-tu comparison read.

Per-site plans (``use_plan``), ``pack_weights`` and grids are not ported yet.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading

from repro_torch.backends.base import GemmBackend

# NOTE: repro_torch.backends.registry is imported lazily inside use_backend —
# registry pulls in repro_torch.configs, whose model-config import would
# close a cycle with the model modules that import site_scope from here.

__all__ = ["ExecutedGemm", "BackendExecution", "use_backend",
           "active_backend", "active_execution", "site_scope",
           "current_site"]


@dataclasses.dataclass(frozen=True)
class ExecutedGemm:
    """One GEMM site contracted on a backend.

    ``m``/``k``/``n_out`` — the contraction ``(m, k) @ (k, n_out)``;
    ``backend``/``bits`` — the engine that site ran on; ``site`` — the
    site name per the module-level naming contract.
    """

    m: int
    k: int
    n_out: int
    backend: str
    bits: int
    site: str = ""


class BackendExecution:
    """Live handle for one :func:`use_backend` scope.

    ``backend`` — the resolved :class:`GemmBackend` every site executes on;
    ``calls`` — the :class:`ExecutedGemm` sites in execution order;
    ``on_output`` — an optional ``callable(site, int32 GEMM result)`` invoked
    once per call, in the same order; ``weight_cache`` — an optional
    caller-owned dict in which ``dense`` keeps each weight's codes so they
    are quantized once instead of at every call.
    """

    def __init__(self, backend: GemmBackend, on_output=None,
                 weight_cache: dict | None = None) -> None:
        self.backend = backend
        self.on_output = on_output
        self.weight_cache = weight_cache
        self.calls: list[ExecutedGemm] = []

    def record(self, site: str, m: int, k: int, n_out: int,
               backend: GemmBackend, out=None) -> None:
        """Append one executed GEMM site to ``calls``."""
        self.calls.append(ExecutedGemm(
            int(m), int(k), int(n_out), backend.name, backend.bits,
            str(site)))
        if self.on_output is not None and out is not None:
            self.on_output(str(site), out)


_TLS = threading.local()


def _stack() -> list[BackendExecution]:
    stack = getattr(_TLS, "stack", None)
    if stack is None:
        stack = _TLS.stack = []
    return stack


def _site_stack() -> list[str]:
    stack = getattr(_TLS, "sites", None)
    if stack is None:
        stack = _TLS.sites = []
    return stack


def active_execution() -> BackendExecution | None:
    """The innermost live :func:`use_backend` scope, or None."""
    stack = _stack()
    return stack[-1] if stack else None


def active_backend() -> GemmBackend | None:
    """The single backend ``dense`` executes on right now, or None."""
    execution = active_execution()
    return execution.backend if execution is not None else None


@contextlib.contextmanager
def site_scope(segment: str):
    """Push one ``"/"``-separated path segment onto the site-name stack.

    Model code wraps sub-module forwards so the ``dense`` calls inside
    compose the parameter-tree path.  Nests and unwinds on exceptions.
    """
    stack = _site_stack()
    stack.append(str(segment))
    try:
        yield
    finally:
        stack.pop()


def current_site(name: str | None = None) -> str:
    """The full site name for a leaf ``name`` under the live scopes.

    Joins the :func:`site_scope` stack with ``name`` (omitted if None);
    returns ``""`` when both are empty.
    """
    parts = list(_site_stack())
    if name:
        parts.append(str(name))
    return "/".join(parts)


@contextlib.contextmanager
def _pushed(execution: BackendExecution):
    stack = _stack()
    stack.append(execution)
    try:
        yield execution
    finally:
        stack.remove(execution)


@contextlib.contextmanager
def use_backend(spec: str | GemmBackend, *, bits: int | None = None,
                grid=None, on_output=None,
                weight_cache: dict | None = None):
    """Execute every ``dense`` contraction in the block on ``spec``.

    Args as :func:`repro_torch.backends.resolve`; ``grid`` (PE-array grids)
    is accepted for signature parity and raises ``NotImplementedError`` until
    ``backends/grid.py`` is ported.  Yields the scope's
    :class:`BackendExecution` (``.backend``, ``.calls``).
    Scopes nest — the innermost wins — and unwind correctly on exceptions.
    """
    from repro_torch.backends.registry import resolve
    if grid is not None:
        raise NotImplementedError(
            "use_backend(grid=...) needs backends/grid.py, which a later "
            "slice of the port brings")
    backend = resolve(spec, bits=bits)
    execution = BackendExecution(backend, on_output=on_output,
                                 weight_cache=weight_cache)
    with _pushed(execution):
        yield execution
