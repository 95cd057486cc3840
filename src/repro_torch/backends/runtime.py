"""Scoped backend execution: :func:`use_backend` / :func:`use_plan` thread a
GEMM engine (one global backend, or a per-site
:class:`~repro_torch.backends.plan.BackendPlan`) into ``models/common.dense``
so the quantized forward pass actually contracts its integer tiles on the
selected unary engine(s).

Scopes live on one thread-local stack (nestable, exception-safe, the
innermost scope wins).  Inside a scope, every ``dense`` call asks the scope
for the backend of its *site* (see the naming contract below), quantizes both
operands to that backend's bit-width, contracts the int tiles with
:meth:`GemmBackend.execute`, and dequantizes back to the activation dtype;
outside any scope — or when a plan maps the site to no backend — the float
path runs untouched.

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
given, sees each site's raw GEMM output as it is produced (int32 counts of
the exact designs, uGEMM's float32 estimate), which is what the parity
tests and the on-card site comparisons read.

PE-array grids: ``use_backend(..., grid=(X, Y))``, ``use_plan(..., grid=)``
and a :class:`~repro_torch.backends.grid.GridPlan` wrap every resolved
backend in a :class:`~repro_torch.backends.grid.GridBackend`, which runs the
site's shards one after another on the operands' device, bit-identical to
the single unit.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import threading

import torch

from repro_torch.analysis import ranges
from repro_torch.backends.base import GemmBackend
from repro_torch.backends.grid import GridPlan, as_grid, load_plan, parse_grid
from repro_torch.backends.plan import BackendPlan
from repro_torch.core import packing, ppa, sparsity
from repro_torch.core.quantization import quantize

# NOTE: repro_torch.backends.registry is imported lazily inside use_backend —
# registry pulls in repro_torch.configs, whose model-config import would
# close a cycle with the model modules that import site_scope from here.

__all__ = ["ExecutedGemm", "BackendExecution", "PlanExecution",
           "SiteRecorder", "use_backend", "use_plan", "pack_weights",
           "record_sites", "active_backend", "active_execution", "site_scope",
           "current_site", "measure_matrix_cycles"]

@dataclasses.dataclass(frozen=True)
class ExecutedGemm:
    """One GEMM site contracted on a backend.

    ``m``/``k``/``n_out`` — the contraction ``(m, k) @ (k, n_out)``;
    ``backend``/``bits`` — the engine that site ran on; ``site`` — the
    site name per the module-level naming contract; ``stream_len`` — the
    rate-coded stream length for stochastic engines (0 = count-exact).
    """

    m: int
    k: int
    n_out: int
    backend: str
    bits: int
    site: str = ""
    stream_len: int = 0


class BackendExecution:
    """Live handle for one :func:`use_backend` scope.

    ``backend`` — the resolved :class:`GemmBackend` every site executes on;
    ``calls`` — the :class:`ExecutedGemm` sites in execution order (a
    holder that reads none sets it to None, and none is built);
    ``on_output`` — an optional ``callable(site, GEMM result)`` invoked
    once per call, in the same order; ``weight_cache`` — an optional
    caller-owned dict in which ``dense`` keeps each weight's codes so they
    are quantized once instead of at every call.
    """

    def __init__(self, backend: GemmBackend, on_output=None,
                 weight_cache: dict | None = None) -> None:
        self.backend = backend
        self.on_output = on_output
        self.weight_cache = weight_cache
        self.calls: list[ExecutedGemm] | None = []

    def backend_for(self, site: str) -> GemmBackend | None:
        """The backend ``dense`` must execute ``site`` on (None = float)."""
        return self.backend

    def record(self, site: str, m: int, k: int, n_out: int,
               backend: GemmBackend, out=None) -> None:
        """Append one executed GEMM site to ``calls`` (unless it is None)."""
        if self.calls is not None:
            self.calls.append(ExecutedGemm(
                int(m), int(k), int(n_out), backend.name, backend.bits,
                str(site), int(backend.stream_len or 0)))
        if self.on_output is not None and out is not None:
            self.on_output(str(site), out)

    def observe(self, site: str, m: int, k: int, n_out: int) -> None:
        """Called by ``dense`` for sites the scope maps to NO backend.

        A no-op for execution scopes; :class:`SiteRecorder` overrides it to
        collect the site inventory.
        """


class PlanExecution(BackendExecution):
    """Live handle for one :func:`use_plan` scope.

    ``plan`` — the :class:`~repro_torch.backends.plan.BackendPlan` (or a
    :class:`~repro_torch.backends.grid.GridPlan`, which wraps its aggregate
    entries in grid backends itself); ``backend`` is None (there is no
    single engine — :meth:`backend_for` resolves per site).  ``grid`` — an
    optional (units_x, units_y) shape that wraps every resolved backend in a
    :class:`~repro_torch.backends.grid.GridBackend`.  Backends are resolved
    once per site name and cached for the scope's lifetime.  ``on_output``
    and ``weight_cache`` work as in :class:`BackendExecution`; the cache
    keys on the bit-width and the grid, so sites planned at different widths
    never share codes.
    """

    def __init__(self, plan, grid: tuple[int, int] | None = None,
                 on_output=None, weight_cache: dict | None = None) -> None:
        super().__init__(backend=None, on_output=on_output,
                         weight_cache=weight_cache)
        self.plan = plan
        self.grid = grid
        self._cache: dict[str, GemmBackend | None] = {}

    def backend_for(self, site: str) -> GemmBackend | None:
        try:
            return self._cache[site]
        except KeyError:
            backend = self.plan.backend_for(site)
            if backend is not None and self.grid is not None:
                backend = as_grid(backend, *self.grid)
            self._cache[site] = backend
            return backend


class SiteRecorder(BackendExecution):
    """Scope that *names* every dense GEMM site without executing on any
    backend — the planner's discovery pass (see :func:`record_sites`).

    ``backend_for`` always returns None, so the float path runs (on the
    ``meta`` device nothing is computed); ``dense`` still records the site
    name and contraction shape into ``calls`` with backend ``"none"`` /
    bits 0.
    """

    def __init__(self) -> None:
        super().__init__(backend=None)

    def backend_for(self, site: str) -> GemmBackend | None:
        return None

    def observe(self, site: str, m: int, k: int, n_out: int) -> None:
        self.calls.append(ExecutedGemm(int(m), int(k), int(n_out),
                                       "none", 0, str(site)))


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
    """The innermost live :func:`use_backend` / :func:`use_plan` /
    :func:`record_sites` scope, or None."""
    stack = _stack()
    return stack[-1] if stack else None


def active_backend() -> GemmBackend | None:
    """The single backend ``dense`` executes on right now, or None.

    None outside any scope (float path) and inside :func:`use_plan` /
    :func:`record_sites` scopes, whose backend is per-site — use
    :meth:`BackendExecution.backend_for` with a site name there.
    """
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
                stream_len: int | None = None, grid=None, on_output=None,
                weight_cache: dict | None = None):
    """Execute every ``dense`` contraction in the block on ``spec``.

    Args as :func:`repro_torch.backends.resolve` (``stream_len`` selects the
    stochastic family's rate-coded stream length), plus ``grid`` — an
    optional (units_x, units_y) tuple or ``"X,Y"`` string that wraps the
    resolved backend in a :class:`~repro_torch.backends.grid.GridBackend`,
    so every dense contraction is sharded across the PE-array grid.  Yields
    the scope's :class:`BackendExecution` (``.backend``, ``.calls``).
    Scopes nest — the innermost wins — and unwind correctly on exceptions.
    """
    from repro_torch.backends.registry import resolve
    backend = resolve(spec, bits=bits, stream_len=stream_len)
    if grid is not None:
        backend = as_grid(backend, *parse_grid(grid))
    execution = BackendExecution(backend, on_output=on_output,
                                 weight_cache=weight_cache)
    with _pushed(execution):
        yield execution


def _load(plan):
    return (plan if isinstance(plan, (BackendPlan, GridPlan))
            else load_plan(plan))


def _validate_plan_envelopes(plan, grid: tuple[int, int] | None) -> None:
    """Fail fast on assignments whose evidence leaves the safe envelope.

    Entries record the contraction length they were planned for (``k``;
    shard entries record their slice, aggregate grid entries the full K,
    checked at the grid's ceil K split).  Executing outside the envelope
    would raise mid-forward anyway (the backend guard); checking here turns
    that into an immediate, plan-level error naming the offending entry.
    Entries without geometry evidence (hand-written pattern-only plans) are
    skipped — the execute guard still covers them.
    """
    def check(entries, units_x: int, label: str) -> None:
        for entry in entries:
            if entry.k:
                ranges.assert_within_envelope(
                    entry.design, entry.bits, -(-int(entry.k) // units_x),
                    where=f"{label} entry {entry.pattern!r}",
                    stream_len=entry.stream_len or None)

    if isinstance(plan, GridPlan):
        check(plan.aggregate.sites, plan.units_x, "aggregate plan")
        for key, shard_plan in plan.shards:
            check(shard_plan.sites, 1, f"shard {key} plan")
    else:
        check(plan.sites, grid[0] if grid else 1, "plan")


@contextlib.contextmanager
def use_plan(plan, *, grid=None, on_output=None,
             weight_cache: dict | None = None):
    """Execute every ``dense`` contraction on the site's planned backend.

    ``plan`` — a :class:`~repro_torch.backends.plan.BackendPlan`, a
    :class:`~repro_torch.backends.grid.GridPlan`, or a path-like / str
    (loaded via :func:`repro_torch.backends.load_plan`, which sniffs the
    schema).  Each dense site is matched against the plan's patterns (most
    specific wins, see ``repro_torch.backends.plan``); unmatched sites run
    the float path.  ``on_output`` / ``weight_cache`` as in
    :func:`use_backend`.

    ``grid`` — optional (units_x, units_y) / ``"X,Y"`` grid every resolved
    backend is wrapped in.  A :class:`GridPlan` brings its own grid (its
    aggregate entries execute grid-wrapped; shard-local site names resolve
    to single-node backends) — passing a different ``grid`` next to one is
    an error.

    Yields a :class:`PlanExecution` whose ``.calls`` lists every contracted
    site with the backend it actually ran on.  Nests with
    :func:`use_backend` (innermost scope wins) and unwinds on exceptions.
    Entering the scope checks the plan's recorded contraction geometry
    against each assignment's accumulator envelope
    (``repro_torch.analysis.ranges``).
    """
    plan = _load(plan)
    if grid is not None:
        grid = parse_grid(grid)
    _validate_plan_envelopes(plan, grid)
    if isinstance(plan, GridPlan):
        if grid is not None and grid != plan.grid:
            raise ValueError(f"use_plan(grid={grid}) conflicts with the "
                             f"GridPlan's own grid {plan.grid}")
        grid = None  # GridPlan.backend_for wraps its aggregate itself
    with _pushed(PlanExecution(plan, grid=grid, on_output=on_output,
                               weight_cache=weight_cache)) as execution:
        yield execution


def _replace_leaves(tree, fn, prefix=()):
    """A copy of a nested-dict tree with each leaf replaced by
    ``fn("/"-joined path, leaf)``."""
    if isinstance(tree, dict):
        return {k: _replace_leaves(v, fn, prefix + (str(k),))
                for k, v in tree.items()}
    return fn("/".join(prefix), tree)


def pack_weights(cfg, params, plan=None, *, bits: int | None = None,
                 grid=None):
    """Freeze each planned site's weight bit-packed at its assigned width.

    Returns a new parameter tree in which every dense GEMM site that
    ``plan`` assigns a backend is replaced by a
    :class:`repro_torch.core.packing.PackedQuantized` store holding the
    *exact* codes and scales ``models/common.dense`` would compute on that
    site under the plan — so executing the packed tree inside
    :func:`use_plan` is bit-identical to executing the float tree, while the
    weight bytes shrink 4–16x (``core.accounting.packed_store_report``).
    The other leaves are shared with ``params``, not copied.

    ``plan`` — a :class:`~repro_torch.backends.plan.BackendPlan` /
    :class:`~repro_torch.backends.grid.GridPlan` or a path (schema-sniffed
    via ``load_plan``).  Alternatively pass ``bits`` to freeze every
    discovered site at one uniform width (the ``use_backend`` analogue).
    Sites the plan leaves unmatched keep their float leaves — they run the
    float path under ``use_plan``, exactly as before.

    ``grid`` — (units_x, units_y) / ``"X,Y"``: pack per shard along the
    same ceil K split :meth:`~repro_torch.backends.grid.GridBackend.execute`
    applies, so no int32 word straddles a shard boundary.  A
    :class:`GridPlan` brings its own grid.

    Already-packed leaves pass through when their width matches the
    assignment and raise otherwise (the stale-width hazard plan-lint's
    ``packed-width-mismatch`` rule catches statically).
    """
    from repro_torch.eval import planner as planner_lib  # lazy: the stack

    if (plan is None) == (bits is None):
        raise ValueError("pack_weights wants exactly one of plan= or bits=")
    entry_plan = None
    if plan is not None:
        plan = _load(plan)
        entry_plan = plan.aggregate if isinstance(plan, GridPlan) else plan
        if isinstance(plan, GridPlan):
            if grid is not None and parse_grid(grid) != plan.grid:
                raise ValueError(
                    f"pack_weights(grid={grid}) conflicts with the "
                    f"GridPlan's own grid {plan.grid}")
            grid = plan.grid
    grid_x = parse_grid(grid)[0] if grid is not None else 1
    assignments: dict[str, tuple[int, int, int]] = {}
    for site in planner_lib.discover_sites(cfg, params):
        if entry_plan is not None:
            entry = entry_plan.assignment_for(site.name)
            if entry is None:
                continue
            width = int(entry.bits)
        else:
            width = int(bits)
        assignments[site.name] = (width, site.k, site.n_out)

    def pack(name, leaf):
        picked = assignments.get(name)
        if picked is None:
            return leaf
        width, k, n_out = picked
        if packing.is_packed(leaf):
            if int(leaf.bits) != width:
                raise ValueError(
                    f"site {name!r}: packed store holds {leaf.bits}-bit "
                    f"codes but the plan assigns {width}-bit — repack from "
                    f"the float parameters (packed-width-mismatch)")
            return leaf
        return packing.pack_quantized(leaf, bits=width, k=k, n_out=n_out,
                                      grid_x=grid_x)

    return _replace_leaves(params, pack)


def measure_matrix_cycles(backend: GemmBackend, weight, *, rows: int,
                          unit_n: int, num_units: int,
                          bit_blockmax: float | None = None,
                          bit_elem: float | None = None) -> dict[str, float]:
    """Measured-cycles contract for ONE (k, n_out) weight matrix on one
    backend — the single implementation behind both the planner's per-site
    report (``eval/planner.measure_site_cycles``) and the serve driver's
    decode totals (``launch/serve.measure_decode_cycles``).

    Quantizes ``weight`` per output channel (exactly what
    ``models/common.dense`` contracts under a scope), on the device it
    lives on, and returns cycles for one invocation of the ``(rows, k) @
    (k, n_out)`` decode GEMM on the ``core.ppa.DLAModel`` tiling (per-tile
    cycles × ⌈tiles / num_units⌉ waves), four ways:

    * ``measured`` — operand-driven early termination,
      ``backend.dyn_cycles(operand=codes)``;
    * ``dyn`` — paper Eq. 1 from the block-max statistic (profiled here at
      ``backend.bits`` unless ``bit_blockmax`` is supplied);
    * ``dyn_floor`` — Eq. 1 from the element-level statistic (optimistic
      bound the shared slot schedule cannot beat);
    * ``wc`` — worst case.

    For sparsity-aware designs ``dyn_floor ≤ measured ≤ wc``; designs
    without early termination report measured == dyn == floor == wc.

    Grid backends stay consistent with their per-shard cycle model: the
    per-tile cycles already cover the ceil-split contraction (plus hops),
    so the wave count comes from a *shard's* output tile share
    (``⌈n_out / units_y⌉``), matching ``ppa.GridDLAModel`` — all shards
    run their waves in parallel.
    """
    if packing.is_packed(weight):
        raise TypeError(
            "measure_matrix_cycles wants the float weight — measuring a "
            "PackedQuantized store would re-quantize its dequantized codes "
            "at a second scale; keep the float parameters for measurement "
            "(serve's plan replay does)")
    w = torch.as_tensor(weight)
    if w.dtype != torch.float32:
        w = w.to(torch.float32)
    k, n_out = int(w.shape[0]), int(w.shape[1])
    if bit_blockmax is None or bit_elem is None:
        st = sparsity.profile_tensor(w, bits=backend.bits)
        bit_blockmax = st.bit_blockmax if bit_blockmax is None else bit_blockmax
        bit_elem = st.bit_elem if bit_elem is None else bit_elem
    dla = ppa.DLAModel(design=backend.pricing_design, bits=backend.bits,
                       n=unit_n, num_units=num_units)
    shard_n_out = math.ceil(n_out / getattr(backend, "units_y", 1))
    waves = math.ceil(dla.tiles(rows, shard_n_out) / num_units)
    codes = quantize(w, bits=backend.bits).values
    return {
        "measured": float(backend.dyn_cycles(operand=codes)) * waves,
        "dyn": float(backend.dyn_cycles(k, bit_sparsity=bit_blockmax)) * waves,
        "dyn_floor": float(backend.dyn_cycles(k, bit_sparsity=bit_elem))
        * waves,
        "wc": float(backend.cycles(k)) * waves,
    }


@contextlib.contextmanager
def record_sites():
    """Record every dense GEMM site's name and shape, executing nothing.

    The planner's discovery pass: run the model inside this scope (on the
    ``meta`` device nothing is computed, see ``eval/planner.discover_sites``)
    and read ``.calls`` for the ``(site, m, k, n_out)`` of every GEMM
    ``models/common.dense`` would contract under a backend scope.  The port
    runs the layer loop eagerly, so a layer's sites appear once per layer;
    per-site invocation counts come from the parameter shapes.
    """
    with _pushed(SiteRecorder()) as execution:
        yield execution
