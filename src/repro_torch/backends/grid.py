"""Sharded PE-array grids as first-class backends.

The paper prices *single* GEMM units; an edge/cloud DLA deploys a **grid** of
them fed by a partitioned model.  This module composes any resolved
:class:`~repro_torch.backends.base.GemmBackend` into a ``units_x`` ×
``units_y`` tensor-parallel grid that is at once

* **executable** — :meth:`GridBackend.execute` splits the contraction dim K
  over ``gx`` (ceil-sized row bands) and the output columns over ``gy``.
  Each shard calls the unit's own ``exact_fn`` on its slice — for the
  ``*_cuda`` mirrors that is the hand-written kernel.  With a
  ``torch.distributed`` process group up, the grid runs on
  ``launch.mesh.grid_mesh``: one unit per rank (per card), each rank
  computing only its own ``(gx, gy)`` shard, an ``all_reduce`` of the
  partial sums over its ``gx`` line and an ``all_gather`` of the column
  bands over its ``gy`` line.  Without one, the shards run one after
  another on the device the operands live on and the ``gx`` partial sums
  are added explicitly.  Int32 partial sums (the exact designs) add exactly
  in any order; uGEMM and the rate-coded family reduce their shards as
  int64 counts and decode once (``DesignSpec.count_fn`` / ``decode_fn``),
  so a grid of any design is **bit-identical** to the single unit;
* **priceable** — :meth:`GridBackend.cycles` / :meth:`~GridBackend.dyn_cycles`
  account per-shard tile counts plus the interconnect-hop term, and
  :meth:`~repro_torch.backends.base.GemmBackend.price` routes through
  ``core.accounting.price_workload``'s grid branch (``ppa.GridDLAModel``),
  returning a ``GridCost`` with per-unit utilization and link energy;
* **plannable** — :class:`GridPlan` holds one
  :class:`~repro_torch.backends.plan.BackendPlan` per shard (each shard's
  weight slice has its own sparsity profile, so assignments may differ
  across shards) plus the *aggregate* plan execution replays.

**No per-call copies of the weight.**  On one device a ragged last shard
is simply smaller (zero codes would contribute exact zeros, so padding them
in changes nothing); across ranks the last column band is zero-padded to
the ceil width for the gather (NCCL wants equal sizes) and cut after it.
Cycle accounting uses the ceil split (:meth:`GridBackend.shard_common_dim`).
:meth:`GridBackend.shard_codes` cuts a ``(k, n)`` code matrix into
:class:`ShardedCodes`, each shard contiguous, once — on a rank only the
rank's own shard, so a card holds 1/(X·Y) of the codes; ``execute`` takes
either the flat codes (cut at every call) or a :class:`ShardedCodes` (the
serving engine's weight-code cache keeps this layout in place of the flat
codes).

**Shard-local site names.**  A grid plan addresses a single shard's
assignment with the shard-qualified name ``"{gx},{gy}/{site}"`` (see
:func:`shard_site`); :meth:`GridPlan.backend_for` resolves those to the
shard's own (unwrapped) backend, while plain site names resolve to the
aggregate entry wrapped in a :class:`GridBackend`.  Execution runs the
aggregate on every shard; per-shard heterogeneity lives in the pricing
verdict (all candidate designs are exact, so the aggregate execution's
bit-exactness evidence transfers).
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
from typing import Iterator

import torch

from repro_torch.backends.base import GemmBackend
from repro_torch.backends.plan import SCHEMA as PLAN_SCHEMA
from repro_torch.backends.plan import BackendPlan
from repro_torch.core import ppa
from repro_torch.launch import mesh as mesh_lib

__all__ = ["GRID_SCHEMA", "GridBackend", "GridPlan", "ShardedCodes", "as_grid",
           "parse_grid", "shard_site", "shard_slices", "grid_matrix_cycles",
           "load_plan"]

GRID_SCHEMA = "repro.backends.gridplan/v1"

#: the "{gx},{gy}" prefix of a shard-local site name (see :func:`shard_site`)
_SHARD_KEY_RE = re.compile(r"\d+,\d+")


def parse_grid(grid) -> tuple[int, int]:
    """Normalize a grid spec to ``(units_x, units_y)``.

    Accepts a 2-tuple/list, or a string ``"2,2"`` / ``"2x2"`` (the
    ``serve --grid`` CLI syntax).  Both entries must be >= 1.
    """
    if isinstance(grid, str):
        sep = "," if "," in grid else "x"
        parts = grid.split(sep)
        if len(parts) != 2:
            raise ValueError(f"grid spec {grid!r} is not 'X,Y' or 'XxY'")
        grid = (int(parts[0]), int(parts[1]))
    units_x, units_y = int(grid[0]), int(grid[1])
    if units_x < 1 or units_y < 1:
        raise ValueError(f"grid must be >= 1x1, got {units_x}x{units_y}")
    return (units_x, units_y)


def shard_site(coord: tuple[int, int], site: str) -> str:
    """The shard-local name of ``site`` on shard ``(gx, gy)``:
    ``"{gx},{gy}/{site}"`` (the key :class:`GridPlan` stores shards under)."""
    return f"{coord[0]},{coord[1]}/{site}"


def shard_slices(k: int, n_out: int, units_x: int,
                 units_y: int) -> dict[tuple[int, int], tuple[slice, slice]]:
    """Per-shard ``(k-rows, n-cols)`` slices of a (k, n_out) weight.

    The ceil split :meth:`GridBackend.execute` applies: shard ``(gx, gy)``
    owns rows ``[gx·⌈k/X⌉, (gx+1)·⌈k/X⌉) ∩ [0, k)`` and the matching column
    band.  Shards that are pure padding (possible when X ∤ k) map to empty
    slices.
    """
    ks, ns = -(-k // units_x), -(-n_out // units_y)
    return {
        (gx, gy): (slice(gx * ks, min((gx + 1) * ks, k)),
                   slice(gy * ns, min((gy + 1) * ns, n_out)))
        for gx in range(units_x) for gy in range(units_y)}


@dataclasses.dataclass(frozen=True, eq=False)
class ShardedCodes:
    """A ``(k, n)`` code matrix cut into a grid's shards, each contiguous.

    ``shards`` maps ``(gx, gy)`` to the shard's own ``(rows, cols)`` block
    (a pure-padding shard is an empty block).  On one device it holds every
    shard, and the blocks together hold exactly the flat matrix's bytes; on
    a rank of a distributed grid it holds the rank's own shard only
    (``owner``).  Built by :meth:`GridBackend.shard_codes`;
    :meth:`GridBackend.execute` takes it in place of the flat codes.
    """

    k: int
    n: int
    units_x: int
    units_y: int
    shards: dict
    owner: tuple[int, int] | None = None

    @property
    def grid(self) -> tuple[int, int]:
        return (self.units_x, self.units_y)

    @property
    def shape(self) -> tuple[int, int]:
        return (self.k, self.n)

    @property
    def ndim(self) -> int:
        return 2

    @property
    def device(self) -> torch.device:
        return next(iter(self.shards.values())).device

    @property
    def dtype(self) -> torch.dtype:
        return next(iter(self.shards.values())).dtype

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self.shards.values())

    def flat(self) -> torch.Tensor:
        """The ``(k, n)`` matrix reassembled (a copy; tests and checks)."""
        if self.owner is not None:
            raise ValueError(f"a rank's ShardedCodes hold shard {self.owner} "
                             f"only")
        return torch.cat([
            torch.cat([self.shards[(gx, gy)] for gy in range(self.units_y)],
                      dim=1)
            for gx in range(self.units_x)], dim=0)


@dataclasses.dataclass(frozen=True)
class GridBackend(GemmBackend):
    """A ``units_x`` × ``units_y`` tensor-parallel grid of one unit design.

    Subclasses :class:`GemmBackend`, so everything that accepts a backend
    (``use_backend``, ``price_workload``, ``models/common.dense``) accepts a
    grid.  ``name``/``bits``/``exact``/``pricing_design`` are the wrapped
    unit's; the grid adds the shard topology (``units_x`` K-partitions whose
    partial sums add, ``units_y`` output-column partitions) and the
    interconnect-hop cost terms (``core.ppa.HOP_CYCLES``).  Build with
    :func:`as_grid`.
    """

    units_x: int = 1
    units_y: int = 1

    def __post_init__(self) -> None:
        super().__post_init__()
        if self.units_x < 1 or self.units_y < 1:
            raise ValueError(f"grid must be >= 1x1, got "
                             f"{self.units_x}x{self.units_y}")

    # -- topology -----------------------------------------------------------

    @property
    def grid(self) -> tuple[int, int]:
        """The (units_x, units_y) shape (``price_workload``'s grid switch)."""
        return (self.units_x, self.units_y)

    @property
    def num_shards(self) -> int:
        return self.units_x * self.units_y

    def inner(self) -> GemmBackend:
        """The wrapped single-unit backend (one grid node)."""
        return GemmBackend(
            name=self.name, bits=self.bits, exact=self.exact,
            has_synthesis_data=self.has_synthesis_data,
            pricing_design=self.pricing_design, spec=self.spec,
            stream_len=self.stream_len)

    def shard_common_dim(self, common_dim: int) -> int:
        """Per-shard contraction length: ``⌈common_dim / units_x⌉``."""
        return -(-int(common_dim) // self.units_x)

    def hop_cycles(self) -> int:
        """Interconnect critical path per GEMM, in cycles: one hop per
        activation fan-out step (``units_y - 1``) plus one per partial-sum
        reduction step (``units_x - 1``)."""
        return ppa.HOP_CYCLES * ((self.units_x - 1) + (self.units_y - 1))

    def shard_operands(self, q) -> Iterator[tuple[tuple[int, int],
                                                  torch.Tensor]]:
        """Yield ``((gx, gy), slice)`` of a (K,) / (K, n) temporal-operand
        tile — the codes each grid node actually streams (real rows only;
        pure-padding shards are skipped).  Slices are views."""
        q = torch.as_tensor(q)
        if q.ndim == 1:
            q = q[:, None]
        for coord, (rows, cols) in shard_slices(
                q.shape[0], q.shape[1], self.units_x, self.units_y).items():
            sub = q[rows, cols]
            if sub.numel():
                yield coord, sub

    def mesh(self) -> mesh_lib.Mesh | None:
        """The distributed mesh this grid executes on (one unit per rank),
        or None without a process group (shards in turn on one device)."""
        return mesh_lib.grid_mesh(self.units_x, self.units_y)

    def shard_codes(self, b: torch.Tensor) -> ShardedCodes:
        """Cut a ``(k, n)`` code matrix into this grid's contiguous shards.

        On one device every shard: a row band that spans every column is
        already contiguous and stays a view; a column band is copied once
        here.  On a rank of a distributed grid (:meth:`mesh`) only the
        rank's own shard is kept.
        """
        mesh = self.mesh()
        owner = mesh.rank_coord if mesh is not None else None
        if isinstance(b, ShardedCodes):
            if b.grid != self.grid:
                raise ValueError(f"codes sharded for a {b.units_x}x"
                                 f"{b.units_y} grid, backend is "
                                 f"{self.units_x}x{self.units_y}")
            if b.owner != owner:
                raise ValueError(f"codes sharded for position {b.owner}, "
                                 f"this process executes {owner}")
            return b
        if b.ndim != 2:
            raise ValueError(f"shard_codes wants (K, N) codes, got "
                             f"{tuple(b.shape)}")
        k, n = int(b.shape[0]), int(b.shape[1])
        slices = shard_slices(k, n, self.units_x, self.units_y)
        if owner is not None:
            slices = {owner: slices[owner]}
        return ShardedCodes(
            k=k, n=n, units_x=self.units_x, units_y=self.units_y,
            shards={coord: b[rows, cols].contiguous()
                    for coord, (rows, cols) in slices.items()},
            owner=owner)

    # -- execution ----------------------------------------------------------

    def execute(self, a: torch.Tensor, b) -> torch.Tensor:
        """Sharded GEMM on quantized codes, bit-identical to the wrapped
        backend.

        Shapes as :meth:`GemmBackend.execute`; ``b`` may also be the
        :class:`ShardedCodes` of a shared ``(K, N)`` weight.  K is split over
        ``gx`` and N over ``gy``; each shard runs the unit's ``exact_fn``
        (or ``count_fn`` for the count-decoded designs).  With a process
        group up every rank runs its own shard and the partial sums reduce
        with collectives (:meth:`_execute_on_mesh`); without one the shards
        run in turn on the operands' device and the ``gx`` partial sums are
        added there.  Either way the sums are int32 (exact designs) or int64
        counts decoded once (uGEMM and the rate-coded family), so the
        reduction order cannot change the result.  Batched operands recurse
        on the 2-D path.
        """
        if a.ndim == 3:
            if isinstance(b, torch.Tensor) and b.ndim == 3:
                return torch.stack([self.execute(a[i], b[i])
                                    for i in range(a.shape[0])])
            m = a.shape[1]
            out = self.execute(a.reshape(-1, a.shape[-1]), b)
            return out.reshape(a.shape[0], m, out.shape[-1])
        if a.ndim != 2:
            raise ValueError(f"execute wants (M, K) or (B, M, K) operands, "
                             f"got {tuple(a.shape)}")
        codes = self.shard_codes(b)
        k = int(a.shape[1])
        if k != codes.k:
            raise ValueError(f"K mismatch: a has K={k}, b has K={codes.k}")
        # Envelope guard at the *shard-local* contraction length: each node
        # accumulates over its ceil(K / units_x) rows, so K-splitting is
        # exactly what buys headroom back (see repro_torch.analysis.ranges).
        self._guard_envelope(self.shard_common_dim(k))
        count_fn = self.spec.count_fn
        fn = count_fn if count_fn is not None else self.spec.exact_fn
        slices = shard_slices(k, codes.n, self.units_x, self.units_y)
        if codes.owner is not None:
            out = self._execute_on_mesh(a, codes, fn, slices)
        else:
            out = self._execute_in_turn(a, codes, fn, slices)
        return self.spec.decode_fn(out, self.bits) if count_fn else out

    def _execute_in_turn(self, a, codes: ShardedCodes, fn, slices):
        """Every shard on the operands' device, one after another."""
        # the activation's K band of each gx, copied once and shared by the
        # units_y shards of that band; pure-padding bands are skipped (band
        # 0 always runs, so an empty K still yields an output)
        bands = {gx: slices[(gx, 0)][0] for gx in range(self.units_x)}
        live = [gx for gx, rows in bands.items()
                if rows.stop > rows.start or gx == 0]
        a_bands = {gx: a[:, bands[gx]].contiguous() for gx in live}
        columns = []
        for gy in range(self.units_y):
            cols = slices[(0, gy)][1]
            if cols.stop <= cols.start and gy:
                continue                       # pure-padding column band
            acc = None
            for gx in live:
                part = fn(a_bands[gx], codes.shards[(gx, gy)], self.bits)
                acc = part if acc is None else acc.add_(part)
            columns.append(acc)
        return columns[0] if len(columns) == 1 else torch.cat(columns, dim=1)

    def _execute_on_mesh(self, a, codes: ShardedCodes, fn, slices):
        """This rank's shard, then ``all_reduce(SUM)`` over its ``gx`` line
        and ``all_gather`` of the column bands over its ``gy`` line.

        Every rank of the grid must make the same calls in the same order
        (SPMD).  A pure-padding shard contributes zeros; the ragged last
        column band is zero-padded to the ceil width (the gather wants equal
        sizes) and cut after it.
        """
        from repro_torch.launch import collectives as coll

        mesh = self.mesh()
        coord = codes.owner
        rows, cols = slices[coord]
        m = int(a.shape[0])
        ns = -(-codes.n // self.units_y)
        acc_dtype = torch.int64 if self.spec.count_fn is not None \
            else torch.int32
        block = codes.shards[coord]
        part = torch.zeros((m, ns), dtype=acc_dtype, device=a.device)
        width = cols.stop - cols.start
        if rows.stop > rows.start and width > 0:
            part[:, :width] = fn(a[:, rows].contiguous(), block, self.bits)
        coll.all_reduce_(part, mesh.axis_group("gx"))
        gathered = torch.empty((self.units_y * m, ns), dtype=acc_dtype,
                               device=a.device)
        coll.all_gather_into(gathered, part, mesh.axis_group("gy"))
        # (Y, M, ns) -> (M, Y * ns), then cut the padding of the last band
        out = gathered.view(self.units_y, m, ns).permute(1, 0, 2)
        return out.reshape(m, self.units_y * ns)[:, :codes.n].contiguous()

    def stream(self, a: torch.Tensor, b: torch.Tensor):
        """Grids have no single cycle-faithful stream — the schedule is
        per-shard.  Stream one node via ``.inner().stream(...)`` and account
        the grid with :meth:`cycles` / :meth:`dyn_cycles`."""
        raise NotImplementedError(
            "GridBackend.stream: stream the wrapped unit per shard "
            "(backend.inner().stream on a shard_operands slice); grid cycle "
            "accounting goes through cycles()/dyn_cycles()")

    # -- cost ---------------------------------------------------------------

    def cycles(self, common_dim: int) -> int:
        """Worst-case grid cycles: the per-shard worst case over the
        ceil-split contraction length, plus the interconnect hops."""
        return self.spec.wc_cycles_fn(
            self.bits, self.shard_common_dim(common_dim)) + self.hop_cycles()

    def dyn_cycles(self, common_dim: int | None = None, *,
                   bit_sparsity: float | None = None,
                   operand=None) -> float:
        """Dynamic grid cycles (same three modes as the base method).

        ``operand`` — per-shard early termination on each node's own slice
        of the codes; the grid finishes with its slowest shard (max), plus
        hops.  ``bit_sparsity`` — Eq. 1 applied to the per-shard worst case
        (the statistic is assumed shard-uniform; per-shard statistics go
        through :func:`grid_matrix_cycles`).  Neither — worst case.
        """
        hops = float(self.hop_cycles())
        if operand is not None:
            if bit_sparsity is not None:
                raise ValueError("pass either operand or bit_sparsity, not both")
            node = self.inner()
            slowest = max(
                (float(node.dyn_cycles(operand=sub))
                 for _, sub in self.shard_operands(operand)), default=0.0)
            return slowest + hops
        if common_dim is None:
            raise ValueError("common_dim is required without an operand")
        ks = self.shard_common_dim(common_dim)
        wc = self.spec.wc_cycles_fn(self.bits, ks)
        if bit_sparsity is not None and self.spec.sparsity_aware:
            return wc * (1.0 - float(bit_sparsity)) + hops
        return float(wc) + hops


def as_grid(backend: GemmBackend, units_x: int, units_y: int) -> GridBackend:
    """Wrap a resolved backend in a ``units_x`` × ``units_y`` grid.

    Idempotent re-gridding: an existing :class:`GridBackend` is re-shaped,
    not nested.  A ``(1, 1)`` grid is a valid degenerate topology (one node,
    zero hops) whose execute path still runs the shard loop.
    """
    units_x, units_y = parse_grid((units_x, units_y))
    return GridBackend(
        name=backend.name, bits=backend.bits, exact=backend.exact,
        has_synthesis_data=backend.has_synthesis_data,
        pricing_design=backend.pricing_design, spec=backend.spec,
        stream_len=backend.stream_len, units_x=units_x, units_y=units_y)


def grid_matrix_cycles(backend: GridBackend, weight, *, rows: int,
                       unit_n: int, num_units: int) -> dict[str, dict]:
    """Per-shard measured/dyn/floor/wc cycles for ONE (k, n_out) weight.

    Each shard's slice is profiled and measured on its *own* codes (this is
    where per-shard sparsity heterogeneity becomes visible), on the device
    the weight lives on — the slices are views, so nothing crosses to the
    host but the scalar statistics — with waves from the shard-local tile
    count and the grid's hop term added to every bound identically, so the
    single-unit invariant ``dyn_floor ≤ measured ≤ wc`` holds per shard.
    Keys are ``"{gx},{gy}"``; pure-padding shards are omitted.
    """
    from repro_torch.backends import runtime

    node = backend.inner()
    hops = float(backend.hop_cycles())
    w = torch.as_tensor(weight)
    if w.dtype != torch.float32:
        w = w.to(torch.float32)
    out: dict[str, dict] = {}
    for coord, (r, c) in shard_slices(w.shape[0], w.shape[1],
                                      backend.units_x,
                                      backend.units_y).items():
        sub = w[r, c]
        if not sub.numel():
            continue
        cyc = runtime.measure_matrix_cycles(node, sub, rows=rows,
                                            unit_n=unit_n,
                                            num_units=num_units)
        out[f"{coord[0]},{coord[1]}"] = {k: v + hops for k, v in cyc.items()}
    return out


# ---------------------------------------------------------------------------
# GridPlan
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class GridPlan:
    """Per-shard mixed-precision plans for a PE-array grid.

    ``shards`` maps ``"{gx},{gy}"`` keys to each shard's own
    :class:`BackendPlan` (derived from that shard's weight slices);
    ``aggregate`` is the plan execution replays (one entry per site, argmin
    of the summed per-shard candidate cost).  ``meta`` carries the
    per-shard and aggregate planned-vs-uniform verdicts.  Serializes to
    ``schema: repro.backends.gridplan/v1`` (one nested plan/v1 document per
    shard plus the aggregate), the same document either package reads.
    """

    units_x: int
    units_y: int
    aggregate: BackendPlan
    shards: tuple[tuple[str, BackendPlan], ...]
    meta: tuple[tuple[str, object], ...] = ()

    def __post_init__(self) -> None:
        if not isinstance(self.shards, tuple):
            object.__setattr__(self, "shards", tuple(self.shards))
        if not isinstance(self.meta, tuple):
            object.__setattr__(self, "meta",
                               tuple(sorted(dict(self.meta).items())))

    @property
    def grid(self) -> tuple[int, int]:
        return (self.units_x, self.units_y)

    def shard_plan(self, gx: int, gy: int) -> BackendPlan | None:
        """Shard ``(gx, gy)``'s own plan (None when absent)."""
        key = f"{gx},{gy}"
        for name, plan in self.shards:
            if name == key:
                return plan
        return None

    def backend_for(self, site: str) -> GemmBackend | None:
        """Resolve a site name to its executing backend.

        Plain names resolve against the aggregate plan and come back wrapped
        in a :class:`GridBackend` (this is what ``use_plan`` executes).  A
        shard-local name (``"{gx},{gy}/{site}"``, see :func:`shard_site`)
        resolves *only* against that shard's own plan and returns the
        unwrapped single-node backend; a missing shard or unmatched shard
        site is None, never an aggregate fallback (site names contain no
        commas, so the prefix is unambiguous).
        """
        head, sep, rest = site.partition("/")
        if sep and _SHARD_KEY_RE.fullmatch(head):
            gx, gy = (int(p) for p in head.split(","))
            plan = self.shard_plan(gx, gy)
            return None if plan is None else plan.backend_for(rest)
        backend = self.aggregate.backend_for(site)
        if backend is None:
            return None
        return as_grid(backend, self.units_x, self.units_y)

    def distinct_backends(self) -> tuple[tuple[str, int], ...]:
        """Sorted unique (design, bits) of the *aggregate* (executed) plan."""
        return self.aggregate.distinct_backends()

    def shard_distinct_backends(self) -> tuple[tuple[str, int], ...]:
        """Sorted unique (design, bits) across every shard's own plan."""
        pairs = {(s.design, s.bits)
                 for _, plan in self.shards for s in plan.sites}
        return tuple(sorted(pairs))

    def heterogeneous_sites(self) -> tuple[str, ...]:
        """Site names whose assignment differs across shards — the sites
        where per-shard sparsity actually flips the sweet spot."""
        out = []
        for entry in self.aggregate.sites:
            picks = {(p.assignment_for(entry.pattern).design,
                      p.assignment_for(entry.pattern).bits)
                     for _, p in self.shards
                     if p.assignment_for(entry.pattern) is not None}
            if len(picks) > 1:
                out.append(entry.pattern)
        return tuple(out)

    def metadata(self) -> dict:
        return dict(self.meta)

    # -- (de)serialization --------------------------------------------------

    def to_json(self, indent: int = 2) -> str:
        """Stable JSON rendering (``schema: repro.backends.gridplan/v1``)."""
        doc = {
            "schema": GRID_SCHEMA,
            "grid": [self.units_x, self.units_y],
            "meta": dict(self.meta),
            "aggregate": json.loads(self.aggregate.to_json()),
            "shards": {key: json.loads(plan.to_json())
                       for key, plan in self.shards},
        }
        return json.dumps(doc, indent=indent)

    @classmethod
    def from_json(cls, text: str) -> "GridPlan":
        """Parse :meth:`to_json` output; validates both schema layers."""
        doc = json.loads(text)
        if doc.get("schema") != GRID_SCHEMA:
            raise ValueError(
                f"not a grid plan: schema {doc.get('schema')!r} "
                f"(expected {GRID_SCHEMA!r})")
        grid = doc.get("grid")
        if not isinstance(grid, (list, tuple)) or len(grid) != 2:
            raise ValueError(f"grid plan needs a 2-element grid, got {grid!r}")
        sub = lambda d: BackendPlan.from_json(json.dumps(d))  # noqa: E731
        return cls(units_x=int(grid[0]), units_y=int(grid[1]),
                   aggregate=sub(doc["aggregate"]),
                   shards=tuple(sorted(
                       (key, sub(val))
                       for key, val in doc.get("shards", {}).items())),
                   meta=tuple(sorted(doc.get("meta", {}).items())))

    def save(self, path: str | os.PathLike) -> str:
        """Write :meth:`to_json` to ``path`` (dirs created); returns path."""
        path = os.fspath(path)
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as fh:
            fh.write(self.to_json())
            fh.write("\n")
        return path

    @classmethod
    def load(cls, path: str | os.PathLike) -> "GridPlan":
        with open(os.fspath(path)) as fh:
            return cls.from_json(fh.read())


def load_plan(path: str | os.PathLike) -> BackendPlan | GridPlan:
    """Load either plan flavour, saved by either package, by sniffing the
    ``schema`` field.

    ``repro.backends.plan/v1`` → :class:`BackendPlan`;
    ``repro.backends.gridplan/v1`` → :class:`GridPlan`.  Anything else is a
    ValueError naming both accepted schemas.
    """
    with open(os.fspath(path)) as fh:
        text = fh.read()
    schema = json.loads(text).get("schema")
    if schema == GRID_SCHEMA:
        return GridPlan.from_json(text)
    if schema == PLAN_SCHEMA:
        return BackendPlan.from_json(text)
    raise ValueError(f"{path}: unknown plan schema {schema!r} "
                     f"(expected {PLAN_SCHEMA!r} or {GRID_SCHEMA!r})")
