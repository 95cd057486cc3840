"""Port vs reference: sharded PE-array grids (``backends/grid.py``), grid
pricing, grid stores, grid plans and grid serving.

Inputs come from numpy seeds and go to both packages.  The reference's own
multi-device test shows that its grid equals its single unit bit for bit,
so the oracle for execution is the reference's *single unit*
(``resolve(design, bits).execute``), and its ``(1, 1)`` grid runs in
process where the whole grid path is needed (the engine).  Contracts:

* ``parse_grid`` / ``shard_slices`` / ``shard_site`` — equal;
* ``as_grid(b, X, Y).execute`` — for every design at bits 2/4/8 and grids
  (2, 2), (4, 2), (3, 2), at the reference test's shapes and at a K the
  grid does not divide: EQUAL to the port's single unit, and equal to the
  reference's single unit (uGEMM at 8 bits within the documented
  ``rtol=1e-4, atol=1e-2`` of the port's deliberate ``ugemm_exact``
  difference, ROADMAP Queue 3); also from :class:`ShardedCodes`, for the
  ``*_cuda`` mirrors (their plain versions here) and the rate-coded family;
* ``cycles`` / ``dyn_cycles`` (worst case, sparsity, operand) — equal;
* ``GridCost`` and ``grid_matrix_cycles`` — integers equal, floats within
  ``PRICE_TOL``;
* the shipped grid plan — loads in both and re-serialises to the same
  bytes in both, stably;
* ``build_grid_plan`` on the smoke config — equal entry for entry
  (``rel_mse`` within ``REL_MSE_TOL``: the reference takes float32 means),
  equal meta, equal markdown rows, equal lint findings;
* grid stores — words, codes and round trips equal;
* a ``(2, 2)`` ``GridPlan`` forward — logits bit-identical to
  ``use_backend("tubgemm", bits=4)`` over the same sites;
* ``ServingEngine(grid=(2, 2))`` — token streams identical to the flat
  engine's and to the reference engine's on a ``(1, 1)`` grid (fp32,
  per-row scales; the reference's meshes patched to Auto axes on the
  test's side, as ``tests/test_torch_serving.py`` does).
"""

import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import backends as ref_backends
from repro import configs as ref_configs
from repro.analysis import plan_lint as ref_lint
from repro.backends import grid as ref_grid
from repro.core import accounting as ref_accounting
from repro.core import packing as ref_packing
from repro.eval import planner as ref_planner
from repro.models import common as ref_common
from repro.models import model as ref_model
from repro.serving import engine as ref_engine_mod
from repro.serving import traffic as ref_traffic
from repro_torch import backends as port_backends
from repro_torch import configs as port_configs
from repro_torch.analysis import plan_lint as port_lint
from repro_torch.backends import grid as port_grid
from repro_torch.core import accounting as port_accounting
from repro_torch.core import packing as port_packing
from repro_torch.eval import planner as port_planner
from repro_torch.launch import mesh as port_mesh
from repro_torch.models import common as port_common
from repro_torch.models import model as port_model
from repro_torch.serving import ServingEngine, TrafficConfig, generate_trace

ROOT = pathlib.Path(__file__).resolve().parents[1]
GRID_FILE = ROOT / "examples" / "plans" / "llama3_8b_smoke.grid2x2.json"
DESIGNS = ("ugemm", "tugemm", "tubgemm", "bgemm")
GRIDS = ((2, 2), (4, 2), (3, 2))
#: the reference test's (M, K, N), and one whose K no grid here divides
SHAPES = ((6, 24, 20), (5, 37, 11))
REL_MSE_TOL = 1e-5
PRICE_TOL = 1e-12
UGEMM8_TOL = dict(rtol=1e-4, atol=1e-2)
PRICED = ("dyn_energy_uj", "dyn_latency_us", "wc_energy_uj", "wc_latency_us")


def _codes(rng, shape, bits):
    v = 2 ** (bits - 1) - 1
    return rng.integers(-v, v + 1, shape).astype(np.int8)


def _t(x):
    return torch.from_numpy(np.asarray(x))


# ---------------------------------------------------------------------------
# topology
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k,n,x,y", [(10, 7, 4, 2), (24, 20, 2, 2),
                                     (5, 3, 4, 4), (37, 11, 3, 2),
                                     (4096, 14336, 2, 2), (1, 1, 1, 1)])
def test_topology_equals_reference(k, n, x, y):
    assert port_grid.shard_slices(k, n, x, y) == ref_grid.shard_slices(k, n, x, y)
    for spec in (f"{x},{y}", f"{x}x{y}", (x, y), [x, y]):
        assert port_grid.parse_grid(spec) == ref_grid.parse_grid(spec)
    assert port_grid.shard_site((x, y), "layers/attn/wq") == \
        ref_grid.shard_site((x, y), "layers/attn/wq")
    cover = np.zeros((k, n), np.int32)
    for rows, cols in port_grid.shard_slices(k, n, x, y).values():
        cover[rows, cols] += 1
    assert (cover == 1).all()


def test_bad_grids_and_meshes():
    for bad in ("2,0", "2", (0, 1)):
        with pytest.raises(ValueError):
            port_grid.parse_grid(bad)
    with pytest.raises(NotImplementedError, match="256 positions and the world has 1 rank"):
        port_mesh.make_production_mesh()
    with pytest.raises(RuntimeError, match="no torch.distributed process group"):
        port_mesh.make_mesh((2, 1), ("data", "model"), "cpu")
    mesh = port_mesh.make_grid_mesh(2, 3, "cpu")
    assert mesh.axes == ("gx", "gy") and mesh.size == 6
    assert {mesh.device_of((gx, gy)) for gx in range(2) for gy in range(3)} \
        == {torch.device("cpu")}
    assert port_mesh.make_mesh((1, 1), ("data", "model"), "cpu").size == 1
    be = port_backends.as_grid(port_backends.resolve("tubgemm", bits=4), 2, 2)
    with pytest.raises(NotImplementedError, match="per shard"):
        be.stream(torch.zeros((1, 4), dtype=torch.int8),
                  torch.zeros((4, 1), dtype=torch.int8))


def test_grid_backend_metadata_equals_reference():
    for design in (*DESIGNS, "tubgemm_cuda"):
        port = port_backends.as_grid(port_backends.resolve(design, bits=4), 3, 2)
        assert isinstance(port, port_backends.GemmBackend)
        assert (port.grid, port.num_shards, port.hop_cycles(),
                port.shard_common_dim(37)) == ((3, 2), 6, 96, 13)
        inner = port.inner()
        assert type(inner) is port_backends.GemmBackend
        assert (inner.name, inner.bits, inner.pricing_design) == \
            (port.name, port.bits, port.pricing_design)
        # re-gridding reshapes, never nests; resolve passes grids through
        assert port_backends.as_grid(port, 1, 4).grid == (1, 4)
        assert port_backends.resolve(port) is port
    if "ugemm" in DESIGNS:
        ref = ref_backends.as_grid(ref_backends.resolve("ugemm", bits=4), 3, 2)
        port = port_backends.as_grid(port_backends.resolve("ugemm", bits=4), 3, 2)
        assert (port.hop_cycles(), port.cycles(37)) == \
            (ref.hop_cycles(), ref.cycles(37))


# ---------------------------------------------------------------------------
# execution: the grid equals the single unit, bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("bits", (2, 4, 8))
@pytest.mark.parametrize("design", DESIGNS)
def test_grid_execute_equals_single_unit(design, bits, grid):
    rng = np.random.default_rng(bits * 10 + grid[0])
    unit = port_backends.resolve(design, bits=bits)
    ref_unit = ref_backends.resolve(design, bits=bits)
    gb = port_backends.as_grid(unit, *grid)
    for m, k, n in SHAPES:
        a, w = _codes(rng, (m, k), bits), _codes(rng, (k, n), bits)
        got = gb.execute(_t(a), _t(w))
        want = unit.execute(_t(a), _t(w))
        assert got.dtype == want.dtype and torch.equal(got, want)
        assert torch.equal(gb.execute(_t(a), gb.shard_codes(_t(w))), want)
        ref = np.asarray(ref_unit.execute(jnp.asarray(a), jnp.asarray(w)))
        if design == "ugemm" and bits == 8:
            np.testing.assert_allclose(got.numpy(), ref, **UGEMM8_TOL)
        else:
            np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("spec", ["tubgemm_cuda", "tugemm_cuda",
                                  "ugemm_stochastic:16", "ugemm_stochastic:64"])
def test_grid_execute_mirrors_and_stream_family(spec):
    """The ``*_cuda`` mirrors (their plain versions on the CPU) and the
    rate-coded family: grid equal to the single unit at every grid, 2-D and
    batched."""
    rng = np.random.default_rng(7)
    unit = port_backends.resolve(spec, bits=4)
    a, w = _t(_codes(rng, (3, 5, 37), 4)), _t(_codes(rng, (37, 11), 4))
    w3 = _t(_codes(rng, (3, 37, 11), 4))
    for grid in (*GRIDS, (1, 1), (8, 3)):
        gb = port_backends.as_grid(unit, *grid)
        assert torch.equal(gb.execute(a[0], w), unit.execute(a[0], w))
        assert torch.equal(gb.execute(a, w), unit.execute(a, w))
        assert torch.equal(gb.execute(a, w3), unit.execute(a, w3))


def test_sharded_codes_layout():
    rng = np.random.default_rng(3)
    w = _t(_codes(rng, (37, 11), 4))
    for grid in ((2, 2), (3, 1), (4, 3)):
        gb = port_backends.as_grid(port_backends.resolve("bgemm", bits=4), *grid)
        codes = gb.shard_codes(w)
        assert codes.shape == (37, 11) and codes.grid == grid
        assert torch.equal(codes.flat(), w) and codes.nbytes() == w.numel()
        assert all(t.is_contiguous() for t in codes.shards.values())
        assert gb.shard_codes(codes) is codes
        if grid[1] == 1:    # whole-row bands stay views of the weight
            for (gx, _), t in codes.shards.items():
                rows = port_grid.shard_slices(37, 11, *grid)[(gx, 0)][0]
                assert t.data_ptr() == w[rows].data_ptr()
    other = port_backends.as_grid(port_backends.resolve("bgemm", bits=4), 1, 2)
    with pytest.raises(ValueError, match="sharded for a"):
        other.execute(_t(_codes(rng, (2, 37), 4)), codes)
    with pytest.raises(ValueError, match="K mismatch"):
        other.execute(_t(_codes(rng, (2, 36), 4)), w)


def test_shard_local_envelope_guard():
    """uGEMM at 8 bits: a K the single unit refuses runs once the grid
    splits it under the envelope (the guard is at the shard-local K)."""
    from repro_torch.analysis import ranges
    safe = ranges.max_safe_k("ugemm", 8)
    unit = port_backends.resolve("ugemm", bits=8)
    a = torch.zeros((1, safe + 1), dtype=torch.int8)
    w = torch.zeros((safe + 1, 2), dtype=torch.int8)
    with pytest.raises(ValueError):
        unit.execute(a, w)
    out = port_backends.as_grid(unit, 2, 1).execute(a, w)
    assert out.shape == (1, 2) and not out.any()


# ---------------------------------------------------------------------------
# cost: cycles, dyn_cycles, GridCost, grid_matrix_cycles
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("grid", ((1, 1), *GRIDS))
@pytest.mark.parametrize("design", DESIGNS)
def test_cycles_equal_reference(design, grid):
    rng = np.random.default_rng(11)
    for bits in (2, 4, 8):
        port = port_backends.as_grid(port_backends.resolve(design, bits=bits), *grid)
        ref = ref_backends.as_grid(ref_backends.resolve(design, bits=bits), *grid)
        for k in (1, 24, 37, 4096):
            assert port.cycles(k) == ref.cycles(k)
            assert port.dyn_cycles(k) == ref.dyn_cycles(k)
            assert port.dyn_cycles(k, bit_sparsity=0.3) == \
                pytest.approx(ref.dyn_cycles(k, bit_sparsity=0.3), rel=PRICE_TOL)
        q = _codes(rng, (37, 9), bits)
        assert port.dyn_cycles(operand=_t(q)) == \
            ref.dyn_cycles(operand=jnp.asarray(q))
        assert port.dyn_cycles(operand=_t(q[:, 0])) == \
            ref.dyn_cycles(operand=jnp.asarray(q[:, 0]))
        with pytest.raises(ValueError):
            port.dyn_cycles(37, bit_sparsity=0.1, operand=_t(q))


def _assert_cost_equal(port, ref):
    assert type(port).__name__ == type(ref).__name__
    for f in ("design", "bits", "unit_n", "num_units", "total_macs"):
        assert getattr(port, f) == getattr(ref, f), f
    for f in ("wc_latency_us", "dyn_latency_us", "wc_energy_uj",
              "dyn_energy_uj", "energy_per_mac_pj", "sparsity_saving"):
        assert getattr(port, f) == pytest.approx(getattr(ref, f),
                                                 rel=PRICE_TOL), f
    assert port.per_layer.keys() == ref.per_layer.keys()
    for name, (lat, en) in port.per_layer.items():
        assert (lat, en) == pytest.approx(ref.per_layer[name], rel=PRICE_TOL)
    if hasattr(ref, "units_x"):
        assert (port.units_x, port.units_y, port.grid) == \
            (ref.units_x, ref.units_y, ref.grid)
        for f in ("hop_energy_uj", "hop_latency_us", "utilization",
                  "hop_energy_share"):
            assert getattr(port, f) == pytest.approx(getattr(ref, f),
                                                     rel=PRICE_TOL), f


@pytest.mark.parametrize("grid", ((1, 1), (2, 2), (3, 2), (4, 1)))
@pytest.mark.parametrize("spec", ["tubgemm", "tugemm", "bgemm", "ugemm",
                                  "ugemm_stochastic:32"])
def test_grid_cost_equals_reference(spec, grid):
    calls = [("layers/attn/wq", 8, 4096, 4096, 0.21, 32),
             ("layers/mlp/w_down", 8, 14336, 4096, 0.33, 32),
             ("lm_head", 8, 4096, 128256, 0.27, 1),
             ("odd", 5, 37, 11, 0.5, 2)]
    port_rec = port_accounting.GemmWorkloadRecorder()
    ref_rec = ref_accounting.GemmWorkloadRecorder()
    for c in calls:
        port_rec.record(*c)
        ref_rec.record(*c)
    port = port_backends.as_grid(port_backends.resolve(spec, bits=4), *grid)
    ref = ref_backends.as_grid(ref_backends.resolve(spec, bits=4), *grid)
    got = port.price(port_rec.calls, unit_n=64, num_units=16)
    if port.stream_len:
        # The reference's as_grid drops the stream length (its grid of a
        # rate-coded unit prices at cycle_scale 1); the port's keeps it, so
        # the oracle is the reference's grid branch at the stream's scale
        # (ROADMAP Queue 3, deliberate differences).
        assert ref.stream_len is None and port.cycle_scale == 2.0
        want = ref_accounting._price_grid(
            ref_rec.calls, "ugemm", 4, 64, 16, *grid,
            cycle_scale=port.cycle_scale)
    else:
        want = ref.price(ref_rec.calls, unit_n=64, num_units=16)
    _assert_cost_equal(got, want)
    # a plain backend with grid= takes the same branch
    _assert_cost_equal(
        port_accounting.price_workload(port_rec.calls, design=spec.split(":")[0],
                                       bits=4, unit_n=32, grid=grid),
        ref_accounting.price_workload(ref_rec.calls, design=spec.split(":")[0],
                                      bits=4, unit_n=32, grid=grid))


@pytest.mark.parametrize("grid", ((2, 2), (3, 2), (1, 3)))
@pytest.mark.parametrize("design", DESIGNS)
def test_grid_matrix_cycles_equal_reference(design, grid):
    rng = np.random.default_rng(5)
    w = rng.normal(0, 1, (70, 45)).astype(np.float32)
    w[:, :7] *= 0.05                       # one sparser column band
    port = port_backends.as_grid(port_backends.resolve(design, bits=4), *grid)
    ref = ref_backends.as_grid(ref_backends.resolve(design, bits=4), *grid)
    got = port_backends.grid_matrix_cycles(port, _t(w), rows=8, unit_n=16,
                                           num_units=4)
    want = ref_backends.grid_matrix_cycles(ref, jnp.asarray(w), rows=8,
                                           unit_n=16, num_units=4)
    assert got.keys() == want.keys()
    for coord in want:
        assert got[coord] == pytest.approx(want[coord], rel=PRICE_TOL), coord
        c = got[coord]
        assert c["dyn_floor"] - 0.5 <= c["measured"] <= c["wc"] + 0.5
    # the grid's waves come from a shard's output share, as the reference's
    assert port_backends.measure_matrix_cycles(
        port, _t(w), rows=8, unit_n=16, num_units=4) == pytest.approx(
        ref_backends.measure_matrix_cycles(ref, jnp.asarray(w), rows=8,
                                           unit_n=16, num_units=4),
        rel=PRICE_TOL)


# ---------------------------------------------------------------------------
# grid plans: the shipped file, build_grid_plan, lint, markdown
# ---------------------------------------------------------------------------

def test_shipped_grid_plan_round_trips_byte_for_byte(tmp_path):
    # the shipped file predates the entries' stream_len field, so both
    # packages re-serialise it to the same (new) bytes, stably
    port = port_backends.load_plan(GRID_FILE)
    ref = ref_backends.load_plan(GRID_FILE)
    assert isinstance(port, port_backends.GridPlan)
    text = port.to_json()
    assert text == ref.to_json()
    assert port_backends.GridPlan.from_json(text).to_json() == text
    assert port.save(tmp_path / "g.json") and \
        (tmp_path / "g.json").read_text() == text + "\n"
    assert port_backends.GridPlan.load(tmp_path / "g.json") == port
    assert ref_backends.load_plan(tmp_path / "g.json").to_json() == text
    assert port.heterogeneous_sites() == ref.heterogeneous_sites()
    assert port.distinct_backends() == ref.distinct_backends()
    assert port.shard_distinct_backends() == ref.shard_distinct_backends()
    for site in ("layers/attn/wq", "1,0/layers/attn/wq", "0,1/lm_head",
                 "7,7/lm_head", "nothing"):
        p, r = port.backend_for(site), ref.backend_for(site)
        assert (p is None) == (r is None), site
        if p is not None:
            assert (p.name, p.bits, getattr(p, "grid", None)) == \
                (r.name, r.bits, getattr(r, "grid", None)), site
    with pytest.raises(ValueError, match="not a grid plan"):
        port_backends.GridPlan.from_json(json.dumps({"schema": "x"}))
    with pytest.raises(ValueError, match="2-element grid"):
        port_backends.GridPlan.from_json(json.dumps(
            {"schema": port_backends.GRID_SCHEMA, "grid": [2]}))
    (tmp_path / "bad.json").write_text(json.dumps({"schema": "nope"}))
    with pytest.raises(ValueError, match="unknown plan schema"):
        port_backends.load_plan(tmp_path / "bad.json")


@pytest.fixture(scope="module")
def smoke():
    ref_cfg = ref_configs.get_smoke_config("llama3-8b").replace(
        compute_dtype="float32")
    port_cfg = port_configs.get_smoke_config("llama3-8b").replace(
        compute_dtype="float32")
    ref_params = ref_model.init_params(ref_cfg, jax.random.PRNGKey(0))
    port_params = port_model.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, ref_params), device="cpu")
    return ref_cfg, port_cfg, ref_params, port_params


@pytest.fixture(scope="module")
def grid_plans(smoke):
    ref_cfg, port_cfg, ref_params, port_params = smoke
    kw = dict(batch=4, grid=(2, 2), unit_n=64, num_units=64)
    return (ref_planner.build_grid_plan(ref_cfg, ref_params, **kw),
            port_planner.build_grid_plan(port_cfg, port_params, **kw))


def _assert_entries_equal(ref_plan, port_plan):
    assert len(port_plan.sites) == len(ref_plan.sites)
    for r, p in zip(ref_plan.sites, port_plan.sites):
        for f in ("pattern", "design", "bits", "m", "k", "n_out", "count",
                  "word", "bit_elem", "bit_blockmax", "guard_relaxed",
                  "stream_len"):
            assert getattr(p, f) == getattr(r, f), (r.pattern, f)
        assert p.rel_mse == pytest.approx(r.rel_mse, rel=REL_MSE_TOL)
        for f in PRICED:
            assert getattr(p, f) == pytest.approx(getattr(r, f),
                                                  rel=PRICE_TOL), (r.pattern, f)


def _assert_tree_close(port, ref, path=""):
    if isinstance(ref, dict):
        assert port.keys() == ref.keys(), path
        for k in ref:
            _assert_tree_close(port[k], ref[k], f"{path}/{k}")
    elif isinstance(ref, (list, tuple)):
        assert len(port) == len(ref), path
        for i, (p, r) in enumerate(zip(port, ref)):
            _assert_tree_close(p, r, f"{path}[{i}]")
    elif isinstance(ref, float):
        assert port == pytest.approx(ref, rel=PRICE_TOL), path
    else:
        assert port == ref, path


def test_build_grid_plan_equals_reference(grid_plans):
    ref, port = grid_plans
    assert isinstance(port, port_backends.GridPlan) and port.grid == (2, 2)
    _assert_entries_equal(ref.aggregate, port.aggregate)
    assert [k for k, _ in port.shards] == [k for k, _ in ref.shards]
    for (_, r), (_, p) in zip(ref.shards, port.shards):
        _assert_entries_equal(r, p)
        _assert_tree_close(p.metadata(), r.metadata())
    _assert_tree_close(port.aggregate.metadata(), ref.aggregate.metadata())
    _assert_tree_close(port.metadata(), ref.metadata())
    assert port.heterogeneous_sites() == ref.heterogeneous_sites()
    # per-shard and aggregate totals never exceed their best uniform plan
    totals = port.metadata()["totals"]
    agg = totals["aggregate"]
    best = agg["uniform"][agg["uniform_best"]]["dyn_energy_uj"]
    assert agg["planned"]["dyn_energy_uj"] <= best * (1 + 1e-9)
    assert agg["planned_heterogeneous"]["dyn_energy_uj"] <= \
        agg["planned"]["dyn_energy_uj"] * (1 + 1e-9)
    for verdict in totals["per_shard"].values():
        b = verdict["uniform"][verdict["uniform_best"]]["dyn_energy_uj"]
        assert verdict["planned"]["dyn_energy_uj"] <= b * (1 + 1e-9)
    # and it survives its JSON round trip
    assert port_backends.GridPlan.from_json(port.to_json()) == port


def test_grid_plan_markdown_and_lint_equal_reference(grid_plans, smoke):
    ref, port = grid_plans
    # every line but the closing note (which names each package's executor)
    rows = lambda md: [line for line in md.splitlines()  # noqa: E731
                       if not line.startswith("Per-site, per-shard")]
    assert rows(port_planner.grid_plan_to_markdown(port)) == \
        rows(ref_planner.grid_plan_to_markdown(ref))
    _, port_cfg, _, port_params = smoke
    names = [s.name for s in port_planner.discover_sites(port_cfg, port_params)]
    keys = lambda fs: [(f.rule, f.severity, f.where) for f in fs]  # noqa: E731
    assert keys(port_lint.lint_grid_plan(port, site_names=names)) == \
        keys(ref_lint.lint_grid_plan(ref, site_names=names)) == []
    # a document with faults at both levels: an aggregate entry whose K
    # overflows even split over the grid, a shard entry over its own K,
    # a dead aggregate pattern and a packed-width mismatch
    doc = json.loads(port.to_json())
    doc["aggregate"]["sites"][0].update(design="bgemm", bits=8, k=1 << 22)
    doc["shards"]["1,1"]["sites"][1].update(design="tugemm", bits=8, k=1 << 18)
    doc["aggregate"]["sites"].append(dict(doc["aggregate"]["sites"][1],
                                          pattern="nothing/*"))
    text = json.dumps(doc)
    kw = dict(site_names=names, packed_bits={"lm_head": 2})
    got = keys(port_lint.lint_plan(port_backends.GridPlan.from_json(text), **kw))
    assert got == keys(ref_lint.lint_plan(ref_grid.GridPlan.from_json(text), **kw))
    assert {"acc-overflow", "dead-pattern", "packed-width-mismatch"} <= \
        {rule for rule, _, _ in got}


def test_measure_grid_site_cycles_equal_reference(grid_plans, smoke):
    ref, port = grid_plans
    ref_cfg, port_cfg, ref_params, port_params = smoke
    ref_sites = {s.name: s for s in ref_planner.discover_sites(
        ref_cfg, ref_params, batch=4)}
    port_sites = {s.name: s for s in port_planner.discover_sites(
        port_cfg, port_params, batch=4)}
    for r, p in zip(ref.aggregate.sites, port.aggregate.sites):
        got = port_planner.measure_grid_site_cycles(
            port_sites[p.pattern], p, grid=(2, 2), unit_n=64, num_units=64)
        want = ref_planner.measure_grid_site_cycles(
            ref_sites[r.pattern], r, grid=(2, 2), unit_n=64, num_units=64)
        assert got.keys() == want.keys()
        for coord in want:
            assert got[coord] == pytest.approx(want[coord], rel=PRICE_TOL)


def test_use_plan_envelope_at_the_grid_split():
    """An entry whose recorded K overflows one unit but not a shard is
    admitted under a grid whose K split brings it inside the envelope."""
    from repro_torch.analysis import ranges
    safe = ranges.max_safe_k("bgemm", 8)
    plan = port_backends.BackendPlan(sites=(port_backends.SiteAssignment(
        "layers/mlp/w_down", "bgemm", 8, k=safe + 1),))
    with pytest.raises(ValueError, match="largest safe K"):
        with port_backends.use_plan(plan):
            pass
    with port_backends.use_plan(plan, grid=(2, 1)):
        pass
    gplan = port_backends.GridPlan(units_x=2, units_y=1, aggregate=plan,
                                   shards=())
    with port_backends.use_plan(gplan) as ex:
        assert ex.backend_for("layers/mlp/w_down").grid == (2, 1)


# ---------------------------------------------------------------------------
# grid stores
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("grid_x", (2, 3, 4))
@pytest.mark.parametrize("bits", (2, 4, 8))
def test_grid_stores_equal_reference(bits, grid_x):
    rng = np.random.default_rng(bits + 10 * grid_x)
    w = rng.normal(0, 1, (3, 37, 5)).astype(np.float32)      # a stacked leaf
    port = port_packing.pack_quantized(_t(w), bits=bits, k=37, n_out=5,
                                       grid_x=grid_x)
    ref = ref_packing.pack_quantized(jnp.asarray(w), bits=bits, k=37, n_out=5,
                                     grid_x=grid_x)
    assert port.grid_x == ref.grid_x == grid_x
    assert tuple(port.packed.shape) == ref.packed.shape
    np.testing.assert_array_equal(port.packed.numpy(), np.asarray(ref.packed))
    np.testing.assert_array_equal(port.scale.numpy(), np.asarray(ref.scale))
    assert port.shape == ref.shape == (3, 37, 5)
    np.testing.assert_array_equal(port.codes().numpy(), np.asarray(ref.codes()))
    q = port.quantized()
    np.testing.assert_array_equal(q.values.numpy(),
                                  np.asarray(ref.quantized().values))
    np.testing.assert_array_equal(port.dequantize().numpy(),
                                  np.asarray(ref.dequantize()))
    assert port.stored_bytes == ref.stored_bytes
    # one layer of the stack, and the flat store's codes: all the same codes
    layer = port[1]
    assert layer.shape == (37, 5) and layer.grid_x == grid_x
    flat = port_packing.pack_quantized(_t(w), bits=bits, k=37, n_out=5)
    assert torch.equal(port.codes(), flat.codes())
    assert torch.equal(layer.codes(), flat[1].codes())
    # from_quantized packs the same bands
    again = port_packing.from_quantized(flat[1].quantized(), grid_x=grid_x)
    assert torch.equal(again.packed, layer.packed)
    # a grid store executes under a grid backend like the float weight
    gb = port_backends.as_grid(port_backends.resolve("tubgemm", bits=bits),
                               grid_x, 2)
    a = _t(_codes(rng, (4, 37), bits))
    assert torch.equal(gb.execute(a, layer.quantized().values),
                       gb.inner().execute(a, flat[1].quantized().values))


# ---------------------------------------------------------------------------
# the model and the engine on a grid
# ---------------------------------------------------------------------------

def test_grid_plan_forward_equals_flat_backend(smoke):
    _, port_cfg, _, port_params = smoke
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, port_cfg.vocab_size, (2, 4)).astype(np.int32))
    flat = port_backends.BackendPlan(sites=(port_backends.SiteAssignment(
        pattern="*", design="tubgemm", bits=4),))
    gplan = port_backends.GridPlan(units_x=2, units_y=2, aggregate=flat,
                                   shards=())
    with port_backends.use_plan(gplan) as grid_exec:
        logits_grid, _ = port_model.forward(port_params, port_cfg, tokens)
    with port_backends.use_backend("tubgemm", bits=4) as flat_exec:
        logits_flat, _ = port_model.forward(port_params, port_cfg, tokens)
    grid_sites = sorted(c.site for c in grid_exec.calls)
    assert grid_sites == sorted(c.site for c in flat_exec.calls)
    assert len(grid_sites) == 7 * port_cfg.num_layers + 1
    assert all(isinstance(grid_exec.backend_for(s), port_backends.GridBackend)
               for s in grid_sites)
    assert torch.equal(logits_grid, logits_flat)


def _auto_grid_mesh(units_x, units_y):
    auto = jax.sharding.AxisType.Auto
    return jax.make_mesh((units_x, units_y), ("gx", "gy"),
                         axis_types=(auto, auto))


def test_grid_engine_streams_equal_flat_and_reference(smoke, monkeypatch):
    ref_cfg, port_cfg, ref_params, port_params = smoke
    monkeypatch.setattr(ref_engine_mod, "make_grid_mesh", _auto_grid_mesh)
    monkeypatch.setattr(ref_grid, "grid_mesh", _auto_grid_mesh)
    kw = dict(num_requests=6, arrival_rate=1.0, seed=0)
    ekw = dict(max_batch=4, page_size=8, max_seq_len=64, bits=4,
               backend="tubgemm")
    ref_eng = ref_engine_mod.ServingEngine(ref_cfg, ref_params,
                                           attention="gather", grid=(1, 1),
                                           **ekw)
    with ref_common.activation_scaling("per-row"):
        ref_rep = ref_eng.run(ref_traffic.generate_trace(
            ref_traffic.TrafficConfig(**kw)), "continuous")
    trace = generate_trace(TrafficConfig(**kw))
    reps = {}
    for grid in (None, (2, 2), (3, 1)):
        eng = ServingEngine(port_cfg, port_params, attention="fused",
                            device="cpu", grid=grid, **ekw)
        with port_common.activation_scaling("per-row"):
            reps[grid] = eng.run(trace, "continuous")
        if grid is not None:
            # the engine's code cache holds each weight's shard blocks, in
            # place of the flat codes
            entries = list(eng.weight_cache.values())
            assert len(entries) == 7 * port_cfg.num_layers + 1
            assert all(isinstance(wq.values, port_backends.ShardedCodes)
                       and wq.values.grid == grid for _, wq in entries)
    for grid, rep in reps.items():
        assert rep.request_tokens == reps[None].request_tokens, grid
        assert rep.events == ref_rep.events, grid
        assert rep.request_tokens == ref_rep.request_tokens, grid
    # the grid engine prices its steps on the grid (GridCost), so its
    # energy differs from the flat engine's by the hop and padding terms
    assert reps[(2, 2)].energy_uj != reps[None].energy_uj
    assert reps[None].energy_uj == pytest.approx(ref_rep.energy_uj, rel=1e-6)


def test_grid_engine_packed_and_plan(smoke):
    """A grid engine over the shipped grid plan, from float weights and from
    grid stores (``packed=True`` packs per K band): identical streams."""
    _, port_cfg, _, port_params = smoke
    trace = generate_trace(TrafficConfig(num_requests=4, arrival_rate=1.0,
                                         seed=2))
    gplan = port_backends.load_plan(GRID_FILE)
    reps = []
    for packed in (False, True):
        eng = ServingEngine(port_cfg, port_params, device="cpu", plan=gplan,
                            grid=gplan.grid, packed=packed, max_batch=4,
                            page_size=8, max_seq_len=64)
        if packed:
            stores = [leaf for _, leaf in port_planner._walk(eng._exec_params)
                      if port_packing.is_packed(leaf)]
            assert stores and all(s.grid_x == 2 for s in stores)
        with port_common.activation_scaling("per-row"):
            reps.append(eng.run(trace, "continuous"))
    assert reps[0].request_tokens == reps[1].request_tokens
    assert reps[0].requests == len(trace)
