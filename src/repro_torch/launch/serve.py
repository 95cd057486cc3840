"""Serving driver on the PyTorch/CUDA port: prefill + decode with unary-DLA
energy accounting, per-site backend plans and seeded traffic.

Three modes, as in the reference:

* ``serve`` (default): greedy generation for a seeded prompt batch, the
  backend numerics spot-check, the per-design Eq.-1 cost table and the
  sweet-spot verdict; with ``--execute-backend`` (a simulated design, a
  ``*_cuda`` kernel mirror, or the rate-coded ``ugemm_stochastic[:L]``) or
  ``--backend-plan FILE`` prefill and decode also *execute* every dense
  site on its backend, and the driver reports the int GEMMs against their
  oracle (bit-exact for the exact designs; uGEMM's relative RMSE against
  the binary oracle, a stochastic backend's against exact uGEMM), the drift
  from the float model and the measured cycles against the priced bounds
  (per site under a plan).
  ``--packed`` executes from bit-packed weight stores.
* ``plan``: derive a per-layer mixed-precision plan
  (``repro_torch.eval.planner``; ``--stream-lens L1,L2`` adds rate-coded
  ``ugemm_stochastic`` candidates), save it to ``--plan-out``, and report
  predicted vs uniform-backend energy, measured per-site decode cycles and
  the plan lint's verdict.
* ``traffic``: a seeded Poisson trace through the paged
  continuous-batching :class:`repro_torch.serving.ServingEngine` under
  continuous and static batching, on the float path, a backend or a plan.
* **grid serving** (``--grid X,Y``): everything above on a tensor-parallel
  PE-array grid.  ``serve plan --grid X,Y`` derives a per-shard
  ``GridPlan`` (each shard profiles its own weight slice); execution shards
  every dense contraction (K over ``gx``, output columns over ``gy``),
  bit-identical to the single unit: run as one process, the shards run one
  after another on the one device; under ``torchrun --nproc-per-node X*Y``
  each rank is one unit on its own card (``launch.mesh``: partial sums
  all-reduced over ``gx``, column bands gathered over ``gy``), every rank
  serves the same seeded requests, and only rank 0 prints and writes
  files.  The world size must equal X*Y.  A grid plan loaded by
  ``--backend-plan`` brings its own grid; a flat plan with ``--grid`` is
  wrapped in one.

Runs on the card by default; ``--device cpu`` runs the same code on the
kernels' plain versions.

    PYTHONPATH=src python -m repro_torch.launch.serve plan --arch llama3-8b \\
        --smoke --device cpu --plan-out /tmp/plan.json
    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b \\
        --smoke --device cpu --backend-plan /tmp/plan.json --packed --tokens 8
    PYTHONPATH=src python -m repro_torch.launch.serve traffic --arch llama3-8b \\
        --execute-backend tubgemm_cuda --bits 4 --act-scale per-row
    PYTHONPATH=src python -m repro_torch.launch.serve traffic --arch llama3-8b \\
        --smoke --device cpu --execute-backend ugemm_stochastic:16 \\
        --act-scale per-row
    PYTHONPATH=src python -m repro_torch.launch.serve plan --arch llama3-8b \\
        --smoke --device cpu --grid 2,2 --plan-out /tmp/grid_plan.json
    PYTHONPATH=src python -m repro_torch.launch.serve traffic --arch llama3-8b \\
        --smoke --device cpu --backend-plan /tmp/grid_plan.json \\
        --act-scale per-row
    PYTHONPATH=src torchrun --standalone --nproc-per-node 4 \\
        -m repro_torch.launch.serve traffic --grid 2,2 \\
        --execute-backend tubgemm_cuda --act-scale per-row
"""

from __future__ import annotations

import argparse
import contextlib
import math
import os
import sys
import time

import numpy as np
import torch

from repro_torch import backends as backends_lib
from repro_torch import configs
from repro_torch.core import accounting, packing, ppa, sparsity
from repro_torch.core import gemm_sims as gemm_sims_lib
from repro_torch.core.quantization import quantize
from repro_torch.eval import planner as planner_lib
from repro_torch.eval import sweetspot as sweetspot_lib
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import common as common_lib
from repro_torch.models import model as model_lib
from repro_torch.serving import (FUSED_LOGIT_TOL, ServingEngine, TrafficConfig,
                                 fused_vs_gather_probe, generate_trace,
                                 paged_vs_contiguous_probe)
from repro_torch.serving import energy as serving_energy

def _float32(w: torch.Tensor) -> torch.Tensor:
    return w if w.dtype == torch.float32 else w.to(torch.float32)


def build_workload(cfg, params, batch: int, ctx_len: int, bits: int):
    """GemmCalls for ONE decode step, with measured per-matrix sparsity."""
    rec = accounting.GemmWorkloadRecorder()
    stats = {}
    for name, w in serving_energy.iter_weight_matrices(cfg, params):
        st = sparsity.profile_tensor(_float32(w), bits=bits)
        stats[name] = st
        k, n_out = w.shape
        rec.record(name, m=batch, k=k, n_out=n_out,
                   bit_sparsity=st.bit_blockmax, count=1)
    return rec, stats


def validate_backend_numerics(params, design, bits: int | None = None,
                              n_tiles: int = 8, tile: int = 16,
                              oracle: str = "bgemm") -> float:
    """Spot-check the selected GEMM backend on tiles of the real weights.

    Quantizes ``n_tiles`` (tile x tile) slices of actual model weights (the
    leaves in sorted-path order, as the reference flattens its tree),
    stacks them on a batch axis, and pushes the stack through
    ``GemmBackend.execute`` in one batched call against the ``oracle``
    design.  Exact designs (tu/tub/b and the CUDA mirrors) must come back
    bit-identical — returns 0.0 — while uGEMM reports its stochastic
    relative RMSE.  Rate-coded stochastic backends are judged with
    ``oracle="ugemm"``, the exact uGEMM value their bitstreams converge to,
    so the number isolates the stream-length error.
    """
    backend = backends_lib.resolve(design, bits=bits)
    oracle = backends_lib.resolve(oracle, bits=backend.bits)
    # Packed leaves dequantize for tiling — the spot-check wants float
    # matrices to quantize fresh at the backend's width.
    leaves = [leaf.dequantize() if packing.is_packed(leaf) else leaf
              for _, leaf in planner_lib._walk(params)]
    leaves = [leaf for leaf in leaves
              if leaf.ndim >= 2 and leaf.numel() >= 2 * tile * tile]
    if not leaves:
        return 0.0
    tiles = []
    for i in range(2 * n_tiles):
        flat = leaves[i % len(leaves)].reshape(-1)
        off = (i // len(leaves)) * tile * tile
        chunk = flat[off:off + tile * tile]
        if chunk.numel() < tile * tile:
            chunk = flat[:tile * tile]
        q = quantize(_float32(chunk).reshape(tile, tile), bits=backend.bits,
                     per_channel=False)
        tiles.append(q.values)
    a = torch.stack(tiles[:n_tiles])
    b = torch.stack(tiles[n_tiles:])
    return gemm_sims_lib.rel_rmse(backend.execute(a, b), oracle.execute(a, b))


def _oracle_for(backend) -> str:
    """The oracle design a backend's numerics are judged against.

    Rate-coded stochastic backends carry a ``stream_len`` and converge to
    the exact uGEMM value, so that is their reference; everything else is
    checked against the binary int32 oracle.
    """
    return "ugemm" if backend.stream_len else "bgemm"


def measure_decode_cycles(cfg, params, backend, *, batch: int, unit_n: int,
                          num_units: int, stats=None) -> dict[str, float]:
    """Per-decode-token cycle totals for the model on one backend.

    Sums the shared measured-cycles contract
    (``repro_torch.backends.measure_matrix_cycles``, the helper behind the
    planner's ``measure_site_cycles``) over every priced weight matrix:
    ``wc`` (worst case), ``dyn_floor`` (Eq. 1 with element-level
    sparsity), ``measured`` (operand-driven, on the per-channel codes
    ``dense`` contracts) and ``dyn`` (the priced Eq. 1 estimate).  For
    sparsity-aware designs ``dyn_floor <= measured <= wc``.

    ``stats`` — optional ``{name: SparsityStats}`` at ``backend.bits`` (from
    ``build_workload``) to skip re-profiling every weight matrix.
    """
    totals = {"wc": 0.0, "dyn": 0.0, "dyn_floor": 0.0, "measured": 0.0}
    for name, w in serving_energy.iter_weight_matrices(cfg, params):
        st = (stats or {}).get(name)
        cyc = backends_lib.measure_matrix_cycles(
            backend, w, rows=batch, unit_n=unit_n, num_units=num_units,
            bit_blockmax=None if st is None else st.bit_blockmax,
            bit_elem=None if st is None else st.bit_elem)
        for key in totals:
            totals[key] += cyc[key]
    return totals


@torch.no_grad()
def generate(cfg, params, prompt: torch.Tensor, max_new: int) -> torch.Tensor:
    """Greedy decoding: ``model.prefill`` then ``model.decode_step`` over a
    contiguous float32 cache.  Returns the ``(batch, max_new)`` tokens."""
    b, s = prompt.shape
    caches = model_lib.init_caches(cfg, b, s + max_new, dtype=torch.float32,
                                   device=prompt.device)
    logits, caches = model_lib.prefill(params, cfg, prompt, caches=caches)
    tok = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
    out = [tok]
    for i in range(max_new - 1):
        logits, caches = model_lib.decode_step(params, cfg, tok,
                                               caches=caches, cache_pos=s + i)
        tok = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
        out.append(tok)
    return torch.cat(out, dim=1)


@torch.no_grad()
def prefill_logits(cfg, params, prompt: torch.Tensor) -> torch.Tensor:
    """Full prefill logits under whatever backend/plan scope is active."""
    caches = model_lib.init_caches(cfg, prompt.shape[0], prompt.shape[1] + 1,
                                   dtype=torch.float32, device=prompt.device)
    logits, _ = model_lib.prefill(params, cfg, prompt, caches=caches)
    return logits


def _drift(exec_logits, ref_logits) -> tuple[float, float]:
    """(relRMSE, top-1 agreement) of executed vs float prefill logits."""
    agree = float(torch.mean((torch.argmax(exec_logits, -1)
                              == torch.argmax(ref_logits, -1)).to(torch.float64)))
    return gemm_sims_lib.rel_rmse(exec_logits, ref_logits), agree


def run_backend_execution(cfg, params, prompt, backend, max_new: int,
                          *, unit_n: int, num_units: int,
                          ref_logits=None, stats=None,
                          packed: bool = False) -> dict:
    """Execute prefill+decode on ``backend`` and collect the evidence.

    Returns a dict: generated ``tokens``, number of distinct GEMM ``sites``
    contracted on the backend, int-GEMM ``rel_rmse`` vs its ``oracle``,
    prefill-logits ``drift`` + ``top1_agreement`` vs the float model, wall
    time, and the measured/dyn/wc ``cycles`` totals per decode token.
    ``packed`` freezes every GEMM site's weight bit-packed at the backend's
    width (per K band under a grid backend) and executes from the packed
    store; the float ``params`` keep feeding the reference and measurement
    paths.
    """
    backend = backends_lib.resolve(backend)
    exec_params = (backends_lib.pack_weights(
        cfg, params, bits=backend.bits, grid=getattr(backend, "grid", None))
        if packed else params)
    if ref_logits is None:
        ref_logits = prefill_logits(cfg, params, prompt)
    t0 = time.perf_counter()
    with backends_lib.use_backend(backend) as execution:
        tokens = generate(cfg, exec_params, prompt, max_new)
        exec_logits = prefill_logits(cfg, exec_params, prompt)
    if tokens.is_cuda:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if not execution.calls:
        raise RuntimeError("backend execution recorded no GEMM sites")
    drift, agree = _drift(exec_logits, ref_logits)
    oracle = _oracle_for(backend)
    return {
        "backend": backend,
        "tokens": tokens,
        "sites": len({c.site for c in execution.calls}),
        "wall_s": wall,
        "oracle": oracle,
        "rel_rmse": validate_backend_numerics(params, backend, oracle=oracle),
        "drift": drift,
        "top1_agreement": agree,
        "cycles": measure_decode_cycles(cfg, params, backend,
                                        batch=prompt.shape[0], unit_n=unit_n,
                                        num_units=num_units, stats=stats),
    }


def run_plan_execution(cfg, params, prompt, plan, max_new: int,
                       *, ref_logits=None, packed: bool = False) -> dict:
    """Execute prefill+decode under ``use_plan`` and collect the evidence.

    Like :func:`run_backend_execution` but per site: every dense site
    contracts on the backend its plan entry names (unmatched sites stay
    float).  ``plan`` may be a ``BackendPlan`` or a ``GridPlan`` — a grid
    plan's aggregate entries execute sharded (``GridBackend``), the oracle
    comparison stays unsharded, and the measured cycles come back **per
    shard**.  Returns generated ``tokens``, the ``site_backends`` mapping
    actually executed, per-distinct-engine int-GEMM ``rel_rmse`` vs its
    oracle (binary, or exact uGEMM for a stream-coded entry), prefill
    ``drift`` / ``top1_agreement`` vs the float model, wall time, the
    ``grid`` shape (None unsharded), and per-site measured/dyn/floor/wc
    decode-cycle totals (``site_cycles``; for a grid ``{site: {"gx,gy":
    totals}}``; DLA geometry from the plan's meta).  ``packed`` executes
    the planned sites from bit-packed stores; reference logits, numerics,
    site discovery and cycles keep reading the float params.
    """
    grid = plan.grid if isinstance(plan, backends_lib.GridPlan) else None
    entry_plan = plan.aggregate if grid else plan
    exec_params = (backends_lib.pack_weights(cfg, params, plan)
                   if packed else params)
    if ref_logits is None:
        ref_logits = prefill_logits(cfg, params, prompt)
    t0 = time.perf_counter()
    with backends_lib.use_plan(plan) as execution:
        tokens = generate(cfg, exec_params, prompt, max_new)
        exec_logits = prefill_logits(cfg, exec_params, prompt)
    if tokens.is_cuda:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if not execution.calls:
        raise RuntimeError(
            "plan execution contracted no GEMM sites — do the plan's "
            "patterns match this model's site names?")
    site_backends = {
        c.site: f"{c.backend}@{c.bits}"
        + (f":{c.stream_len}" if c.stream_len else "")
        for c in execution.calls}
    rel_rmse = {}
    for design, bits, stream_len in entry_plan.distinct_engines():
        tag = f"{design}@{bits}" + (f":{stream_len}" if stream_len else "")
        if tag in site_backends.values():
            backend = backends_lib.resolve(design, bits=bits,
                                           stream_len=stream_len or None)
            if grid:
                backend = backends_lib.as_grid(backend, *grid)
            rel_rmse[tag] = validate_backend_numerics(
                params, backend, oracle=_oracle_for(backend))
    drift, agree = _drift(exec_logits, ref_logits)
    meta = entry_plan.metadata()
    unit_n = int(meta.get("unit_n", 64))
    num_units = int(meta.get("num_units", 64))
    sites = {s.name: s for s in planner_lib.discover_sites(
        cfg, params, batch=prompt.shape[0])}
    site_cycles = {}
    for entry in entry_plan.sites:
        site = sites.get(entry.pattern)
        if site is None or entry.pattern not in site_backends:
            continue
        if grid:
            site_cycles[entry.pattern] = planner_lib.measure_grid_site_cycles(
                site, entry, grid=grid, unit_n=unit_n, num_units=num_units)
        else:
            site_cycles[entry.pattern] = planner_lib.measure_site_cycles(
                site, entry, unit_n=unit_n, num_units=num_units)
    return {
        "tokens": tokens,
        "site_backends": site_backends,
        "wall_s": wall,
        "rel_rmse": rel_rmse,
        "drift": drift,
        "top1_agreement": agree,
        "grid": grid,
        "site_cycles": site_cycles,
    }


def _parse_stream_lens(spec: str | None) -> tuple[int, ...]:
    """``"16,32,64"`` -> ``(16, 32, 64)`` (empty/None -> no stochastic)."""
    if not spec:
        return ()
    try:
        lens = tuple(int(tok) for tok in spec.split(",") if tok.strip())
    except ValueError:
        raise SystemExit(f"error: --stream-lens must be a comma-separated "
                         f"list of ints, got {spec!r}")
    if any(L < 1 for L in lens):
        raise SystemExit(f"error: stream lengths must be >= 1, got {spec!r}")
    return lens


def run_plan_mode(args, cfg, params) -> int:
    """``serve plan``: derive, save and report a mixed-precision plan."""
    t0 = time.perf_counter()
    site_list = planner_lib.discover_sites(cfg, params, batch=args.batch)
    stream_lens = _parse_stream_lens(args.stream_lens)
    designs = planner_lib.DEFAULT_DESIGNS
    if stream_lens:
        designs = designs + (planner_lib.STOCHASTIC_DESIGN,)
    plan = planner_lib.build_plan(
        cfg, params, batch=args.batch, unit_n=args.unit_n,
        num_units=args.units, sites=site_list, designs=designs,
        stream_lens=stream_lens)
    wall = time.perf_counter() - t0
    path = plan.save(args.plan_out) if mesh_lib.rank() == 0 else args.plan_out
    meta = plan.metadata()
    totals = meta["totals"]
    sites = {s.name: s for s in site_list}

    print(f"\n=== backend plan for {args.arch} [{args.device}] "
          f"({args.units}x {args.unit_n}x{args.unit_n} units, objective "
          f"{meta['objective']}), planned in {wall:.2f} s ===")
    print(f"{'site':>24s} {'engine':>20s} {'b_spa':>6s} {'dynE_uJ':>9s} "
          f"{'relMSE':>7s} {'measured_cyc':>13s} {'wc_cyc':>10s}")
    for e in plan.sites:
        cyc = planner_lib.measure_site_cycles(
            sites[e.pattern], e, unit_n=args.unit_n, num_units=args.units)
        print(f"{e.pattern:>24s} {e.engine_label:>20s} "
              f"{e.bit_blockmax:6.3f} {e.dyn_energy_uj:9.4f} "
              f"{e.rel_mse:7.4f} {cyc['measured']:13.1f} {cyc['wc']:10.1f}")
    planned = totals["planned"]
    print(f"\nplanned dyn energy {planned['dyn_energy_uj']:.4f} uJ / decode "
          f"step (wc {planned['wc_energy_uj']:.4f} uJ)")
    for name in sorted(totals["uniform"]):
        tot = totals["uniform"][name]
        mark = " <-- best uniform" if name == totals["uniform_best"] else ""
        print(f"  uniform {name:>12s}: dyn {tot['dyn_energy_uj']:.4f} uJ"
              f"{mark}")
    best = totals["uniform_best"]
    if best is not None:
        saving = 1.0 - planned["dyn_energy_uj"] \
            / max(totals["uniform"][best]["dyn_energy_uj"], 1e-30)
        print(f"plan vs best uniform ({best}): {saving:.2%} predicted "
              f"energy saving")
    distinct = plan.distinct_engines()
    print(f"distinct engines chosen: "
          f"{', '.join(f'{d}@{b}' + (f':{L}' if L else '') for d, b, L in distinct)} "
          f"({'mixed' if len(distinct) > 1 else 'uniform'} assignment)")
    print(analysis_verdict(plan, site_names=[s.name for s in site_list]))
    print(f"plan saved to {path} (replay: serve --arch {args.arch}"
          f"{' --smoke' if args.smoke else ''} --device {args.device} "
          f"--backend-plan {path})")
    return 0


def analysis_verdict(plan, site_names=None) -> str:
    """One-line static numeric-safety verdict for a plan.

    Runs ``repro_torch.analysis.plan_lint`` over the plan (against the
    model's site inventory when given, so dead/shadowed patterns and
    unmatched sites are checked too), prints each finding and returns the
    verdict line.
    """
    from repro_torch.analysis import findings as findings_lib
    from repro_torch.analysis import plan_lint
    found = plan_lint.lint_plan(plan, site_names=site_names)
    for f in found:
        print(f"  {f.render()}")
    return findings_lib.verdict_line(found)


def run_grid_plan_mode(args, cfg, params, grid: tuple[int, int]) -> int:
    """``serve plan --grid X,Y``: derive, save and report a per-shard plan."""
    t0 = time.perf_counter()
    site_list = planner_lib.discover_sites(cfg, params, batch=args.batch)
    gplan = planner_lib.build_grid_plan(
        cfg, params, grid=grid, batch=args.batch, unit_n=args.unit_n,
        num_units=args.units, sites=site_list)
    wall = time.perf_counter() - t0
    path = gplan.save(args.plan_out) if mesh_lib.rank() == 0 else args.plan_out
    meta = gplan.metadata()
    totals = meta["totals"]
    agg = totals["aggregate"]
    sites = {s.name: s for s in site_list}

    print(f"\n=== grid backend plan for {args.arch} [{args.device}] "
          f"({grid[0]}x{grid[1]} grid of {args.units}x {args.unit_n}x"
          f"{args.unit_n} nodes, objective {meta['objective']}), planned in "
          f"{wall:.2f} s ===")
    print("aggregate (executed) assignment, with per-shard measured cycles:")
    for e in gplan.aggregate.sites:
        cyc = planner_lib.measure_grid_site_cycles(
            sites[e.pattern], e, grid=grid, unit_n=args.unit_n,
            num_units=args.units)
        shard_meas = ", ".join(f"{c}:{v['measured']:.0f}"
                               for c, v in sorted(cyc.items()))
        print(f"  {e.pattern:>24s} -> {e.design}@{e.bits} "
              f"(b_spa {e.bit_blockmax:.3f}, dynE {e.dyn_energy_uj:.4f} uJ; "
              f"measured cyc/shard {shard_meas})")
    print("\nper-shard verdicts (each shard plans its own weight slices):")
    for key, _plan in gplan.shards:
        v = totals["per_shard"][key]
        best = v["uniform_best"]
        best_e = v["uniform"][best]["dyn_energy_uj"] if best else 0.0
        print(f"  shard {key}: planned {v['planned']['dyn_energy_uj']:.4f} uJ"
              f" vs best uniform {best} {best_e:.4f} uJ")
    hetero = meta["heterogeneous_sites"]
    print(f"shard-heterogeneous sites: "
          f"{', '.join(hetero) if hetero else 'none'}")
    best = agg["uniform_best"]
    if best is not None:
        best_e = agg["uniform"][best]["dyn_energy_uj"]
        planned = agg["planned"]["dyn_energy_uj"]
        hetero_e = agg["planned_heterogeneous"]["dyn_energy_uj"]
        print(f"aggregate: executed plan {planned:.4f} uJ, per-shard "
              f"heterogeneous {hetero_e:.4f} uJ, best uniform ({best}) "
              f"{best_e:.4f} uJ -> {1.0 - hetero_e / max(best_e, 1e-30):.2%} "
              f"predicted saving")
    print(analysis_verdict(gplan, site_names=[s.name for s in site_list]))
    print(f"grid plan saved to {path} (replay: serve --arch {args.arch}"
          f"{' --smoke' if args.smoke else ''} --device {args.device} "
          f"--backend-plan {path})")
    return 0


def run_traffic_mode(args, cfg, params, plan=None, grid=None) -> int:
    """``serve traffic``: continuous vs static batching on one seeded trace.

    Serves the trace twice through the SAME engine (same paged pool geometry,
    same backend or plan scope, packed stores under ``--packed``) and
    reports throughput, latency percentiles, batch occupancy and Eq.-1
    energy per token for both.  Gates (non-zero exit) on:

    * continuous throughput >= static throughput on the same trace,
    * both schedulers completing every request; the per-request token
      streams must also be identical across schedulers — a strict gate on
      the float path and, under --execute-backend / --backend-plan, whenever
      ``--act-scale per-row`` is active (per-row activation quantization
      makes each request's integer codes a pure function of its own
      tokens); under the default per-tensor scale the check is
      informational,
    * under ``--decode-attention fused``: the continuous run replayed on the
      gather oracle samples identical token streams — a strict gate on the
      float path only.  Under quantized execution it is reported: the page
      walk re-associates the float32 softmax (<= ``FUSED_LOGIT_TOL`` on a
      logit), the next quantizer turns that into whole-code flips wherever
      an activation sits on a rounding tie, and the number of such ties
      grows with width x depth x steps (none seen at smoke size, a first
      flip in every few decode steps at llama3-8b's widths, each moving its
      row's logits by more than the argmax margin; ``chip_smoke.py`` counts
      them),
    * the paged decode step equal to the contiguous ``decode_step``
      reference at fp32, and the fused page walk within ``FUSED_LOGIT_TOL``
      of the gather oracle (both probes run the float path, so under
      ``--grid`` they are skipped, as in the reference).
    """
    tcfg = TrafficConfig(num_requests=args.requests,
                         arrival_rate=args.arrival_rate, seed=args.seed)
    trace = generate_trace(tcfg)
    engine_kw = dict(
        max_batch=args.batch, page_size=args.page_size,
        num_pages=args.num_pages, max_seq_len=args.max_seq_len,
        backend=args.execute_backend, plan=plan, bits=args.bits, grid=grid,
        unit_n=args.unit_n, num_units=args.units,
        pricing_design=args.gemm_backend, packed=args.packed,
        device=args.device)
    engine = ServingEngine(cfg, params, attention=args.decode_attention,
                           **engine_kw)
    scope = (f"plan {args.backend_plan}" if plan is not None
             else f"backend {args.execute_backend}@{args.bits}"
             if args.execute_backend else "float model")
    if grid is not None:
        scope += f" on a {grid[0]}x{grid[1]} grid"
    if args.packed:
        rep = accounting.packed_store_report(engine._exec_params)
        scope += " [packed]"
        print(f"packed weight store: {rep.packed_sites}/{rep.total_sites} "
              f"sites bit-packed, {rep.stored_bytes / 2**20:.2f} MiB vs "
              f"{rep.float32_bytes / 2**20:.2f} MiB fp32 "
              f"({rep.reduction:.2f}x smaller; packed sites alone "
              f"{rep.packed_reduction:.2f}x)")
    print(f"\n=== serving traffic on {args.arch} [{args.device}]: "
          f"{len(trace)} requests "
          f"(Poisson rate {args.arrival_rate}/step, seed {args.seed}), "
          f"{args.batch} slots, {engine.num_pages} pages x {args.page_size} "
          f"slots, {scope}, energy priced on {engine.energy.design} ===")
    with common_lib.activation_scaling(args.act_scale):
        reports = {name: engine.run(trace, name)
                   for name in ("continuous", "static")}
    print(f"{'scheduler':>12s} {'reqs':>5s} {'tokens':>7s} {'steps':>6s} "
          f"{'tok/step':>9s} {'p50':>6s} {'p99':>7s} {'queue':>6s} "
          f"{'occup':>6s} {'uJ/tok':>9s}")
    for name, r in reports.items():
        print(f"{name:>12s} {r.requests:5d} {r.tokens:7d} {r.steps:6d} "
              f"{r.throughput_tok_per_step:9.3f} {r.latency_p50:6.1f} "
              f"{r.latency_p99:7.1f} {r.queue_delay_mean:6.2f} "
              f"{r.occupancy:6.3f} {r.energy_per_token_uj:9.4f}")
    rc, rs = reports["continuous"], reports["static"]
    ok = True
    gain = rc.throughput_tok_per_step / max(rs.throughput_tok_per_step, 1e-30)
    beats = rc.throughput_tok_per_step >= rs.throughput_tok_per_step
    print(f"continuous vs static on the same trace: {gain:.2f}x throughput, "
          f"p99 latency {rc.latency_p99:.0f} vs {rs.latency_p99:.0f} steps")
    if not beats:
        print("WARNING: continuous batching did not beat static batching")
        ok = False
    complete = (rc.requests == len(trace) == rs.requests)
    same_tokens = rc.request_tokens == rs.request_tokens
    quantized = bool(args.execute_backend) or plan is not None
    strict = (not quantized) or args.act_scale == "per-row"
    note = ("" if not quantized else
            " (strict: per-row act-quant decouples co-batched rows)"
            if strict else
            " (informational: per-tensor act-quant couples co-batched rows)")
    print(f"all {len(trace)} requests completed under both schedulers: "
          f"{complete}; per-request token streams identical: "
          f"{same_tokens}{note}")
    ok = ok and complete and (same_tokens or not strict)
    if args.decode_attention == "fused":
        # replay the continuous run on the gather oracle: the fused page
        # walk may move logits by <= FUSED_LOGIT_TOL, but on the float path
        # the sampled token streams must be identical
        gather_engine = ServingEngine(cfg, params, attention="gather",
                                      weight_cache=engine.weight_cache,
                                      **engine_kw)
        with common_lib.activation_scaling(args.act_scale):
            rg = gather_engine.run(trace, "continuous")
        fused_same = rc.request_tokens == rg.request_tokens
        fnote = (" (informational: quantizer rounding ties amplify the "
                 "page walk's float32 re-association)" if quantized else "")
        print(f"fused vs gather decode token streams (continuous): "
              f"identical: {fused_same}{fnote}")
        ok = ok and (fused_same or quantized)
    if grid is None:
        diff = paged_vs_contiguous_probe(cfg, params,
                                         page_size=args.page_size)
        tag = "exact" if diff == 0.0 else f"max |diff| {diff:.3e}"
        print(f"paged decode vs contiguous decode_step (fp32): {tag}")
        ok = ok and diff == 0.0
        fdiff = fused_vs_gather_probe(cfg, params, page_size=args.page_size)
        print(f"fused page-walk vs gather oracle (fp32): max |dlogit| "
              f"{fdiff:.3e} (tol {FUSED_LOGIT_TOL:.0e})")
        ok = ok and fdiff <= FUSED_LOGIT_TOL
    return 0 if ok else 1


def _report_backend(args, cfg, params, prompt, costs, stats,
                    grid=None) -> bool:
    """``serve --execute-backend``: execute, print the evidence, gate."""
    backend = backends_lib.resolve(args.execute_backend, bits=args.bits)
    if grid is not None:
        backend = backends_lib.as_grid(backend, *grid)
    ltag = f", L={backend.stream_len} bitstreams" if backend.stream_len else ""
    gtag = ("" if not grid else
            f" on a {grid[0]}x{grid[1]} grid (one unit per rank: partial "
            f"sums all-reduced over gx, columns gathered over gy)"
            if mesh_lib.distributed() else
            f" on a {grid[0]}x{grid[1]} grid (shards in turn, partial sums "
            f"added over k)")
    print(f"\n=== executing model on {backend.name} "
          f"({backend.bits}-bit int tiles{ltag}){gtag} ===")
    result = run_backend_execution(
        cfg, params, prompt, backend, args.tokens, unit_n=args.unit_n,
        num_units=args.units, stats=stats, packed=args.packed)
    print(f"generated {tuple(result['tokens'].shape)} tokens in "
          f"{result['wall_s']:.2f}s; {result['sites']} dense GEMM sites "
          f"contracted on the backend")
    rel = result["rel_rmse"]
    tag = "bit-exact" if rel == 0.0 else f"relRMSE {rel:.2e}"
    kind = "exact design" if backend.exact else "stochastic design"
    oracle = ("exact-uGEMM oracle" if result["oracle"] == "ugemm"
              else "binary oracle")
    print(f"int GEMMs vs {oracle}: {tag} ({kind})")
    print(f"output drift vs float model (prefill logits): "
          f"relRMSE {result['drift']:.3f}, "
          f"top-1 agreement {result['top1_agreement']:.1%}")
    cyc = result["cycles"]
    in_bounds = cyc["dyn_floor"] - 0.5 <= cyc["measured"] <= cyc["wc"] + 0.5
    priced_dyn = costs[backend.pricing_design].dyn_latency_us * 1e3 \
        / ppa.CLOCK_PERIOD_NS * backend.cycle_scale
    stag = (f", measured stream relRMSE {rel:.2e} at L={backend.stream_len}"
            if backend.stream_len else "")
    print(f"per-decode-token cycles ({args.units}x {args.unit_n}x"
          f"{args.unit_n} units): measured {cyc['measured']:.3e} within "
          f"[dyn floor {cyc['dyn_floor']:.3e}, wc {cyc['wc']:.3e}]: "
          f"{in_bounds} (priced Eq.1 dyn {priced_dyn:.3e}{stag})")
    if not in_bounds:
        print("WARNING: measured cycles outside the priced dyn/wc bounds")
    # exact designs must be bit-exact; a stochastic estimate only finite
    numerics_ok = rel == 0.0 if backend.exact else math.isfinite(rel)
    return in_bounds and numerics_ok


def _report_plan(args, cfg, params, prompt, plan) -> bool:
    """``serve --backend-plan``: execute per site, print the evidence, gate."""
    is_grid = isinstance(plan, backends_lib.GridPlan)
    distinct = (plan.aggregate if is_grid else plan).distinct_engines()
    labels = ", ".join(f"{d}@{b}" + (f":{L}" if L else "")
                       for d, b, L in distinct)
    gtag = f" on a {plan.units_x}x{plan.units_y} grid" if is_grid else ""
    print(f"\n=== executing model on backend plan {args.backend_plan}"
          f"{gtag} ({labels}) ===")
    print(analysis_verdict(plan))
    result = run_plan_execution(cfg, params, prompt, plan, args.tokens,
                                packed=args.packed)
    print(f"generated {tuple(result['tokens'].shape)} tokens in "
          f"{result['wall_s']:.2f}s; {len(result['site_backends'])} dense "
          f"GEMM sites contracted:")
    for site, tag in sorted(result["site_backends"].items()):
        print(f"  {site:>24s} -> {tag}")
    ok = True
    for tag, rel in sorted(result["rel_rmse"].items()):
        label = "bit-exact" if rel == 0.0 else f"relRMSE {rel:.2e}"
        oracle = "exact-uGEMM oracle" if ":" in tag else "binary oracle"
        if is_grid:
            oracle = "unsharded " + oracle
        print(f"int GEMMs vs {oracle} on {tag}: {label}")
        exact = backends_lib.resolve(tag.split("@")[0]).exact
        ok = ok and (rel == 0.0 if exact else math.isfinite(rel))
    print(f"output drift vs float model (prefill logits): "
          f"relRMSE {result['drift']:.3f}, "
          f"top-1 agreement {result['top1_agreement']:.1%}")
    total = {"measured": 0.0, "dyn": 0.0, "dyn_floor": 0.0, "wc": 0.0}
    for site, cyc in sorted(result["site_cycles"].items()):
        shards = sorted(cyc.items()) if is_grid else [(None, cyc)]
        for coord, c in shards:
            label = f"{site} [{coord}]" if coord else site
            in_bounds = (c["dyn_floor"] - 0.5 <= c["measured"]
                         <= c["wc"] + 0.5)
            print(f"  {label:>30s} cycles: measured {c['measured']:.3e} in "
                  f"[floor {c['dyn_floor']:.3e}, wc {c['wc']:.3e}]: "
                  f"{in_bounds} (planned Eq.1 dyn {c['dyn']:.3e})")
            ok = ok and in_bounds
            for key in total:
                total[key] += c[key]
    scope = "per-shard " if is_grid else ""
    print(f"per-decode-token {scope}cycle totals: measured "
          f"{total['measured']:.3e} within [dyn floor "
          f"{total['dyn_floor']:.3e}, wc {total['wc']:.3e}] (planned Eq.1 "
          f"dyn {total['dyn']:.3e})")
    if not ok:
        print("WARNING: plan replay violated bit-exactness or cycle bounds")
    return ok


def run_serve_mode(args, cfg, params, plan=None, grid=None) -> int:
    """The one-shot ``serve`` mode: generate, price, recommend, execute."""
    rng = np.random.default_rng(0)
    prompt = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (args.batch, args.prompt_len)).astype(np.int32)
    ).to(args.device)
    t0 = time.perf_counter()
    toks = generate(cfg, params, prompt, args.tokens)
    if toks.is_cuda:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    print(f"generated {tuple(toks.shape)} tokens in {wall:.2f}s "
          f"({args.batch * args.tokens / wall:.1f} tok/s on {args.device}, "
          f"float path)")

    # --- backend numerics: batched engine vs binary oracle on real weights ---
    rel = validate_backend_numerics(params, args.gemm_backend, args.bits)
    tag = "bit-exact" if rel == 0.0 else f"relRMSE {rel:.2e}"
    print(f"backend numerics ({args.gemm_backend}, {args.bits}-bit, "
          f"batched weight tiles): {tag}")

    # --- unary-DLA energy accounting (the paper's technique, end to end) ---
    rec, stats = build_workload(cfg, params, args.batch, args.prompt_len,
                                args.bits)
    agg = sparsity.combine_stats(list(stats.values()))
    print(f"\nweight sparsity ({args.bits}-bit): word={agg.word:.4f} "
          f"bit_elem={agg.bit_elem:.4f} bit_blockmax={agg.bit_blockmax:.4f}")
    print(f"\nper-decode-token DLA cost ({args.units}x {args.unit_n}x"
          f"{args.unit_n} units, {args.bits}-bit):")
    print(f"{'design':>9s} {'wc_energy_uJ':>13s} {'dyn_energy_uJ':>14s} "
          f"{'dyn_latency_us':>15s} {'saving':>7s}")
    costs = {design: backends_lib.resolve(design, bits=args.bits)
             .price(rec.calls, unit_n=args.unit_n, num_units=args.units)
             for design in sweetspot_lib.CALIBRATED_DESIGNS}
    for design, cost in costs.items():
        mark = " <-- selected" if design == args.gemm_backend else ""
        print(f"{design:>9s} {cost.wc_energy_uj:13.2f} "
              f"{cost.dyn_energy_uj:14.2f} {cost.dyn_latency_us:15.2f} "
              f"{cost.sparsity_saving:6.1%}{mark}")

    # --- sweet-spot verdict for this model's actual layer shapes ------------
    rec_by = sweetspot_lib.recommend_backend(
        rec.calls, bits=args.bits, unit_n=args.unit_n, num_units=args.units,
        costs=costs)
    best_e = rec_by["dyn_energy_uj"]["best"]
    best_l = rec_by["dyn_latency_us"]["best"]
    print(f"\nsweet-spot ({args.bits}-bit, {args.unit_n}x{args.unit_n} units): "
          f"{best_e} minimizes energy, {best_l} minimizes latency "
          f"for this model's layer shapes")
    if args.gemm_backend not in (best_e, best_l):
        e_sel = dict(rec_by["dyn_energy_uj"]["ranking"])[args.gemm_backend]
        e_best = dict(rec_by["dyn_energy_uj"]["ranking"])[best_e]
        print(f"note: selected backend {args.gemm_backend} spends "
              f"{e_sel / e_best:.2f}x the energy of {best_e} here "
              f"(rerun with --gemm-backend {best_e})")

    ok = True
    if args.execute_backend:
        ok = _report_backend(args, cfg, params, prompt, costs, stats, grid)
    if plan is not None:
        ok = _report_plan(args, cfg, params, prompt, plan) and ok
    return 0 if ok else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="serve llama3-8b on the PyTorch/CUDA port: generate, "
                    "plan, or serve a seeded traffic trace")
    ap.add_argument("mode", nargs="?", default="serve",
                    choices=["serve", "plan", "traffic"],
                    help="'serve' generates tokens (default); 'plan' derives "
                         "+ saves a per-layer mixed-precision backend plan "
                         "and reports predicted vs uniform energy and "
                         "measured per-site decode cycles; 'traffic' serves "
                         "a seeded Poisson trace through the paged "
                         "continuous-batching engine and compares continuous "
                         "vs static batching")
    ap.add_argument("--arch", default="llama3-8b", choices=list(configs.ARCH_IDS))
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (default: cuda; 'cpu' "
                         "runs the kernels' plain versions)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16,
                    help="[serve] prompt length of the seeded batch")
    ap.add_argument("--tokens", type=int, default=32,
                    help="[serve] tokens to generate per prompt")
    ap.add_argument("--gemm-backend", default="tubgemm",
                    choices=["ugemm", "tugemm", "tubgemm", "bgemm"],
                    help="design the energy pricing charges")
    ap.add_argument("--execute-backend", default=None, metavar="SPEC",
                    help="EXECUTE prefill/decode with every quantized dense "
                         "layer contracted on this backend (simulated design, "
                         "*_cuda kernel mirror, or a rate-coded spec like "
                         "'ugemm_stochastic:64' where the suffix is the "
                         "stream length); one of "
                         f"{', '.join(backends_lib.available())}")
    ap.add_argument("--backend-plan", default=None, metavar="FILE",
                    help="execute prefill/decode with every dense site "
                         "contracted on the backend its plan entry names "
                         "(a JSON file from 'serve plan', of either package)")
    ap.add_argument("--plan-out", default="reports/plan.json",
                    help="[plan] where the derived plan is saved")
    ap.add_argument("--stream-lens", default=None, metavar="L1,L2,...",
                    help="[plan] admit rate-coded ugemm_stochastic "
                         "candidates at these stream lengths: the plan then "
                         "picks (design, bits, stream_len) per site")
    ap.add_argument("--act-scale", default="per-tensor",
                    choices=["per-tensor", "per-row"],
                    help="[traffic] activation quantization granularity "
                         "under backend execution; per-row decouples "
                         "co-batched requests and turns the identical-token-"
                         "stream check into a strict gate")
    ap.add_argument("--bits", type=int, default=4, choices=[2, 4, 8])
    ap.add_argument("--unit-n", type=int, default=128)
    ap.add_argument("--units", type=int, default=64)
    ap.add_argument("--requests", type=int, default=12,
                    help="[traffic] number of requests in the seeded trace")
    ap.add_argument("--arrival-rate", type=float, default=1.0,
                    help="[traffic] Poisson arrivals per scheduler step")
    ap.add_argument("--seed", type=int, default=0,
                    help="[traffic] trace seed (arrivals + lengths)")
    ap.add_argument("--page-size", type=int, default=8,
                    help="[traffic] KV-cache page size in token slots")
    ap.add_argument("--num-pages", type=int, default=None,
                    help="[traffic] KV pool size in pages (default: every "
                         "slot can hold a worst-case request, +1 trash page)")
    ap.add_argument("--max-seq-len", type=int, default=64,
                    help="[traffic] per-request position budget "
                         "(prompt + output)")
    ap.add_argument("--decode-attention", default="fused",
                    choices=["fused", "gather"],
                    help="[traffic] decode attention path: 'fused' walks "
                         "each block table page-by-page with online softmax "
                         "(the default), 'gather' materializes the padded "
                         "KV view (the exact oracle)")
    ap.add_argument("--packed", action="store_true",
                    help="freeze every planned site's weight bit-packed "
                         "(int32 words, 32/bits codes each) at its assigned "
                         "width and execute from the packed store; "
                         "bit-identical to quantize-then-execute; needs "
                         "--execute-backend or --backend-plan to fix the "
                         "widths")
    ap.add_argument("--grid", default=None, metavar="X,Y",
                    help="tensor-parallel PE-array grid: 'plan' derives a "
                         "per-shard heterogeneous GridPlan; execution modes "
                         "shard every dense contraction (K over X, output "
                         "columns over Y): under torchrun with X*Y ranks one "
                         "unit per rank, else the shards one after another "
                         "on the one device")
    args = ap.parse_args(argv)

    try:
        grid = backends_lib.parse_grid(args.grid) if args.grid else None
    except ValueError as exc:
        print(f"error: --grid {args.grid!r}: {exc}")
        return 2
    if args.packed and not (args.execute_backend or args.backend_plan):
        print("error: --packed needs --execute-backend or --backend-plan "
              "to fix each site's bit-width")
        return 2
    if args.execute_backend and args.backend_plan and args.mode != "plan":
        print("error: pass --execute-backend or --backend-plan, not both")
        return 2
    if args.execute_backend:
        try:
            backends_lib.resolve(args.execute_backend, bits=args.bits)
        except (KeyError, ValueError) as exc:
            print(f"error: --execute-backend {args.execute_backend!r}: {exc}")
            return 2
    plan = None
    if args.backend_plan and args.mode != "plan":
        # a GridPlan implies grid execution even without --grid
        plan = backends_lib.load_plan(args.backend_plan)
        if isinstance(plan, backends_lib.GridPlan):
            if grid is not None and grid != plan.grid:
                print(f"error: --grid {grid} conflicts with the grid plan's "
                      f"own grid {plan.grid}")
                return 2
            grid = plan.grid
        elif grid is not None:
            # shard a flat plan's sites across the requested grid
            plan = backends_lib.GridPlan(units_x=grid[0], units_y=grid[1],
                                         aggregate=plan, shards=())
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("error: --device cuda requested but no CUDA device is "
              "available (pass --device cpu to run on the CPU)")
        return 2
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if "RANK" not in os.environ or (world == 1 and grid is None):
        return _serve(args, plan, grid, device)
    # under torchrun: one grid unit per rank
    if grid is None or world != grid[0] * grid[1]:
        print(f"error: torchrun started {world} ranks; --grid X,Y with "
              f"X*Y == {world} is needed (got --grid {args.grid})")
        return 2
    device = mesh_lib.init_distributed(device.type)
    args.device = str(device)
    quiet = (open(os.devnull, "w") if mesh_lib.rank()
             else contextlib.nullcontext(sys.stdout))
    try:
        with quiet as out, contextlib.redirect_stdout(out):
            return _serve(args, plan, grid, device)
    finally:
        torch.distributed.destroy_process_group()


def _serve(args, plan, grid, device) -> int:
    """Run ``args.mode`` on ``device`` (a rank's own card under torchrun)."""
    cfg = (configs.get_smoke_config(args.arch) if args.smoke
           else configs.get_config(args.arch))
    # Serves with float32 activations whatever the config says.  At
    # bfloat16 the strict float-path fused==gather gate cannot hold: the
    # page walk (like the card's kernel) scores and normalises in float32,
    # while the gather oracle rounds q.k and the softmax weights to
    # bfloat16, enough to flip an argmax at random weights
    # (tests/test_torch_serving.py::test_bf16_fused_vs_gather_cause).
    cfg = cfg.replace(compute_dtype="float32")
    generator = torch.Generator(device=device)
    generator.manual_seed(0)
    params = model_lib.init_params(cfg, generator, device=device)
    if args.mode == "plan":
        if grid is not None:
            return run_grid_plan_mode(args, cfg, params, grid)
        return run_plan_mode(args, cfg, params)
    if args.mode == "traffic":
        return run_traffic_mode(args, cfg, params, plan, grid)
    return run_serve_mode(args, cfg, params, plan, grid)


if __name__ == "__main__":
    raise SystemExit(main())
