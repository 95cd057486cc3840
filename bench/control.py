#!/usr/bin/env python3
"""Readings that set a cell's correctness limits: the program's, the
control's and each planted fault's, over many seeds in one process.

    python3 bench/control.py --workload <cell> --seeds 1,2,3 \
        [--faults half_batch,...] [--out FILE]

For each seed: the cell's weights and engine, one trace of the cell's
traffic served (no warm-up, no timing), the sample the check compares
(``serve.sample_requests``), and ``check.judge``'s verdict and numbers
under the cell's limits, for

``program``  the program's served tokens and layer-0 products against the
  float32 reference (what a benchmark run compares);
``control``  the reference in TF32 put in the program's place
  (``judge(control="tf32")``): at every position of the same sequences the
  token TF32 puts first, and its layer-0 products;
``<fault>``  the trace served again with that fault of ``bench/faults.py``
  (or of the family module's ``FAULTS``) planted under the timed path,
  judged as a run is.

The benchmark's own runs never run this.  One JSON line a seed and fault,
and the same lines in ``--out``.  A cell of several cards runs one process
of this file a card (``bench/ranks.py``), within the workload's
``limit_s`` (else ``ranks.LIMIT_S``) for each seed and side served; each
rank judges its own window, and a line is rank 0's, ``correct`` only where
every rank's check passed, each number the worst any rank read.
"""

import argparse
import contextlib
import gc
import json
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from bench import check, faults, manifest, ranks, serve  # noqa: E402


def faults_of(cell: dict) -> dict:
    """The faults a cell can have planted: ``bench/faults.py``'s and its
    family module's ``FAULTS``."""
    return {**faults.FAULTS, **getattr(manifest.family(cell), "FAULTS", {})}


def _served(cell: dict, seed: int, device, plan, rank: int = 0,
            world: int = 1):
    """(sizes, weights, window, captured, chosen) of one trace served."""
    family = manifest.family(cell)
    sizes = family.sizes_of(cell["configuration"],
                            serve.longest_positions(cell))
    params, engine = family.build(cell, sizes, seed, device, rank=rank,
                                  world=world)
    probe = serve.make_probe(cell, engine, seed, plan)
    window = serve.serve_window(cell, probe, 1)
    captured = probe.captured
    serve.decode_step_of(window, captured)
    chosen = serve.sample_requests(window, captured, seed, plan.sample_tokens)
    engine.weight_cache.clear()
    del probe, engine
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return sizes, params, window, captured, chosen


def readings(cell: dict, seed: int, device, fault: str | None = None,
             plan=serve.PLAN, rank: int = 0, world: int = 1) -> list:
    """``{"seed", "side", "correct", "check", ...}`` of the program and the
    control (``fault`` None) or of the program under ``fault``, on rank
    ``rank`` of ``world``."""
    t0 = time.perf_counter()
    planted = (faults_of(cell)[fault]() if fault is not None
               else contextlib.nullcontext())
    with planted:
        sizes, params, window, captured, chosen = _served(
            cell, seed, device, plan, rank, world)
    served_s = time.perf_counter() - t0
    sides = [fault or "program"] + ([] if fault is not None else ["control"])
    out = []
    for side in sides:
        t1 = time.perf_counter()
        correct, numbers = check.judge(
            cell, sizes, params, window, captured, chosen, prompt_seed=seed,
            control="tf32" if side == "control" else None, rank=rank,
            world=world)
        out.append({"seed": seed, "side": side, "correct": correct,
                    "check": numbers, "requests": len(chosen),
                    "tokens": sum(len(window.traces[t].tokens[r])
                                  for t, r in chosen),
                    "served_s": served_s,
                    "judge_s": time.perf_counter() - t1})
    del params
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return out


def _emit(lines: list, out: str | None) -> None:
    print("\n".join(lines), flush=True)
    if out:
        Path(out).parent.mkdir(parents=True, exist_ok=True)
        with open(out, "a") as f:
            f.write("\n".join(lines) + "\n")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--faults", default="",
                    help=f"comma-separated, of {', '.join(faults.FAULTS)} "
                         f"and the family's")
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda")
    ranks.add_options(ap)
    args = ap.parse_args(argv)
    cell = manifest.cell(manifest.load(ROOT), args.workload)
    seeds = [int(s) for s in args.seeds.split(",")]
    planted = [None] + [f for f in args.faults.split(",") if f]
    if args.out and args.rank is None:
        Path(args.out).unlink(missing_ok=True)
    if cell["chips"] > 1 and args.rank is None:
        code, outputs, why = ranks.launch(
            Path(__file__).resolve(), sys.argv[1:] if argv is None else argv,
            cell["chips"], device=args.device,
            limit_s=float(cell.get("limit_s", ranks.LIMIT_S)) * len(seeds)
            * len(planted))
        if outputs is None:
            print(f"bench/control.py: {why}", file=sys.stderr)
            return code
        each = [[json.loads(ln) for ln in o.splitlines()
                 if ln.startswith("{")] for o in outputs]
        _emit([json.dumps(ranks.merged(list(group))) for group in zip(*each)],
              args.out)
        return 0
    rank = args.rank or 0
    torch.set_num_threads(1)
    device = (torch.device(args.device) if args.rank is None
              else ranks.join(args))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for seed in seeds:
        for fault in planted:
            _emit([json.dumps(r) for r in readings(
                cell, seed, device, fault, rank=rank, world=args.world)],
                args.out if args.rank is None else None)
    if args.rank is not None:
        torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
