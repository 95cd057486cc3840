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
  planted under the timed path, judged as a run is.

The benchmark's own runs never run this.  One JSON line a seed and fault,
and the same lines in ``--out``.
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

from bench import check, faults, manifest, serve  # noqa: E402


def _served(cell: dict, seed: int, device, plan):
    """(sizes, weights, window, captured, chosen) of one trace served."""
    sizes = serve.sizes_of(cell["configuration"], serve.longest_positions(cell))
    params, engine = serve.build(cell, sizes, seed, device)
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
             plan=serve.PLAN) -> list:
    """``{"seed", "side", "correct", "check", ...}`` of the program and the
    control (``fault`` None) or of the program under ``fault``."""
    t0 = time.perf_counter()
    planted = (faults.FAULTS[fault]() if fault is not None
               else contextlib.nullcontext())
    with planted:
        sizes, params, window, captured, chosen = _served(cell, seed, device,
                                                          plan)
    served_s = time.perf_counter() - t0
    sides = [fault or "program"] + ([] if fault is not None else ["control"])
    out = []
    for side in sides:
        t1 = time.perf_counter()
        correct, numbers = check.judge(
            cell, sizes, params, window, captured, chosen, prompt_seed=seed,
            control="tf32" if side == "control" else None)
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--faults", default="",
                    help=f"comma-separated, of {', '.join(faults.FAULTS)}")
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cell = manifest.cell(manifest.load(ROOT), args.workload)
    device = torch.device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    planted = [None] + [f for f in args.faults.split(",") if f]
    lines = []
    for seed in (int(s) for s in args.seeds.split(",")):
        for fault in planted:
            for r in readings(cell, seed, device, fault):
                line = json.dumps(r)
                print(line, flush=True)
                lines.append(line)
        if args.out:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            Path(args.out).write_text("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
