#!/usr/bin/env python3
"""Run one cell of the port's benchmark once; print its result line.

    python3 bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout: ``BENCHMARK.json`` there lists the cells,
``bench/`` holds the harness, ``src/`` the port it measures.  The last line
of standard output is one JSON object (``correct``, ``attempted``,
``failed``, ``metrics``, ``device``, with ``--trace 1`` ``breakdown``, and
last ``check``: each number the correctness check compared, beside its
limit, which the last lines of standard error repeat).  Exit codes: 0 a
result was printed; 2 the command or the manifest is wrong; 3 no CUDA card,
too few, or JAX or the reference package ``repro`` was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from bench import guard, manifest  # noqa: E402


def _refuse(code: int, message: str) -> int:
    print(f"bench/run.py: {message}", file=sys.stderr)
    return code


def _no_forbidden(where: str) -> None:
    found = guard.forbidden_loaded()
    if found:
        raise SystemExit(_refuse(3, f"{where}: {', '.join(found)} loaded "
                                    f"(the benchmark measures the port alone)"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _no_forbidden("at start")
    try:
        bench = manifest.load(ROOT)
        cell = manifest.cell(bench, args.workload)
        metrics = manifest.metrics_for(bench, args.workload, bool(args.trace))
        for m in metrics:
            manifest.reader(m["name"])
        if cell["driver"] != "serve":
            raise manifest.ManifestError(f"unknown driver {cell['driver']!r}")
        from bench import serve
        serve.sizes_of(cell["configuration"], serve.longest_positions(cell))
    except manifest.ManifestError as e:
        return _refuse(2, str(e))
    import torch
    marks = [("imports", time.perf_counter())]
    # the host's work is launching kernels: one process, one CPU thread
    torch.set_num_threads(1)
    if not torch.cuda.is_available():
        return _refuse(3, "torch.cuda.is_available() is False: the benchmark "
                          "runs on a CUDA card only")
    if torch.cuda.device_count() < cell["chips"]:
        return _refuse(3, f"{args.workload} needs {cell['chips']} cards, "
                          f"{torch.cuda.device_count()} visible")
    marks.append(("to find the cards", time.perf_counter()))
    out = serve.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                         t_start=T_START, metrics=metrics, marks=marks,
                         on_window_closed=lambda: _no_forbidden(
                             "after the window"))
    for name, c in out["check"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
