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

A cell of one card runs in this process.  A cell of ``chips > 1`` runs as
one process of this file a card (``bench/ranks.py``), each started with the
ranks' own options ``--rank``, ``--world``, ``--init``, ``--device`` and
``--t0``; this process watches them and prints rank 0's result line,
``correct`` only where every rank's check passed, or exits non-zero
naming the rank that failed or lagged past the limit.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import signal  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from bench import guard, manifest, ranks  # noqa: E402


def _refuse(code: int, message: str) -> int:
    print(f"bench/run.py: {message}", file=sys.stderr)
    return code


def _no_forbidden(where: str) -> None:
    found = guard.forbidden_loaded()
    if found:
        raise SystemExit(_refuse(3, f"{where}: {', '.join(found)} loaded "
                                    f"(the benchmark measures the port alone)"))


def _phase(what: str) -> None:
    print(f"{ranks.PREFIX}{what}", file=sys.stderr, flush=True)


def _print_result(line: str) -> None:
    for name, c in json.loads(line)["check"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(line, flush=True)


def _rank(args, cell: dict, metrics: list, marks: list) -> int:
    """One rank of a cell of several cards (``bench/ranks.py``)."""
    import torch
    from bench import serve
    # set-up counts from the launcher's start
    t_start = time.perf_counter() - (time.time() - args.t0)
    _phase("process group")
    dev = ranks.join(args)
    lead = args.rank == 0
    out = serve.run_cell(
        cell, args.seed, args.seconds, bool(args.trace) and lead,
        t_start=t_start, metrics=metrics if lead else [], device=dev,
        rank=args.rank, world=args.world, phase=_phase,
        marks=marks + [("to the process group", time.perf_counter())],
        on_window_closed=lambda: _no_forbidden("after the window"))
    _phase("done")
    torch.distributed.destroy_process_group()
    print(json.dumps(out if lead else {
        "rank": args.rank, "correct": out["correct"],
        "memory_peak_bytes": out["device"]["memory_peak_bytes"],
        "check": out["check"]}), flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--device", default="cuda", help=argparse.SUPPRESS)
    ranks.add_options(ap)
    args = ap.parse_args(argv)
    _no_forbidden("at start")
    try:
        bench = manifest.load(ROOT)
        cell = manifest.cell(bench, args.workload)
    except manifest.ManifestError as e:
        return _refuse(2, str(e))
    if cell["chips"] > 1 and args.rank is None:
        return _launch(cell, sys.argv[1:] if argv is None else argv)
    try:
        metrics = manifest.metrics_for(bench, args.workload, bool(args.trace))
        for m in metrics:
            manifest.reader(m["name"])
        if cell["driver"] != "serve":
            raise manifest.ManifestError(f"unknown driver {cell['driver']!r}")
        from bench import serve
        manifest.family(cell).sizes_of(cell["configuration"],
                                       serve.longest_positions(cell))
        manifest.reference(cell)
    except manifest.ManifestError as e:
        return _refuse(2, str(e))
    import torch
    marks = [("imports", time.perf_counter())]
    # the host's work is launching kernels: one process, one CPU thread
    torch.set_num_threads(1)
    if args.rank is None or args.device == "cuda":
        if not torch.cuda.is_available():
            return _refuse(3, "torch.cuda.is_available() is False: the "
                              "benchmark runs on a CUDA card only")
        if torch.cuda.device_count() < cell["chips"]:
            return _refuse(3, f"{args.workload} needs {cell['chips']} cards, "
                              f"{torch.cuda.device_count()} visible")
    marks.append(("to find the cards", time.perf_counter()))
    if args.rank is not None:
        try:
            return _rank(args, cell, metrics, marks)
        except manifest.ManifestError as e:
            return _refuse(2, str(e))
    out = serve.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                         t_start=T_START, metrics=metrics, marks=marks,
                         on_window_closed=lambda: _no_forbidden(
                             "after the window"))
    _print_result(json.dumps(out))
    return 0


def _launch(cell: dict, argv: list) -> int:
    """Run a cell of several cards as one rank a card; this process loads
    neither torch nor the port, and each rank checks the manifest and the
    cards itself (its exit code and reason end the run)."""
    # a launcher stopped by a signal stops its ranks on the way out
    signal.signal(signal.SIGTERM, lambda *_: sys.exit(143))
    code, outputs, why = ranks.launch(
        Path(__file__).resolve(), argv, cell["chips"],
        limit_s=float(cell.get("limit_s", ranks.LIMIT_S)), t_start=T_START)
    if outputs is None:
        return _refuse(code, why)
    _no_forbidden("after the ranks")
    _print_result(ranks.result_line(outputs))
    return 0

if __name__ == "__main__":
    sys.exit(main())
