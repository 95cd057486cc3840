"""``python -m repro_torch.analysis`` — run every static pass; exit 1 on errors.

Default scope (the CI gate):

* **ranges** — every registered model config
  (``repro_torch.configs.ARCH_IDS``, the *full* published configs, run
  once on the ``meta`` device so no weight is ever materialized): GEMM-site
  discovery, the cross-check against the matrix products the forward
  dispatches (where the reference reads a jaxpr), and the
  accumulator-envelope sweep over the paper's designs x bit-widths,
  including per-shard K splits for representative grid geometries.
* **plan-lint** — every shipped plan document (``examples/plans/*.json``)
  plus any ``--plan`` paths.
* **source-lint** — the port's non-test python (``src/repro_torch`` and
  ``chip_smoke.py``).

Warnings are printed but only error-severity findings fail the gate (see
``repro_torch.analysis.findings``).  ``--json`` dumps the findings for
tooling, and beside them (under ``"ranges"``) each arch's coverage stats
and the wall seconds of its ranges pass.  Runs on the CPU: nothing here
touches a device but ``meta``.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

from repro_torch.analysis import findings as findings_lib
from repro_torch.analysis.findings import Finding


def _repo_root() -> pathlib.Path:
    # src/repro_torch/analysis/__main__.py -> repo root is three parents up
    # from the package directory; fall back to cwd when installed flat.
    candidate = pathlib.Path(__file__).resolve().parents[3]
    return candidate if (candidate / "src").is_dir() else pathlib.Path.cwd()


def _run_ranges(archs, grids) -> tuple[list[Finding], list[str], dict]:
    from repro_torch import configs
    from repro_torch.analysis import jaxpr_scan

    out: list[Finding] = []
    lines: list[str] = []
    per_arch: dict[str, dict] = {}
    for arch in archs:
        cfg = configs.get_config(arch)
        t0 = time.perf_counter()
        fs, stats = jaxpr_scan.check_model(cfg, arch=arch, grids=grids)
        per_arch[arch] = {**stats, "seconds": time.perf_counter() - t0}
        out.extend(fs)
        lines.append(
            f"  ranges: {arch}: {stats['sites']} sites, "
            f"{stats['dot_generals']} dot_generals, "
            f"{stats['points_checked']} envelope points")
    return out, lines, per_arch


def _run_plan_lint(paths) -> tuple[list[Finding], list[str]]:
    from repro_torch.analysis import plan_lint

    out: list[Finding] = []
    lines: list[str] = []
    for path in paths:
        fs = plan_lint.lint_plan_file(path)
        out.extend(fs)
        lines.append(f"  plan-lint: {path}")
    return out, lines


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="Static numeric-safety, plan-lint and source-lint "
                    "passes over the backend/plan/grid stack.")
    parser.add_argument("--arch", action="append", default=None,
                        help="restrict the ranges pass to this arch id "
                             "(repeatable; default: all registered)")
    parser.add_argument("--plan", action="append", default=None,
                        type=pathlib.Path,
                        help="additional plan JSON to lint (repeatable)")
    parser.add_argument("--grid", action="append", default=None,
                        help="grid geometry UXxUY for per-shard K splits "
                             "(repeatable; default: 1x1, 2x2, 4x1)")
    parser.add_argument("--root", type=pathlib.Path, default=None,
                        help="repo root (default: auto-detected)")
    parser.add_argument("--skip-ranges", action="store_true")
    parser.add_argument("--skip-plans", action="store_true")
    parser.add_argument("--skip-source", action="store_true")
    parser.add_argument("--json", type=pathlib.Path, default=None,
                        help="write findings as JSON to this path")
    args = parser.parse_args(argv)

    root = args.root or _repo_root()
    findings: list[Finding] = []
    narration: list[str] = []
    per_arch: dict[str, dict] = {}

    if not args.skip_ranges:
        from repro_torch import configs
        archs = args.arch or list(configs.ARCH_IDS)
        unknown = [a for a in archs if a not in configs.ARCH_IDS]
        if unknown:
            parser.error(f"unknown arch id(s): {unknown} "
                         f"(registered: {list(configs.ARCH_IDS)})")
        if args.grid:
            grids = []
            for g in args.grid:
                ux, _, uy = g.partition("x")
                grids.append((int(ux), int(uy)))
        else:
            grids = [(1, 1), (2, 2), (4, 1)]
        fs, lines, per_arch = _run_ranges(archs, grids)
        findings.extend(fs)
        narration.extend(lines)

    if not args.skip_plans:
        plans = sorted((root / "examples" / "plans").glob("*.json"))
        plans.extend(args.plan or [])
        fs, lines = _run_plan_lint(plans)
        findings.extend(fs)
        narration.extend(lines)

    if not args.skip_source:
        from repro_torch.analysis import source_lint
        findings.extend(source_lint.lint_repo(root))
        narration.append(f"  source-lint: {root}")

    for line in narration:
        print(line)
    for f in findings:
        print(f.render())
    print(findings_lib.verdict_line(findings))

    if args.json:
        args.json.write_text(json.dumps(
            {"findings": [f.to_json() for f in findings],
             "verdict": findings_lib.verdict_line(findings),
             "ranges": per_arch}, indent=2))
    return findings_lib.exit_code(findings)


if __name__ == "__main__":
    sys.exit(main())
