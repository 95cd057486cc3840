"""Serialize a :class:`~repro_torch.eval.sweetspot.SweetspotReport`.

Two renderings of the same report object:

* :func:`to_json` — machine-readable (every sweep point, winner, crossover
  and kernel cross-check row, plus the sweep axes) for downstream tooling.
* :func:`to_markdown` — human-readable: one winner table per metric
  (rows = bit-width, columns = matrix size, cell = winning design and its
  margin over the runner-up), the crossover frontier, grid fidelity vs the
  paper tables, and the kernel cycle cross-check.

:func:`write` emits both next to each other (``<stem>.json`` /
``<stem>.md``) in the directory its caller names.  The JSON document (its
schema tag included) is the same string the JAX package writes for the
same sweep.
"""

from __future__ import annotations

import dataclasses
import json
import os

from repro_torch.eval.sweetspot import METRICS, SweetspotReport

__all__ = ["to_json", "to_markdown", "write"]

_UNITS = {"area_um2": "um^2", "power_mw": "mW", "latency_ns": "ns",
          "energy_nj": "nJ", "adp_mm2_ns": "mm^2*ns"}


def to_json(report: SweetspotReport, indent: int = 2) -> str:
    """Render the full report as a JSON document (str)."""
    doc = dataclasses.asdict(report)
    # JSON objects need string keys; Winner.values already uses design names
    doc["schema"] = "repro.eval.sweetspot/v1"
    return json.dumps(doc, indent=indent, sort_keys=False)


def _winner_table(report: SweetspotReport, metric: str) -> list[str]:
    cells = {(w.bits, w.n): w for w in report.winners if w.metric == metric}
    head = "| bits \\ n | " + " | ".join(str(n) for n in report.sizes) + " |"
    sep = "|" + "---|" * (len(report.sizes) + 1)
    lines = [f"### {metric} [{_UNITS.get(metric, '')}]", "", head, sep]
    for bits in report.bits:
        row = [f"| **{bits}b** "]
        for n in report.sizes:
            w = cells[(bits, n)]
            star = "" if _on_grid(report, bits, n) else "~"
            row.append(f"| {star}{w.design} ({w.margin:.2f}x) ")
        lines.append("".join(row) + "|")
    lines.append("")
    return lines


def _on_grid(report: SweetspotReport, bits: int, n: int) -> bool:
    for p in report.points:
        if p.bits == bits and p.n == n:
            return p.on_grid
    return False


def to_markdown(report: SweetspotReport) -> str:
    """Render the report as markdown tables (str)."""
    lines = [
        "# Sweet-spot report",
        "",
        f"Designs: {', '.join(report.designs)} — bit-widths "
        f"{list(report.bits)}, sizes {list(report.sizes)}.",
        "Each cell names the winning (lowest) design and its margin over the",
        "runner-up; `~` marks off-grid points priced by the log-log fit",
        "(grid points are the paper's exact post-synthesis values).",
        "",
    ]
    for metric in METRICS:
        lines += _winner_table(report, metric)

    lines += ["## Crossover frontier", ""]
    if report.crossovers:
        lines.append("| metric | bits | winner below | n range | winner from |")
        lines.append("|---|---|---|---|---|")
        for c in report.crossovers:
            lines.append(f"| {c.metric} | {c.bits}b | {c.from_design} "
                         f"| {c.n_below} -> {c.n_at} | {c.to_design} |")
    else:
        lines.append("No winner changes along n on the swept grid.")
    lines.append("")

    lines += ["## Grid fidelity vs paper tables", ""]
    lines.append("| metric | max rel err on grid |")
    lines.append("|---|---|")
    for m, e in report.grid_fidelity.items():
        lines.append(f"| {m} | {e:.2%} |")
    lines.append("")

    if report.kernel_crosscheck:
        lines += ["## CUDA kernel cross-check", "",
                  "| design | bits | output == simulator | kernel cycles "
                  "| sim cycles | wc_cycles model | cycles agree |",
                  "|---|---|---|---|---|---|---|"]
        for r in report.kernel_crosscheck:
            lines.append(
                f"| {r['kernel']} | {r['bits']}b | {r['output_ok']} "
                f"| {r['kernel_cycles']} | {r['sim_cycles']} "
                f"| {r['wc_cycles']} | {r['cycles_ok']} |")
        lines.append("")
    return "\n".join(lines)


def write(report: SweetspotReport, out_dir: str | os.PathLike,
          stem: str = "sweetspot") -> tuple[str, str]:
    """Write ``<out_dir>/<stem>.json`` and ``.md`` (the directory created
    if needed); returns the two paths."""
    os.makedirs(out_dir, exist_ok=True)
    json_path = os.path.join(out_dir, stem + ".json")
    md_path = os.path.join(out_dir, stem + ".md")
    with open(json_path, "w") as f:
        f.write(to_json(report))
    with open(md_path, "w") as f:
        f.write(to_markdown(report))
    return json_path, md_path
