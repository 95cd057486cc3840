"""Finding a cell, its configuration and its metrics by name.

``BENCHMARK.json`` at the checkout's root lists the cells and metrics.  A
cell ``<cell>`` is ``bench/workloads/<cell>.json``, which names its
configuration ``bench/configs/<config>.json`` and its driver (``serve``:
``bench/serve.py``); a metric ``<metric>`` is read by
``bench/metrics/<metric>.py``, whose ``read(run)`` returns its value or
None where the run holds nothing to read.  A name the manifest does not
list, or whose file is missing, is refused.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

__all__ = ["ManifestError", "load", "cell", "metrics_for", "reader", "BENCH"]

BENCH = Path(__file__).resolve().parent


class ManifestError(ValueError):
    """A cell, configuration or metric the benchmark cannot find."""


def load(root: Path) -> dict:
    path = Path(root) / "BENCHMARK.json"
    if not path.is_file():
        raise ManifestError(f"no BENCHMARK.json at {root}")
    return json.loads(path.read_text())


def _read(kind: str, name: str, base: Path) -> dict:
    path = Path(base) / kind / f"{name}.json"
    if not path.is_file():
        raise ManifestError(f"no {kind} file for {name!r} ({path.name})")
    return json.loads(path.read_text())


def cell(bench: dict, name: str, base: Path = BENCH) -> dict:
    """The cell ``name``: its workload file, with ``name``, ``chips`` and the
    configuration file (under ``"configuration"``) filled in."""
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        known = ", ".join(w["name"] for w in bench["workloads"])
        raise ManifestError(f"unknown workload {name!r} (known: {known})")
    wl = _read("workloads", name, base)
    if wl["config"] != entry["config"]:
        raise ManifestError(f"workload {name!r} names config {wl['config']!r}, "
                            f"BENCHMARK.json {entry['config']!r}")
    if not any(c["name"] == wl["config"] for c in bench["configs"]):
        raise ManifestError(f"unknown config {wl['config']!r}")
    return dict(wl, name=name, chips=int(entry["chips"]),
                configuration=_read("configs", wl["config"], base))


def metrics_for(bench: dict, name: str, trace: bool) -> list:
    """The metric entries a run of cell ``name`` reports: the end-to-end
    ones untraced, the per-layer ones traced (those whose ``workloads``
    list holds the cell, or that have none)."""
    entries = bench["per_layer" if trace else "end_to_end"]
    return [m for m in entries if name in m.get("workloads", [name])]


def reader(name: str, base: Path = BENCH):
    """The module of ``bench/metrics/<name>.py``."""
    path = Path(base) / "metrics" / f"{name}.py"
    if not path.is_file():
        raise ManifestError(f"no reader for metric {name!r} ({path.name})")
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    if not callable(getattr(mod, "read", None)):
        raise ManifestError(f"metric file {path.name} has no read(run)")
    return mod
