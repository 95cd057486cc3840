"""Finding a cell, its configuration, its model family, its reference and
its metrics by name.

``BENCHMARK.json`` at the checkout's root lists the cells and metrics.  A
cell ``<cell>`` is ``bench/workloads/<cell>.json``, which names its
configuration ``bench/configs/<config>.json`` and its driver (``serve``:
``bench/serve.py``).  The configuration's ``family`` key names its family
module ``bench/families/<family>.py`` (absent: ``dense``) and its
``reference`` key the plain reference's file (a path from the checkout's
root).  A metric ``<metric>`` is read by ``bench/metrics/<metric>.py``,
whose ``read(run)`` returns its value or None where the run holds nothing
to read.  A name the manifest does not list, or whose file is missing, is
refused.
"""

from __future__ import annotations

import importlib.util
import json
import re
import sys
from pathlib import Path

__all__ = ["ManifestError", "load", "cell", "metrics_for", "reader", "family",
           "reference", "BENCH"]

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
                configuration=_read("configs", wl["config"], base),
                base=str(base))


def metrics_for(bench: dict, name: str, trace: bool) -> list:
    """The metric entries a run of cell ``name`` reports: the end-to-end
    ones untraced, the per-layer ones traced (those whose ``workloads``
    list holds the cell, or that have none)."""
    entries = bench["per_layer" if trace else "end_to_end"]
    return [m for m in entries if name in m.get("workloads", [name])]


def _load(kind: str, path: Path):
    """The module of the file ``path``, loaded once a process and file
    under a name of its own (``sys.modules``)."""
    tag = re.sub(r"\W", "_", str(path.resolve()))
    key = f"bench_{kind}_{tag}"
    mod = sys.modules.get(key)
    if mod is None:
        spec = importlib.util.spec_from_file_location(key, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[key] = mod
        try:
            spec.loader.exec_module(mod)
        except BaseException:
            del sys.modules[key]
            raise
    return mod


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


#: what a family module and a reference module must define
FAMILY_NAMES = ("sizes_of", "build", "token_ops", "head_ops", "gemm_calls")
REFERENCE_NAMES = ("SITES", "Reference", "prompt_tokens")


def _has(mod, names, path: Path, kind: str):
    missing = [n for n in names if not hasattr(mod, n)]
    if missing:
        raise ManifestError(f"{kind} file {path} defines no "
                            f"{', '.join(missing)}")
    return mod


def family(cell: dict):
    """The family module of a cell's configuration:
    ``bench/families/<family>.py`` (``family`` absent: ``dense``)."""
    base = Path(cell.get("base", BENCH))
    name = cell["configuration"].get("family", "dense")
    if not re.fullmatch(r"[A-Za-z0-9_]+", str(name)):
        raise ManifestError(f"family {name!r} is not a module name")
    path = base / "families" / f"{name}.py"
    if not path.is_file():
        raise ManifestError(f"no family file for {name!r} "
                            f"(bench/families/{name}.py)")
    return _has(_load("family", path), FAMILY_NAMES, path, "family")


def reference(cell: dict):
    """The plain reference module that a cell's configuration names under
    ``reference``, a path from the checkout's root inside ``bench/``."""
    base = Path(cell.get("base", BENCH))
    rel = cell["configuration"].get("reference")
    if not rel:
        raise ManifestError(f"configuration {cell['config']!r} names no "
                            f"reference file")
    path = (base.parent / rel).resolve()
    if base.resolve() not in path.parents or path.suffix != ".py" \
            or not path.is_file():
        raise ManifestError(f"no reference file {rel!r} inside bench/ (from "
                            f"configuration {cell['config']!r})")
    return _has(_load("reference", path), REFERENCE_NAMES, path, "reference")
