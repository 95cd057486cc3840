"""The :class:`BackendPlan`: a frozen per-site mixed-precision backend map.

A plan is the executable form of the paper's sweet-spot argument — not one
winning design but a *mapping* from GEMM sites to the (design, bit-width)
that wins there, driven by each site's measured weight bit sparsity (Eq. 1)
and guarded by its quantization error.  Plans are produced by
``repro_torch.eval.planner.build_plan`` and executed by
``repro_torch.backends.use_plan`` (which threads them into
``models/common.dense``); they serialize to a stable JSON format
(``schema: repro.backends.plan/v1``, documented in docs/PLANNER.md).

**Site-pattern matching rules** (``BackendPlan.assignment_for``):

1. Candidate entries are those whose ``pattern`` matches the site name with
   ``fnmatch`` semantics (``*`` matches any run of characters *including*
   ``/``; ``?`` one character; ``[seq]`` character sets).  Matching is
   case-sensitive.
2. Exact patterns (no wildcard characters) beat every glob.
3. Among globs, the pattern with the most literal (non-wildcard) characters
   wins — "most specific wins".
4. Remaining ties go to the earliest entry in the plan.
5. No match → no backend: ``use_plan`` leaves that site on the float path.

A plan's entries are value objects: loading a saved plan and re-saving it is
byte-stable, and two plans with equal entries compare equal.
"""

from __future__ import annotations

import dataclasses
import fnmatch
import json
import os
from typing import Mapping

from repro_torch.backends.base import GemmBackend

__all__ = ["SCHEMA", "SiteAssignment", "BackendPlan"]

SCHEMA = "repro.backends.plan/v1"

_WILDCARDS = set("*?[")


def _specificity(pattern: str) -> tuple[int, int]:
    """(exactness, literal-char count) — the match-precedence key."""
    exact = 1 if not (_WILDCARDS & set(pattern)) else 0
    literal = sum(1 for ch in pattern if ch not in "*?[]!")
    return (exact, literal)


@dataclasses.dataclass(frozen=True)
class SiteAssignment:
    """One plan entry: sites matching ``pattern`` run on ``design@bits``.

    Only ``pattern`` / ``design`` / ``bits`` are required (hand-written
    plans).  Planner-built entries also carry the evidence behind the
    choice, all for ONE decode step across the pattern's ``count``
    invocations:

    ``m``/``k``/``n_out``/``count`` — the contraction shape and how many
    identical GEMMs per step (scanned layers);
    ``word``/``bit_elem``/``bit_blockmax`` — measured weight sparsity at
    ``bits`` (``core.sparsity``; ``bit_blockmax`` is the Eq. 1 input);
    ``dyn_energy_uj``/``dyn_latency_us``/``wc_energy_uj``/``wc_latency_us``
    — predicted DLA cost (µJ / µs, Eq. 1-scaled dyn vs worst case);
    ``rel_mse`` — the accuracy guard's statistic: per-output-channel
    quantization MSE of the site's weight at ``bits``, relative to the
    weight's mean square (dimensionless; 0 = lossless; for stochastic
    entries it also folds in the measured stream-error variance);
    ``guard_relaxed`` — True when every candidate bit-width violated the
    guard and the planner fell back to the most accurate one;
    ``stream_len`` — rate-coded stream length for ``ugemm_stochastic``
    entries (0 = not a stream-coded entry, the count-exact default — old
    serialized plans load unchanged).
    """

    pattern: str
    design: str
    bits: int
    m: int = 0
    k: int = 0
    n_out: int = 0
    count: int = 1
    word: float = 0.0
    bit_elem: float = 0.0
    bit_blockmax: float = 0.0
    dyn_energy_uj: float = 0.0
    dyn_latency_us: float = 0.0
    wc_energy_uj: float = 0.0
    wc_latency_us: float = 0.0
    rel_mse: float = 0.0
    guard_relaxed: bool = False
    stream_len: int = 0

    def backend(self) -> GemmBackend:
        """Resolve the entry's engine as a typed ``GemmBackend``."""
        from repro_torch.backends.registry import resolve  # lazy: avoids
        # an import cycle through repro_torch.configs (see runtime.py)
        return resolve(self.design, bits=self.bits,
                       stream_len=self.stream_len or None)

    @property
    def engine_label(self) -> str:
        """``design@bits`` plus a ``:L`` stream suffix for stochastic
        entries — the display/matching tag of the *engine*, not just the
        design."""
        base = f"{self.design}@{self.bits}"
        return f"{base}:{self.stream_len}" if self.stream_len else base

    def matches(self, site: str) -> bool:
        return fnmatch.fnmatchcase(site, self.pattern)


@dataclasses.dataclass(frozen=True)
class BackendPlan:
    """An ordered, immutable set of :class:`SiteAssignment` entries.

    ``meta`` — free-form provenance (arch, DLA geometry, objective, guard
    threshold, predicted totals…) serialized verbatim; stored as a sorted
    tuple of ``(key, json-value)`` pairs so the dataclass stays frozen and
    comparable.  Use :meth:`metadata` for a dict view.
    """

    sites: tuple[SiteAssignment, ...]
    meta: tuple[tuple[str, object], ...] = ()

    def __post_init__(self) -> None:
        if not isinstance(self.sites, tuple):
            object.__setattr__(self, "sites", tuple(self.sites))
        if not isinstance(self.meta, tuple):
            object.__setattr__(self, "meta",
                               tuple(sorted(dict(self.meta).items())))

    # -- matching -----------------------------------------------------------

    def assignment_for(self, site: str) -> SiteAssignment | None:
        """Most specific matching entry for ``site`` (None = unplanned).

        Precedence per the module docstring: exact > most literal glob >
        earliest entry.
        """
        best: SiteAssignment | None = None
        best_key: tuple[int, int, int] | None = None
        for i, entry in enumerate(self.sites):
            if not entry.matches(site):
                continue
            key = (*_specificity(entry.pattern), -i)
            if best_key is None or key > best_key:
                best, best_key = entry, key
        return best

    def backend_for(self, site: str) -> GemmBackend | None:
        """Resolved backend for ``site``, or None (float path)."""
        entry = self.assignment_for(site)
        return None if entry is None else entry.backend()

    def distinct_backends(self) -> tuple[tuple[str, int], ...]:
        """Sorted unique (design, bits) pairs the plan assigns."""
        return tuple(sorted({(s.design, s.bits) for s in self.sites}))

    def distinct_engines(self) -> tuple[tuple[str, int, int], ...]:
        """Sorted unique (design, bits, stream_len) triples — the full
        engine identity (two stochastic entries with different stream
        lengths are different engines; stream_len is 0 for count-exact
        designs)."""
        return tuple(sorted({(s.design, s.bits, s.stream_len)
                             for s in self.sites}))

    def metadata(self) -> dict:
        return dict(self.meta)

    # -- (de)serialization --------------------------------------------------

    def to_json(self, indent: int = 2) -> str:
        """Stable JSON rendering (``schema: repro.backends.plan/v1``)."""
        doc = {
            "schema": SCHEMA,
            "meta": dict(self.meta),
            "sites": [dataclasses.asdict(s) for s in self.sites],
        }
        return json.dumps(doc, indent=indent)

    @classmethod
    def from_json(cls, text: str) -> "BackendPlan":
        """Parse :meth:`to_json` output; validates schema and entry fields."""
        doc = json.loads(text)
        if doc.get("schema") != SCHEMA:
            raise ValueError(
                f"not a backend plan: schema {doc.get('schema')!r} "
                f"(expected {SCHEMA!r})")
        fields = {f.name for f in dataclasses.fields(SiteAssignment)}
        sites = []
        for raw in doc.get("sites", []):
            unknown = set(raw) - fields
            if unknown:
                raise ValueError(f"unknown site fields {sorted(unknown)} "
                                 f"in entry {raw.get('pattern')!r}")
            for req in ("pattern", "design", "bits"):
                if req not in raw:
                    raise ValueError(f"site entry missing {req!r}: {raw}")
            sites.append(SiteAssignment(**raw))
        meta = doc.get("meta", {})
        if not isinstance(meta, Mapping):
            raise ValueError("plan meta must be a JSON object")
        return cls(sites=tuple(sites),
                   meta=tuple(sorted(meta.items())))

    def save(self, path: str | os.PathLike) -> str:
        """Write :meth:`to_json` to ``path`` (dirs created); returns path."""
        path = os.fspath(path)
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as fh:
            fh.write(self.to_json())
            fh.write("\n")
        return path

    @classmethod
    def load(cls, path: str | os.PathLike) -> "BackendPlan":
        """Read a plan saved by :meth:`save`."""
        with open(os.fspath(path)) as fh:
            return cls.from_json(fh.read())
