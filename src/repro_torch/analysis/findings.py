"""Finding records shared by the three ``repro_torch.analysis`` passes.

A finding is one diagnostic emitted by a pass: the pass that produced it,
a stable rule identifier (what went wrong), a severity, a location (a GEMM
site, a plan entry, or a ``file:line``) and a human-readable message.

Severity semantics follow compiler convention:

* ``error`` — the property the pass proves is violated (an accumulator can
  overflow, a plan entry can never match, forbidden registry mutation).
  Any error makes the CLI exit non-zero; CI treats errors as gate failures.
* ``warning`` — advisory: legal but worth a look (a guard-relaxed plan
  entry, a weight GEMM the planner cannot see).  Warnings are printed but
  do not fail the gate.

This module is dependency-free on purpose: every pass (and the runtime
guards in ``repro_torch.backends``) can import it without pulling in JAX or the
backend stack.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Sequence

ERROR = "error"
WARNING = "warning"
_SEVERITIES = (ERROR, WARNING)


@dataclasses.dataclass(frozen=True)
class Finding:
    """One diagnostic from an analysis pass."""

    pass_name: str  # "ranges" | "plan-lint" | "source-lint"
    rule: str       # stable kebab-case rule id, e.g. "acc-overflow"
    severity: str   # ERROR or WARNING
    where: str      # site name, plan entry pattern, or file:line
    message: str

    def __post_init__(self) -> None:
        if self.severity not in _SEVERITIES:
            raise ValueError(f"severity must be one of {_SEVERITIES}, "
                             f"got {self.severity!r}")

    def render(self) -> str:
        return (f"[{self.pass_name}] {self.severity} {self.rule} "
                f"at {self.where}: {self.message}")

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


def errors(findings: Iterable[Finding]) -> list[Finding]:
    return [f for f in findings if f.severity == ERROR]


def warnings_(findings: Iterable[Finding]) -> list[Finding]:
    return [f for f in findings if f.severity == WARNING]


def exit_code(findings: Sequence[Finding]) -> int:
    """CLI/CI contract: non-zero iff any error-severity finding."""
    return 1 if errors(findings) else 0


def verdict_line(findings: Sequence[Finding]) -> str:
    """One-line summary, printed by serve and the benchmark reports."""
    n_err = len(errors(findings))
    n_warn = len(warnings_(findings))
    if not n_err and not n_warn:
        return "analysis: OK (0 findings)"
    return f"analysis: {n_err} error(s), {n_warn} warning(s)"
