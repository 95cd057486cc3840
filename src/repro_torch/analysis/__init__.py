"""Static numeric-safety analysis (the part the backend guards need).

Only :mod:`repro_torch.analysis.ranges` (accumulator envelopes) and
:mod:`repro_torch.analysis.findings` are ported; the plan/source lint
passes arrive with the planner slice.
"""

from repro_torch.analysis.findings import (  # noqa: F401  (re-export)
    ERROR, Finding)
