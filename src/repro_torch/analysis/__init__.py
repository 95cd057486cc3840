"""Static numeric-safety analysis: accumulator envelopes
(:mod:`repro_torch.analysis.ranges`), plan lint
(:mod:`repro_torch.analysis.plan_lint`) and their
:mod:`repro_torch.analysis.findings`.  The source lint, the model-graph
scan and the CLI arrive with the analysis slice.
"""

from repro_torch.analysis.findings import (  # noqa: F401  (re-export)
    ERROR, Finding)
