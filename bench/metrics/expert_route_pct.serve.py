"""expert_route_pct.serve: the device time of the operations launched inside
the port's ``moe.route`` (router matmul and sparsemixer), ``moe.dispatch``
(the rows each local expert takes) and ``moe.combine`` (weighting and
scatter-add) spans, as a share of the device time of every operation
launched inside a ``moe`` span, over the traced trace, on the rank that
reads the metrics (``expert_exchange_pct.serve`` reads the same way).
None where the port records no such spans.
"""

from bench import manifest

PARTS = ("moe.route", "moe.dispatch", "moe.combine")


def read(run):
    return manifest.reader("expert_exchange_pct.serve").share(run, PARTS)
