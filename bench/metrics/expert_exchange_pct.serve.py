"""expert_exchange_pct.serve: the device time of the operations launched
inside the port's ``moe.exchange`` spans (the ``all_reduce`` that adds the
ranks' expert outputs, ``models/moe.py:moe_serve``), as a share of the
device time of every operation launched inside a ``moe`` span (the expert
layer: routing, dispatch, the experts' sites, combine, exchange), over the
traced trace, prefill and decode, on the rank that reads the metrics.

Operations are placed by their host-side launch events, as in
``decode_launches.serve``; a collective's device time includes its wait
for the other ranks.  None where the port records no such spans.
"""

from bench import spantrace

spantrace.install()

PARTS = ("moe.exchange",)


def share(run, parts) -> float | None:
    """Device time launched in the spans ``parts`` over that launched in
    ``moe``, percent (shared with ``expert_route_pct.serve``)."""
    under = spantrace.launched_under(run, {"moe", *parts})
    if under is None:
        return None
    program = spantrace.program_of(run)
    part = whole = 0
    for (_, a, b), i in zip(run.trace.ops, under):
        if i >= 0:
            whole += b - a
            if program[i][0] in parts:
                part += b - a
    return 100.0 * part / whole if whole else None


def read(run):
    return share(run, PARTS)
