"""decode_launches.serve: the mean count of device operations (kernels,
copies, sets) launched on the host inside the port's ``engine.decode`` span,
over the traced trace's steps that decoded and ran no prefill.

Each operation of the device trace names its host-side launch event by its
correlation id; the launch's time places it in the innermost program span
open then.  The step runs every slot, live or not, so the count depends on
the model's depth and the engine's code, not on the traffic.  None where
the port records no spans or the profiler recorded no launch events.
"""

import numpy as np

from bench import spantrace

spantrace.install()


def read(run):
    under = spantrace.launched_under(run, {"engine.decode"})
    if under is None:
        return None
    steps = spantrace.decode_only_steps(spantrace.program_of(run))
    if not steps:
        return None
    count: dict = {}
    for i in under:
        count[i] = count.get(i, 0) + 1
    return float(np.mean([count.get(d, 0) for _, d, _ in steps]))
