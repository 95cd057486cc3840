"""queue_wait_p90_ms.serve: the 90th percentile (numpy's linear
interpolation), over the traced trace's requests, of the port's
``engine.queue`` span: from the start of the step at which a request arrived
to the start of the prefill call that admits it, in wall time.

Read from the program's own spans in the traced trace, which runs under
the profiler (the host 10-20 % slower).  None where the port records no
spans.
"""

import numpy as np

from bench import spantrace

spantrace.install()


def read(run):
    program = spantrace.program_of(run)
    waits = [t1 - t0 for name, t0, t1, _, _ in program or ()
             if name == "engine.queue"]
    if not waits:
        return None
    return float(np.percentile(waits, 90)) * 1e-6
