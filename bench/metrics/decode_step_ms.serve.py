"""decode_step_ms.serve: the mean host wall of the steps that decoded and
admitted nothing (``ServingEngine.run`` -> ``_decode``), from the harness's
stamps, over the traces that ran without the profiler: the engine's Python
loop over the layers, its launches, and the wait for the step's tokens."""

import numpy as np


def read(run):
    steps = run.untraced.decode_only_steps()
    return float(np.mean(steps)) * 1e3 if steps else None
