"""itl_p95_ms: the 95th percentile (numpy's linear interpolation) over every
token after a request's first, in the window, of the wall time since that
request's previous token reached the host."""

import numpy as np


def read(run):
    return float(np.percentile(run.window.itl(), 95)) * 1e3
