"""ttft_p90_ms: the 90th percentile (numpy's linear interpolation) over
every request of the window of the time from the start of the step at which
it arrived to the moment its first token is on the host."""

import numpy as np


def read(run):
    return float(np.percentile(run.window.ttft(), 90)) * 1e3
