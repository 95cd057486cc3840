"""device_idle_pct.serve: the share of the traced trace's wall time in which
no operation ran on the card (the union of the profiler's kernel, copy and
set intervals, against the window)."""


def read(run):
    tr = run.trace
    if tr is None or not tr.ops:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
