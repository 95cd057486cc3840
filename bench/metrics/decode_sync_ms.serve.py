"""decode_sync_ms.serve: the mean host wall of the port's
``engine.decode.sync`` span (the ``.cpu()`` of the step's tokens: the host
waiting for the device to finish the kernels it was issued) over the traced
trace's steps that decoded and ran no prefill: the device's backlog when the
host stops issuing.  It falls as the host issues slower than the device runs
and rises as the device becomes the bound.

Read from the program's own spans in the traced trace, which runs under
the profiler (the host 10-20 % slower).  None where the port records no
spans.
"""

from bench import spantrace

spantrace.install()


def read(run):
    return spantrace.decode_mean_ms(run, 2)
