"""decode_issue_ms.serve: the mean host wall of the port's ``engine.decode``
span (``serving/engine.py:ServingEngine.run``: the call of ``_decode`` until
the step's argmax is enqueued, the host issuing the step's kernels) over the
traced trace's steps that decoded and ran no prefill.

Read from the program's own spans (``repro_torch.runtime.spans``), which
record in the traced trace only: that trace runs under the profiler, which
slows the host by 10-20 %.  None where the port records no spans.
"""

from bench import spantrace

spantrace.install()


def read(run):
    return spantrace.decode_mean_ms(run, 1)
