"""The benchmark of the PyTorch/CUDA port (``repro_torch``).

One command runs one cell once::

    python3 bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Everything a cell needs is found by name: ``bench/workloads/<cell>.json``
names its configuration (``bench/configs/<config>.json``) and its driver
kind; the configuration names its model family (``bench/families/
<family>.py``, absent: ``dense``) and its plain reference (a file under
``bench/``); every per-layer metric of ``BENCHMARK.json`` is read by
``bench/metrics/<metric>.py``.  A cell of several cards runs one process a
card (``bench/ranks.py``).  Nothing here imports JAX or the reference
package ``repro``; a reference file imports nothing of the port.
"""
