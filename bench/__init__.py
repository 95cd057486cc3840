"""The benchmark of the PyTorch/CUDA port (``repro_torch``).

One command runs one cell once::

    python3 bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Everything a cell needs is found by name: ``bench/workloads/<cell>.json``
names its configuration (``bench/configs/<config>.json``) and its driver
kind; every per-layer metric of ``BENCHMARK.json`` is read by
``bench/metrics/<metric>.py``.  Nothing here imports JAX or the reference
package ``repro``; ``bench/reference.py`` imports nothing of the port.
"""
