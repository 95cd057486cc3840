"""PyTorch/CUDA port of the ``repro`` package (serve-traffic decode and
training slices).

Same sub-package and module names as ``repro`` so the counterpart of a
module is found by its path.  Imports ``torch`` only; the hand-written
Hopper kernels under ``csrc/`` are compiled with ``nvcc`` at first use
(``kernels/_build.py``), never at import time.
"""

__all__ = ["analysis", "backends", "checkpoint", "configs", "core", "data",
           "kernels", "launch", "models", "optim", "runtime", "serving"]
