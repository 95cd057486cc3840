"""Hand-written Hopper kernels (CUDA C++ under ``../csrc``) and their plain
PyTorch versions.

Each kernel module holds the ctypes wrapper (device / dtype / shape checks,
output allocation, launch on the current stream, a launch counter) next to
the plain version the CPU tests run.  Nothing here touches CUDA, ``nvcc`` or
``ctypes.CDLL`` at import time: the shared library is built at first launch
(:mod:`repro_torch.kernels._build`).
"""
