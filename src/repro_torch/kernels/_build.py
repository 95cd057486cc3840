"""Build and load the CUDA kernels of ``repro_torch/csrc`` at first use.

Every ``*.cu`` source is compiled by its own ``nvcc`` process, all started
together, with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xcompiler -fPIC -c

and the objects are linked into one shared library with a plain C interface
(no PyTorch headers, so a build takes seconds), loaded with ``ctypes``.  The
library lives in ``<repo>/build/`` under a name derived from the sources'
content, so an unchanged tree reuses it and an edited source rebuilds.  Nothing runs at import time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

__all__ = ["CSRC_DIR", "SOURCES", "HEADERS", "build_dir", "load_library",
           "last_build_seconds", "check_launch", "resident_blocks",
           "TILE_N", "TILE_K", "block_rows", "plan_splits"]

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
SOURCES = ("unary_gemm.cu", "fused_paged_decode.cu", "flash_attention.cu",
           "quant_gemm.cu", "packed_gemm.cu", "bitsparsity.cu")
#: headers the sources include (part of the build digest)
HEADERS = ("int_gemm.cuh", "mma_bf16.cuh", "mma_int8.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")

#: output-column and K tile of the GEMM kernels (csrc/unary_gemm.cu,
#: csrc/int_gemm.cuh)
TILE_N, TILE_K = 128, 64

_LOCK = threading.Lock()
_LIB: ctypes.CDLL | None = None
_BUILD_SECONDS: float | None = None


def build_dir() -> Path:
    return Path(__file__).resolve().parents[3] / "build"


def _find_nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and Path(cand).exists():
            return cand
    raise RuntimeError(
        "nvcc not found (looked on PATH and in /usr/local/cuda/bin): the "
        "CUDA kernels can only be built on a machine with the CUDA toolkit")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC_DIR / name).read_bytes())
    return h.hexdigest()[:16]


def _build(lib_path: Path, verbose: bool) -> None:
    nvcc = _find_nvcc()
    out_dir = lib_path.parent
    out_dir.mkdir(parents=True, exist_ok=True)
    tag = f"{lib_path.stem}.{os.getpid()}"
    extra = ("-Xptxas", "-v") if verbose else ()
    procs = []
    for name in SOURCES:
        obj = out_dir / f"{tag}.{Path(name).stem}.o"
        cmd = [nvcc, *NVCC_FLAGS, *extra, "-c", str(CSRC_DIR / name),
               "-o", str(obj)]
        procs.append((name, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    objs = []
    failures = []
    for name, obj, proc in procs:
        log, _ = proc.communicate()
        if verbose and log:
            print(f"[nvcc {name}]\n{log}", flush=True)
        if proc.returncode != 0:
            failures.append(f"nvcc failed on {name} (exit {proc.returncode}):\n{log}")
        objs.append(obj)
    if failures:
        raise RuntimeError("\n".join(failures))
    tmp = out_dir / f"{tag}.so"
    link = subprocess.run(
        [nvcc, "-shared", "-o", str(tmp), *map(str, objs)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed (exit {link.returncode}):\n"
                           f"{link.stdout}")
    os.replace(tmp, lib_path)   # atomic: concurrent builds agree
    for obj in objs:
        obj.unlink(missing_ok=True)


def _declare(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.unary_gemm_launch.argtypes = [i, p, p, p, i, i, i, i, i, p]
    lib.unary_gemm_launch.restype = i
    for name in ("unary_resident_blocks", "quant_gemm_resident_blocks",
                 "packed_gemm_resident_blocks"):
        fn = getattr(lib, name)
        fn.argtypes = [i, i, ctypes.POINTER(i)]
        fn.restype = i
    lib.fused_paged_decode_launch.argtypes = [p, p, p, p, p, p, p, p,
                                              i, i, i, i, i, i, i, i, i, i, i, i, i, p]
    lib.fused_paged_decode_launch.restype = i
    lib.fused_paged_decode_resident_blocks.argtypes = [i, i, i, i, i, ctypes.POINTER(i)]
    lib.fused_paged_decode_resident_blocks.restype = i
    ll, f = ctypes.c_longlong, ctypes.c_float
    lib.flash_fwd_launch.argtypes = [p, p, p, p, p, i, i, i, i, ll, ll, ll,
                                     f, i, i, p]
    lib.flash_fwd_launch.restype = i
    lib.flash_bwd_dq_launch.argtypes = [p, p, p, p, p, p, p, i, i, i, i,
                                        ll, ll, ll, ll, f, i, i, p]
    lib.flash_bwd_dq_launch.restype = i
    lib.flash_bwd_dkv_launch.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i,
                                         ll, ll, ll, ll, f, i, i, p]
    lib.flash_bwd_dkv_launch.restype = i
    for name in ("quant_gemm_launch", "packed_gemm_launch"):
        fn = getattr(lib, name)
        fn.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, i, p]
        fn.restype = i
    lib.block_stats_launch.argtypes = [p, p, p, p, p, i, i, i, p]
    lib.block_stats_launch.restype = i


def load_library(verbose: bool = False) -> ctypes.CDLL:
    """The kernels' shared library, built first if this tree has none."""
    global _LIB, _BUILD_SECONDS
    with _LOCK:
        if _LIB is not None:
            return _LIB
        lib_path = build_dir() / f"librepro_torch_kernels_{_digest()}.so"
        if not lib_path.exists():
            t0 = time.perf_counter()
            _build(lib_path, verbose)
            _BUILD_SECONDS = time.perf_counter() - t0
        lib = ctypes.CDLL(str(lib_path))
        _declare(lib)
        _LIB = lib
        return lib


def last_build_seconds() -> float | None:
    """Seconds the build took in this process (None if a cached library was
    loaded or nothing was loaded yet)."""
    return _BUILD_SECONDS


def check_launch(code: int, what: str) -> None:
    """Raise if a kernel's C entry point returned a CUDA error code."""
    if code != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error code "
                           f"{code} (cudaGetLastError)")


@functools.lru_cache(maxsize=None)
def resident_blocks(entry: str, device: int, *args: int) -> int:
    """Blocks of a kernel instance that one SM of CUDA device ``device``
    holds at once, as the CUDA occupancy calculator counts them (registers,
    shared memory, threads): the C entry ``entry(*args, &blocks)``.  Raises
    if the query fails or no block fits."""
    blocks = ctypes.c_int(0)
    with torch.cuda.device(device):
        code = getattr(load_library(), entry)(*args, ctypes.byref(blocks))
    check_launch(code, f"{entry}{args}")
    if blocks.value < 1:
        raise RuntimeError(f"{entry}{args}: no block fits on an SM")
    return blocks.value


def block_rows(m: int) -> int:
    """Rows one block of a GEMM kernel covers for ``m`` rows: its instance's
    tile (8/16/32/64), which the split-K ticket counters count too."""
    return 8 if m <= 8 else 16 if m <= 16 else 32 if m <= 32 else 64


def plan_splits(m: int, k: int, n: int, sm_count: int, resident: int) -> int:
    """How many ways a tensor-core GEMM kernel (``tub_gemm``, ``tu_gemm``,
    ``quant_gemm``, ``packed_gemm``) splits K.

    One block covers ``(block_rows(m), TILE_N)`` outputs and ``resident``
    of them fit an SM at once (the instance's registers and shared memory,
    :func:`resident_blocks`).  At decode the kernels stream the weights, so
    the plan takes the most K slices that still fit the grid in one wave
    of resident blocks (never more than there are K tiles).  1 means no
    split.
    """
    blocks = -(-m // block_rows(m)) * -(-n // TILE_N)
    k_tiles = max(1, -(-k // TILE_K))
    fit = resident * sm_count // max(blocks, 1)
    return max(1, min(fit, k_tiles))
