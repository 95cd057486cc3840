#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py            # everything, llama3-8b widths

Phases, each of which fails the run (non-zero exit) on its own:

1. ``device``  — card name and power limit, build of the CUDA kernels, and
   from ``cuobjdump`` of the built library the tensor-core instructions,
   registers and local memory of each tensor-core kernel (the bf16 flash
   kernels' HMMA; the IMMA of tuGEMM's, tubGEMM's, quant_gemm's and
   packed_gemm's int8 kernels; none may lack them, none may spill);
2. ``kernels`` — every kernel against its plain PyTorch version (and the
   integer-GEMM / gather oracles) on the card, at the main path's shapes
   (fused decode also at forced split counts and head dims 96, 256, 512;
   flash also at head dims 96 and 256; block_stats at every tile 1..128, on
   int8 codes with -128, on zeros and past 65,535 tile rows, with its two
   fused sums);
3. ``probes``  — paged-vs-contiguous == 0.0 and fused-vs-gather <=
   FUSED_LOGIT_TOL on the smoke config at fp32, on the card;
4. ``serve``   — ``ServingEngine`` at llama3-8b's published widths serving a
   seeded trace under ``tubgemm_cuda`` + fused decode, gated on completion
   and on the kernels' launch counters; a short ``tugemm_cuda`` run whose
   integer site outputs must equal ``tubgemm_cuda``'s on the same requests
   (both walls printed); fused and gather
   decode must sample identical token streams on the float path; under
   4-bit execution that comparison is reported, and one teacher-forced
   step through both engines counts the activation codes that flip;
5. ``quant``   — the quantized-kernel inference path on the same weights:
   ``ServingEngine`` over ``cfg.quant_kernel`` at 4 bits (no backend scope)
   serving the same trace, gated on completion and on ``quant_gemm``'s
   launch counter, after a card-vs-CPU probe on the smoke config; the 224
   site weights packed into word stores (``pack_quantized``) and contracted
   with ``packed_matmul``, equal to the materialising reference; and
   ``ops.bit_sparsity_stats`` over every site weight within 1e-6 of
   ``profile_tensor``;
6. ``plan``    — per-site plans and packed serving on the same weights:
   ``build_plan`` over the served model (batch 8, designs tu/tub/bGEMM at
   2/4/8 bits, 64 units of 128 x 128), gated on a clean lint, planned
   energy at most the best uniform plan's, a JSON round trip and measured
   cycles within [floor, wc] at every site; the plan rewritten to the
   ``*_cuda`` mirrors, saved and loaded back; the trace served under it
   from float weights and from bit-packed stores (``packed=True``), gated
   on completion, identical token streams and the launch counters
   (``tub_gemm`` launched); every site's int32 output over a teacher-forced
   prefill and two decode steps equal, packed vs unpacked and simulated
   plan vs kernel plan; one traced decode step of the packed run;
7. ``ugemm``   — uGEMM and the rate-coded family on the same weights:
   ``ugemm_exact`` / ``ugemm_stream`` at 2, 4 and 8 bits and
   ``stochastic_gemm`` (Sobol L = 16, 64; LFSR L = 16) at a decode site's
   shape and a prefill shape, card equal to CPU bit for bit, each
   stochastic result's rel-RMSE against ``ugemm_exact`` under the tail of
   ``ranges.stochastic_error_bound``; the first three requests of the trace
   served under ``ugemm``@4 and ``ugemm_stochastic:16``@4 (per-row, fused
   decode), gated on completion, the fused decode launch counter, the
   backend numerics against their oracles and every site's output at one
   decode step equal to a direct call on the same codes (and, for layer
   0's q/k/v, to the CPU's), each run with one traced decode step; and
   ``build_plan`` with ``ugemm_stochastic`` candidates (bits 4 and 8,
   stream lengths 16, 32, 64), gated on a clean lint, planned energy at
   most the best uniform plan's and a JSON round trip that keeps every
   stream length;
8. ``train``   — the training path (``launch/train.py``): a card-vs-CPU
   probe of one step on the smoke config in fp32, then 10 steps of
   llama3-8b at its published widths cut to 8 layers (fp32 parameters,
   bf16 compute, remat, batch 4 x 2048), gated on finite, falling loss and
   on the flash kernels' launch counters; one more step traced;
9. ``times``   — per-kernel CUDA-event timings beside the plain version, the
   roofline bound and, where one exists, the library call (flash: TFLOP/s,
   and SDPA's backward alone beside its forward + backward, at head dims
   128, 96 and 256; fused decode also unsplit and at the serve step's
   geometry, on its log lines; block_stats at every tile and with an L2 the
   flush left clean);
10. ``grid``   — PE-array grids and the sweet-spot report on the same
   weights: ``as_grid(b, 2, 2).execute`` equal bit for bit to the single
   unit and to the plain integer product for ``tubgemm_cuda`` and
   ``tugemm_cuda`` at 2, 4 and 8 bits at a decode step's shape of every
   distinct dense site and at a prefill shape (so at every shard shape the
   served trace gives the kernels), and ``ugemm`` at 4 bits at a decode
   and a prefill shape, with the per-shard launches and times;
   ``build_grid_plan`` over the served model (2 x 2 grid, batch 8,
   tu/tub/bGEMM at 2/4/8 bits, 64 units of 128 x 128), gated on a clean
   lint, planned energy at most the best uniform plan's and measured
   cycles within [floor, wc] on every shard; the trace served under the
   grid plan and under its aggregate flat plan (kernel mirrors, per-row,
   fused decode), gated on completion, identical token streams and each
   unary kernel launched four times as often on the grid, then every
   site's int32 output over a teacher-forced prefill and two decode steps
   equal bit for bit between the two plans, with one traced grid decode
   step; and ``build_report()`` with its ``kernel_crosscheck``
   on the card, every row equal to the simulator in output and cycles,
   written to a temporary directory.  The phase runs after ``ugemm`` on the
   served model; its launches are printed, not put on the kernels line.
11. ``families`` — the attention-transformer families: each of the seven
   architectures beside llama3-8b at narrow widths that keep its head dims
   (MLA: q/k 192, V 128), card (kernels) against CPU (plain versions):
   forward, prefill and three decode steps within 1e-4, greedy tokens
   equal, and for MoE the routing indices, loss and gradients; then at
   published widths, cut in depth only: phi3.5-moe (4 layers) through the
   one-shot serve mode's functions under ``tubgemm_cuda``@4 per-row, with
   every site, ``lm_head`` included, launching ``tub_gemm`` once a call,
   prefill against forward (same T) and decode against forward with the
   expert capacity lifted to T within 1e-3 at fp32, a traced decode step
   beside one layer's expert loop, and 3 train steps at 2 layers (bf16,
   remat; losses finite, every parameter moved, the three flash kernels
   launched); deepseek-v3 (1 layer: 256 experts, MLA) forward (flash at
   D = 192) and prefill + three absorbed decode steps within 1e-3 at fp32,
   then under ``tubgemm_cuda`` (``w_uk`` / ``w_uv`` sites of the forward
   only); gemma-7b, phi3-mini, internlm2 and chameleon (2 layers) serving
   three requests through ``ServingEngine`` under ``tubgemm_cuda`` with
   fused decode, fused == gather on the float path; musicgen's forward
   from embeddings.  Every (M, K, N, bits) at which these paths call
   ``tub_gemm`` is collected, and after them the kernel is held at each
   (and at 8 bits at each (K, N)'s smallest and largest M) equal to its
   plain slot loop and to the integer product.  It runs after the served
   model is freed; its launches are printed per path and run (zeroed just
   before each, read just after) and put on the kernels line as
   ``launches_families``.
12. ``recurrent`` — the recurrent families: zamba2-1.2b (Mamba2 + the shared
   attention block), rwkv6-3b and a pure Mamba2 stack at narrow widths
   that keep the SSD state / head / chunk (64), the RWKV head (64) and
   zamba2's attention head dim (64), card against CPU: forward, prefill
   and three decode steps within 1e-4, greedy tokens equal, every cache
   leaf (state, conv tails, token-shift buffers, shared KV), the loss and
   every gradient within 1e-4 of max(1, max|CPU|); then zamba2-1.2b (38
   layers) and rwkv6-3b (32 layers) at their published widths and depth,
   fp32, batch 4, prompt 100 (the padding path of both chunk sizes):
   forward at T against prefill of T - 3 and three decode steps within
   ``RECURRENT_TOL``, greedy tokens equal, then the one-shot serve mode's
   functions under ``tubgemm_cuda``@4 per-row for 16 new tokens, every
   dense site launching ``tub_gemm`` once a pass, a traced decode step
   beside one layer's block; then 3 train steps of zamba2 and of rwkv6
   at full depth (bf16, remat, 2 x 1024; losses, gradient norms and
   parameters finite, every parameter moved, flash at D = 64 forward and
   backward once per shared-block application), and rwkv6's gradients at
   init on the trainer's second batch in bf16 and fp32 compute (norms and
   largest leaves, logged); then ``tub_gemm`` at every (M, K, N, bits)
   those paths gave it, equal to its plain slot loop, and the flash kernels
   at every (BH, Sq, Skv, D) they gave flash, in fp32 and bf16, causal and
   not, against their plain versions.  Its launches are put on the kernels
   line as ``launches_recurrent``.
13. ``analysis`` — the port's static gate (``python -m repro_torch.analysis``)
   in process at its default scope: the ten published configs at full
   depth on ``meta``, grids 1x1/2x2/4x1, the shipped plans and the source
   lint; gated on exit 0, the reference's GEMM site count for every arch
   and its eight warnings (as (rule, where), written here as
   ``REFERENCE_WARNINGS``); each arch's wall time logged.
14. ``pipeline`` — ``launch/pipeline.py`` on the card: llama3-8b at full
   width, 8 layers in 4 stages of 2 (the transformer block through
   ``stack_fwd``), 4 microbatches of 1 x 2048, fp32, remat; the forward
   equal bit for bit to a sequential run over the same microbatches and
   within 1e-5 x max|ref| of one whole-batch run, the gradient of
   sum(out**2) for every stacked leaf within 1e-4 x max|ref grad|, the
   flash launches of the pipeline's forward and backward put on the
   kernels line as ``launches_pipeline``; the three flash kernels then held
   against their plain versions at the shape the pipeline gave them (BH =
   1 x 32 heads, S = 2048, D = 128), fp32 and bf16, causal and not; wall
   and peak logged.
15. ``dryrun`` — ``launch/dryrun.py``: llama3-8b ``train_4k``,
   ``prefill_32k``, ``decode_32k`` and zamba2-1.2b ``long_500k`` traced on
   ``meta`` (roofline terms logged); then the train cell of phase 8 (8
   layers, 4 x 2048, bf16, remat, AdamW) traced and run for 3 steps on the
   card, gated on the trace's argument bytes equal to what the state and
   the batch add to ``memory_allocated()`` within 1 % and on finite
   losses; the step time against the model-FLOPs fraction of 989 TFLOP/s,
   the counted flops and the trace's peak against ``max_memory_allocated``
   logged.  A watchdog writes every thread's stack to stderr if the phase
   runs past ``DRYRUN_WATCHDOG_S``.

Needs a CUDA device: without one (or without the package beside it) the
script exits non-zero and prints no result.  ``--layers`` / ``--requests``
cut the served model's depth and traffic, for quick iterations; widths are
never cut (``quant`` and ``plan`` serve the ``serve`` phase's model).  The
trained depth is fixed at ``TRAIN_LAYERS``.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import faulthandler
import gc
import json
import math
import os
import statistics
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

try:
    import torch
except ImportError as exc:  # pragma: no cover - environment without torch
    sys.stderr.write(f"chip_smoke: torch is not importable: {exc}\n")
    sys.exit(3)

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

try:
    from repro_torch import backends, configs
    from repro_torch.core import gemm_sims, packing
    from repro_torch.core.accounting import packed_store_report
    from repro_torch.core.quantization import quantize
    from repro_torch.core.sparsity import profile_tensor
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.kernels import _build
    from repro_torch.kernels import bitsparsity as bs_lib
    from repro_torch.kernels import flash_attention as flash_lib
    from repro_torch.kernels import ops as ops_lib
    from repro_torch.kernels import packed_gemm as pg_lib
    from repro_torch.kernels import paged_attention as paged_lib
    from repro_torch.kernels import paged_attention_fused as fused_lib
    from repro_torch.kernels import quant_gemm as qg_lib
    from repro_torch.kernels import ref as ref_lib
    from repro_torch.kernels import unary_gemm as ug
    from repro_torch.analysis import ranges
    from repro_torch.eval import planner as planner_lib
    from repro_torch.launch import steps as steps_lib
    from repro_torch.launch import train as train_lib
    from repro_torch.models import model as model_lib
    from repro_torch.models.common import activation_scaling
    from repro_torch.models.config import ModelConfig
    from repro_torch.optim import AdamWConfig, adamw_init, cosine_schedule
    from repro_torch.launch.serve import validate_backend_numerics
    from repro_torch.stochastic import sgemm
    from repro_torch.serving import (FUSED_LOGIT_TOL, ServingEngine,
                                     TrafficConfig, fused_vs_gather_probe,
                                     generate_trace, paged_vs_contiguous_probe)
except ImportError as exc:
    sys.stderr.write(f"chip_smoke: the repro_torch package is not beside "
                     f"this script (src/repro_torch): {exc}\n")
    sys.exit(3)

DEV = torch.device("cuda", 0)

# Published peaks of one H100 SXM (NVIDIA data sheet, dense rates)
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
FP32_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12

REPLACES = {
    "fused_paged_decode": "src/repro/kernels/paged_attention_fused.py:167",
    "tub_gemm": "src/repro/kernels/unary_gemm.py:142",
    "tu_gemm": "src/repro/kernels/unary_gemm.py:217",
    "flash_fwd": "src/repro/kernels/flash_attention.py:95",
    "flash_bwd_dq": "src/repro/kernels/flash_attention.py:230",
    "flash_bwd_dkv": "src/repro/kernels/flash_attention.py:248",
    "packed_gemm": "src/repro/kernels/packed_gemm.py:124",
    "quant_gemm": "src/repro/kernels/quant_gemm.py:125",
    "block_stats": "src/repro/kernels/bitsparsity.py:57",
}
FLASH = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
INT_GEMMS = ("quant_gemm", "packed_gemm")
ALL_PHASES = ("device", "kernels", "probes", "serve", "quant", "plan", "ugemm",
              "train", "times", "grid", "families", "recurrent", "analysis",
              "pipeline", "dryrun")
SITE_LEAVES = (("attn", "wq"), ("attn", "wk"), ("attn", "wv"), ("attn", "wo"),
               ("mlp", "w_up"), ("mlp", "w_gate"), ("mlp", "w_down"))


def site_shapes(cfg) -> tuple[tuple[int, int], ...]:
    """(K, N) of the seven dense sites of a layer, in SITE_LEAVES order."""
    d, q = cfg.d_model, cfg.num_heads * cfg.resolved_head_dim
    kv = cfg.num_kv_heads * cfg.resolved_head_dim
    return ((d, q), (d, kv), (d, kv), (q, d), (d, cfg.d_ff), (d, cfg.d_ff),
            (cfg.d_ff, d))


# llama3-8b's: (4096,4096), (4096,1024) x2, (4096,4096), (4096,14336) x2,
# (14336,4096); four distinct shapes
SITE_SHAPES = site_shapes(configs.get_config("llama3-8b"))
UP_SHAPE = SITE_SHAPES[4]      # w_up: the headline shape of the times rows
# the quant_kernel path's dense sites per layer: wo runs the float einsum
# outside a backend scope, as in the reference (attention._out_proj)
QUANT_SITES_PER_LAYER = 6
QUANT_BITS = 4
TRAIN_STEPS = 10
# fp32 parameters, gradients and AdamW moments cost 16 B a parameter: 32
# layers of llama3-8b need ~128 GB, 8 layers (~2.8 B parameters) ~45 GB,
# which leaves room on an 80 GB card for the activations of batch 4 x 2048
TRAIN_LAYERS = 8
SOURCE = {
    "fused_paged_decode": "src/repro_torch/csrc/fused_paged_decode.cu",
    "tub_gemm": "src/repro_torch/csrc/unary_gemm.cu",
    "tu_gemm": "src/repro_torch/csrc/unary_gemm.cu",
    **{name: "src/repro_torch/csrc/flash_attention.cu" for name in FLASH},
    "quant_gemm": "src/repro_torch/csrc/quant_gemm.cu",
    "packed_gemm": "src/repro_torch/csrc/packed_gemm.cu",
    "block_stats": "src/repro_torch/csrc/bitsparsity.cu",
}
KERNELS = ("fused_paged_decode", "tub_gemm", "tu_gemm", *FLASH, *INT_GEMMS,
           "block_stats")


class Failed(Exception):
    pass


def require(cond: bool, what: str) -> None:
    if not cond:
        raise Failed(what)


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# phase 1: device + build
# ---------------------------------------------------------------------------

# the kernels that run on the tensor cores: the bf16 instantiation of each
# flash kernel (tensor-core instruction HMMA, per head dim), the int8 slot
# loop of tuGEMM and tubGEMM (IMMA, per row-block width; one template, told
# apart by its pulse builder) and the packed GEMMs' int8 kernel (IMMA, per
# bit width and row-block width; one template, its WORDS flag telling
# packed_gemm's word stores from quant_gemm's container)
MMA_KERNELS = {"flash_fwd": "flash_fwd_mma_kernel",
               "flash_bwd_dq": "flash_bwd_dq_mma_kernel",
               "flash_bwd_dkv": "flash_bwd_dkv_mma_kernel",
               "tu_gemm": "unary_mma_kernel", "tub_gemm": "unary_mma_kernel",
               "quant_gemm": "int_mma_kernel", "packed_gemm": "int_mma_kernel"}
INT8_MMA = ("tu_gemm", "tub_gemm", "quant_gemm", "packed_gemm")
MMA_ROWS = (8, 16, 32, 64)         # rows a block of the int8 instances
PULSES = {"TubPulses": "tub_gemm", "TuPulses": "tu_gemm"}


def _cuobjdump(*args: str) -> str:
    exe = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = subprocess.run([exe, *args, _build.load_library()._name],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         text=True, timeout=300)
    require(out.returncode == 0, f"cuobjdump {' '.join(args)} failed: {out.stdout[-2000:]}")
    return out.stdout


def _mma_instance(line: str):
    """(name, key) of the tensor-core kernel a cuobjdump ``Function`` line
    names, else None.  The key is the head dim for flash; for the unary slot
    loop (template arguments Pulses, WN, WM, WARPS_N, WARPS_M) the rows per
    block, WARPS_M * WM * 8, and its pulse builder names the design; for
    the packed GEMMs (WORDS, BITS, WN, WM, WARPS_N, WARPS_M) the pair (bits,
    rows), WORDS naming packed_gemm (true) or quant_gemm (false)."""
    hit = _MMA_PATTERN.search(line)
    if not hit:
        return None
    kernel, targs = hit.group(1), hit.group(2)
    args = [int(x) for x in re.findall(r"Li(\d+)E", targs)]
    if kernel == "unary_mma_kernel":
        name = next(v for k, v in PULSES.items() if k in targs)
        return name, args[3] * args[1] * 8
    if kernel == "int_mma_kernel":
        name = "packed_gemm" if "Lb1E" in targs else "quant_gemm"
        return name, (args[0], args[4] * args[2] * 8)
    return _BY_KERNEL[kernel], args[0]


_BY_KERNEL = {v: k for k, v in MMA_KERNELS.items() if k in FLASH}
# mangled names: flash_fwd_mma_kernelILi128EE..., for the slot loop
# unary_mma_kernelINS_8TuPulsesELi2ELi1ELi4ELi1EE... and for the packed
# GEMMs int_mma_kernelILb0ELi4ELi2ELi1ELi4ELi1EE... (Lb1E: packed_gemm)
_MMA_PATTERN = re.compile(r"(%s)I((?:[^L]\w*?E)?(?:Lb[01]E)?(?:Li\d+E)+)E"
                          % "|".join(sorted(set(MMA_KERNELS.values()))))


def _mma_keys(name: str) -> tuple:
    if name in INT_GEMMS:
        return tuple((bits, rows) for bits in (2, 4, 8) for rows in MMA_ROWS)
    return MMA_ROWS if name in INT8_MMA else flash_lib.HEAD_DIMS


def _resident(name: str, key) -> int:
    """Blocks of the int8 instance one SM holds at once: what its split plan
    reads (the CUDA occupancy calculator, through the library)."""
    if name in INT_GEMMS:
        bits, rows = key
        return _build.resident_blocks(f"{name}_resident_blocks", 0, rows, bits)
    return _build.resident_blocks("unary_resident_blocks", 0, ug._MODE[name], key)


def _tensor_core_report() -> dict:
    """From the built library: per instantiation of the tensor-core kernels
    the count of tensor-core instructions in its SASS (HMMA or HGMMA for
    bf16 flash, IMMA for the int8 kernels) and its registers, stack and
    local memory a thread (``cuobjdump -res-usage``).  Every instantiation
    must hold tensor-core instructions and use no stack and no local
    memory; beside each int8 instance the blocks one SM holds."""
    report = {name: {} for name in MMA_KERNELS}
    current = None
    for line in _cuobjdump("-sass").splitlines():
        if "Function :" in line:
            current = _mma_instance(line)
            if current:
                report[current[0]][current[1]] = {"hmma": 0}
        elif current and re.search(
                r"\bIMMA\b" if current[0] in INT8_MMA else r"\bH(G)?MMA\b", line):
            report[current[0]][current[1]]["hmma"] += 1
    current = None
    for line in _cuobjdump("-res-usage").splitlines():
        if "Function" in line:
            current = _mma_instance(line)
        elif current and "REG:" in line:
            use = dict((k, int(v)) for k, v in re.findall(r"(REG|STACK|SHARED|LOCAL):(\d+)", line))
            report[current[0]].setdefault(current[1], {}).update(use)
    for name, per_key in report.items():
        int8 = name in INT8_MMA
        label = ("bits, rows" if name in INT_GEMMS else "rows") if int8 else "d"
        op = "IMMA" if int8 else "HMMA"
        for key in _mma_keys(name):
            use = per_key.get(key, {})
            require(use.get("hmma", 0) > 0,
                    f"{MMA_KERNELS[name]} for {name} ({label}={key}) has no {op} in its "
                    f"SASS ({use})")
            require(use.get("STACK", 0) == 0 and use.get("LOCAL", 0) == 0,
                    f"{MMA_KERNELS[name]} for {name} ({label}={key}) spills: {use}")
            if int8:
                use["resident"] = _resident(name, key)
        log(f"  {name} {'int8' if int8 else 'bf16'} (SASS of the built library): "
            + ", ".join(f"{label}={k}: {u.get('hmma')} {op}, {u.get('REG')} registers, "
                        f"stack {u.get('STACK')} B, local {u.get('LOCAL')} B"
                        + (f", {u['resident']} blocks resident an SM" if int8 else "")
                        for k, u in sorted(per_key.items())))
    return report


def phase_device() -> dict:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, timeout=60)
    require(out.returncode == 0, f"nvidia-smi failed: {out.stdout}")
    for line in out.stdout.strip().splitlines():
        log(line.strip())
    log(f"device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}, "
        f"torch {torch.__version__}, cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    _build.load_library(verbose=bool(os.environ.get("CHIP_SMOKE_VERBOSE_BUILD")))
    built = _build.last_build_seconds()
    log(f"build: kernels from {', '.join(_build.SOURCES)} into "
        f"{_build.build_dir()} in "
        f"{(built if built is not None else time.perf_counter() - t0):.1f} s"
        f"{'' if built is not None else ' (cached library)'}")
    return _tensor_core_report()


# ---------------------------------------------------------------------------
# phase 2: kernels vs plain versions
# ---------------------------------------------------------------------------

def _codes(gen, shape, bits):
    v = 2 ** (bits - 1) - 1
    return torch.randint(-v, v + 1, shape, generator=gen, device=DEV,
                         dtype=torch.int32).to(torch.int8)


def _decode_case(gen, lengths, *, pool_dtype, q_dtype=torch.float32,
                 batch=8, h=32, kvh=8, hd=128, page=16, max_len=1024):
    """Ragged paged-decode operands with shuffled page ids; returns the clean
    pools and a copy whose dead pages are NaN-poisoned."""
    max_blocks = max_len // page
    num_pages = 1 + batch * max_blocks
    perm = torch.randperm(num_pages - 1, generator=gen, device=DEV) + 1
    bt = perm.reshape(batch, max_blocks).to(torch.int32)
    lens = torch.tensor(lengths, dtype=torch.int32, device=DEV)
    shape = (num_pages, page, kvh, hd)
    pk = torch.randn(shape, generator=gen, device=DEV).to(pool_dtype)
    pv = torch.randn(shape, generator=gen, device=DEV).to(pool_dtype)
    q = torch.randn((batch, 1, h, hd), generator=gen, device=DEV).to(q_dtype)
    n_blocks = (lens.long() + page - 1) // page
    dead = torch.ones(num_pages, dtype=torch.bool, device=DEV)
    live_mask = torch.arange(max_blocks, device=DEV)[None, :] < n_blocks[:, None]
    dead[bt.long()[live_mask]] = False
    pk_poison, pv_poison = pk.clone(), pv.clone()
    pk_poison[dead] = float("nan")
    pv_poison[dead] = float("nan")
    return q, pk, pv, pk_poison, pv_poison, bt, lens


RAGGED_LENGTHS = (1, 16, 17, 255, 256, 500, 777, 1024)


@contextlib.contextmanager
def _decode_splits(n):
    """Force the fused decode kernel's split count to ``n`` (None: keep its
    plan).  The wrapper reads its plan through the module global
    ``plan_decode_splits``, which this replaces for the block's duration."""
    planned = fused_lib.plan_decode_splits
    if n is not None:
        fused_lib.plan_decode_splits = lambda *shape: n
    try:
        yield
    finally:
        fused_lib.plan_decode_splits = planned


def _check_fused_decode(gen, errs: dict, lengths, *, pool_dtype,
                        q_dtype=torch.float32, splits=None, **geom) -> None:
    """The fused decode kernel (split as planned, or ``splits`` ways) on
    NaN-poisoned dead pages against the gather oracle on clean pools and
    the plain walk over the same split ranges; two launches bitwise equal.
    Tolerances are absolute, (vs gather oracle, vs plain walk).  With a
    bfloat16 query the oracle also rounds K/V products and softmax weights
    to bfloat16, so only the plain walk (same rounding points as the
    kernel) holds the kernel there: the two may differ by the last
    rounding of one float32 value, one bfloat16 ulp of that element."""
    q, pk, pv, pkp, pvp, bt, lens = _decode_case(
        gen, lengths, pool_dtype=pool_dtype, q_dtype=q_dtype, **geom)
    h, hd = q.shape[2], q.shape[3]
    with _decode_splits(splits):
        got = fused_lib.fused_paged_decode_attention(q, pkp, pvp, bt, lens,
                                                     num_heads=h)
        torch.cuda.synchronize()
        again = fused_lib.fused_paged_decode_attention(q, pkp, pvp, bt, lens,
                                                       num_heads=h)
    require(bool(torch.isfinite(got.float()).all()),
            "fused decode read a dead (NaN-poisoned) page")
    require(torch.equal(got, again), "fused decode: two launches differ")
    oracle = paged_lib.paged_decode_attention(q, pk, pv, bt, lens, num_heads=h)
    plain = fused_lib.fused_decode_plain(q, pkp, pvp, bt, lens, num_heads=h,
                                         splits=splits or 1)
    d_oracle = float((got.float() - oracle.float()).abs().max())
    d_plain = float((got.float() - plain.float()).abs().max())
    if q_dtype == torch.float32:
        errs["fused_paged_decode"] = max(errs["fused_paged_decode"], d_oracle,
                                         d_plain)
        tol, plain_ok, plain_tol = 1e-4, d_plain <= 1e-4, "0.0001"
    else:
        ulp = plain.float().abs() * 2.0 ** -7 + 1e-6
        tol = 2e-2
        plain_ok = bool(((got.float() - plain.float()).abs() <= ulp).all())
        plain_tol = "one bfloat16 ulp of each element"
    what = (f"fused decode pools={str(pool_dtype).split('.')[-1]} "
            f"q={str(q_dtype).split('.')[-1]} B={q.shape[0]} H={h} "
            f"KVH={pk.shape[2]} hd={hd} page={pk.shape[1]} "
            f"splits={'planned' if splits is None else splits}")
    log(f"  {what}: max |kernel-gather oracle| {d_oracle:.3e} (tol {tol:g}), "
        f"max |kernel-plain walk| {d_plain:.3e} (tol {plain_tol})")
    require(d_oracle <= tol and plain_ok,
            f"{what} disagrees: vs oracle {d_oracle} (tol {tol}), vs plain walk "
            f"{d_plain} (tol {plain_tol})")


def phase_kernels() -> dict:
    gen = torch.Generator(device=DEV)
    gen.manual_seed(0)
    errs = {name: 0.0 for name in KERNELS}
    # (M, K, N): decode sites, a prefill site (the 128256-wide lm_head cut to
    # a 4096-column slice: the plain slot loop and 128-slot tuGEMM at full
    # width would take minutes), and a ragged shape that exercises the masks.
    shapes = [(8, 4096, 4096), (8, 4096, 1024), (8, 4096, 14336),
              (8, 14336, 4096), (512, 4096, 4096), (13, 203, 77)]
    for (m, k, n) in shapes:
        for bits in (2, 4, 8):
            a = _codes(gen, (m, k), bits)
            b = torch.randint(-128, 128, (k, n), generator=gen, device=DEV,
                              dtype=torch.int32).to(torch.int8)
            oracle = gemm_sims.bgemm_exact(a, b)
            for name, fn, plain, cyc in (
                    ("tub_gemm", ug.tub_gemm, ref_lib.tub_gemm_ref, ug.tub_wc_cycles),
                    ("tu_gemm", ug.tu_gemm, ref_lib.tu_gemm_ref, ug.tu_wc_cycles)):
                out, cycles = fn(a, b, bits=bits)
                torch.cuda.synchronize()
                want = plain(a, b, bits=bits)
                d_plain = int((out.long() - want.long()).abs().max())
                d_oracle = int((out.long() - oracle.long()).abs().max())
                errs[name] = max(errs[name], float(d_plain), float(d_oracle))
                require(d_plain == 0 and d_oracle == 0,
                        f"{name} ({m},{k},{n}) bits={bits}: max |kernel-plain| "
                        f"{d_plain}, max |kernel-int GEMM| {d_oracle} (want 0)")
                require(cycles == cyc(bits, k), f"{name} cycle report")
    # every int8 code at 8 bits, -128 included (magnitude 128: tub's v1 = 64
    # fires in all 64 slots, tu's |a| in all 128)
    for (m, k, n) in ((8, 4096, 4096), (13, 203, 77)):
        a = _full_codes(gen, (m, k), 8)
        a[:, :2] = -128
        b = _full_codes(gen, (k, n), 8)
        oracle = gemm_sims.bgemm_exact(a, b)
        for name, fn, plain in (("tub_gemm", ug.tub_gemm, ref_lib.tub_gemm_ref),
                                ("tu_gemm", ug.tu_gemm, ref_lib.tu_gemm_ref)):
            out, _ = fn(a, b, bits=8)
            torch.cuda.synchronize()
            d = max(int((out.long() - oracle.long()).abs().max()),
                    int((out.long() - plain(a, b, bits=8).long()).abs().max()))
            errs[name] = max(errs[name], float(d))
            require(d == 0, f"{name} ({m},{k},{n}) on every int8 code: max |d| {d}")
    # full-width lm_head at decode rows, checked against the integer oracle
    a = _codes(gen, (8, 4096), 4)
    b = torch.randint(-7, 8, (4096, 128256), generator=gen, device=DEV,
                      dtype=torch.int32).to(torch.int8)
    oracle = gemm_sims.bgemm_exact(a, b)
    for name, fn in (("tub_gemm", ug.tub_gemm), ("tu_gemm", ug.tu_gemm)):
        out, _ = fn(a, b, bits=4)
        d = int((out.long() - oracle.long()).abs().max())
        errs[name] = max(errs[name], float(d))
        require(d == 0, f"{name} (8,4096,128256) vs int GEMM: max |d| {d}")
    del a, b, oracle

    # fused decode: B=8, H=32, KVH=8, hd=128, page=16, ragged lengths, the
    # page axis split as planned; then forced split counts (the whole walk in
    # one block, two halves, a page a split), head dims 96, 256 and 512 (the
    # wide rows' instance), and small odd geometry (page 3, GQA 1 and 4, hd 64)
    combos = ((torch.float32, torch.float32), (torch.bfloat16, torch.float32),
              (torch.bfloat16, torch.bfloat16))
    for pool_dtype, q_dtype in combos:
        _check_fused_decode(gen, errs, RAGGED_LENGTHS, pool_dtype=pool_dtype,
                            q_dtype=q_dtype)
    for splits in (1, 2, 1024 // 16):
        for pool_dtype in (torch.float32, torch.bfloat16):
            _check_fused_decode(gen, errs, RAGGED_LENGTHS, pool_dtype=pool_dtype,
                                splits=splits)
    for hd in (96, 256, 512):
        for pool_dtype, q_dtype in combos:
            _check_fused_decode(gen, errs, RAGGED_LENGTHS, pool_dtype=pool_dtype,
                                q_dtype=q_dtype, hd=hd)
    for (h, kvh, page) in ((4, 4, 3), (8, 2, 3), (4, 1, 8)):
        _check_fused_decode(gen, errs, (1, 3, 4, 23), pool_dtype=torch.float32,
                            batch=4, h=h, kvh=kvh, hd=64, page=page, max_len=24)
    _flash_kernels(gen, errs)
    _int_gemm_kernels(gen, errs)
    _block_stats_kernels(gen, errs)
    log("kernels: " + json.dumps(
        [{"name": k, "max_abs_err": v} for k, v in errs.items()]))
    return errs


# (BH, Sq, Skv, D): the training path's slabs (B=4 x H=32, S=2048, d=128),
# a ragged length, Sq != Skv, d=64, and Sq > Skv at d=16 with both lengths
# one past and one short of the 64-wide tiles; head dims 96 (phi3-mini),
# 256 (gemma-7b) and 192 (deepseek-v3's MLA q/k) at a ragged length and both
# Sq != Skv
FLASH_CASES = ((128, 2048, 2048, 128), (128, 2000, 2000, 128),
               (16, 77, 130, 128), (16, 333, 333, 64), (16, 129, 63, 16),
               (32, 1000, 1000, 96), (16, 129, 63, 96), (32, 777, 777, 256),
               (16, 77, 130, 256), (16, 129, 63, 256), (32, 777, 777, 192),
               (16, 77, 130, 192), (16, 129, 63, 192))
FLASH_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}   # x max|plain|
# bf16 o, dQ, dK, dV also per element: |kernel - plain| <= FLASH_BF16_ROW_TOL
# x (|plain| + max|plain| of its row), so that small later rows are held too;
# 3 x the largest such ratio measured on an H100 over FLASH_CASES (3.9e-3)
FLASH_BF16_ROW_TOL = 1.2e-2


def _poisoned(gen, bh, n, d, dtype, pad=64):
    """(bh, n, d) view of a buffer whose rows past n are NaN."""
    buf = torch.randn((bh, n + pad, d), generator=gen, device=DEV).to(dtype)
    buf[:, n:] = float("nan")
    return buf[:, :n]


def _row_relative_err(got, want) -> float:
    """max over elements of |got - want| / (|want| + max |want| of its row);
    a row that is zero in ``want`` must be zero in ``got``."""
    want = want.float()
    scale = want.abs() + want.abs().amax(dim=-1, keepdim=True)
    return float(((got.float() - want).abs() / scale.clamp_min(1e-30)).max())


def _flash_kernels(gen, errs: dict) -> None:
    """Forward, dQ and dK/dV against their plain versions: fp32 and bf16,
    causal and not, every shape of FLASH_CASES."""
    for dtype in (torch.float32, torch.bfloat16):
        for (bh, sq, skv, d) in FLASH_CASES:
            for causal in (True, False):
                _flash_case(gen, errs, bh, sq, skv, d, dtype, causal)


def _flash_case(gen, errs: dict, bh: int, sq: int, skv: int, d: int, dtype,
                causal: bool) -> None:
    """The three flash kernels at one (BH, Sq, Skv, D, dtype, causal) against
    their plain versions, within FLASH_TOL (and FLASH_BF16_ROW_TOL per row in
    bf16); the slabs' padded tails are NaN, so a kernel that read one would
    fail the finiteness check.  fp32 errors raise ``errs``' entries."""
    q = _poisoned(gen, bh, sq, d, dtype)
    k = _poisoned(gen, bh, skv, d, dtype)
    v = _poisoned(gen, bh, skv, d, dtype)
    do = _poisoned(gen, bh, sq, d, dtype)
    o, lse = flash_lib.flash_fwd(q, k, v, causal=causal)
    delta = torch.sum(do.float() * o.float(), dim=-1)
    dq = flash_lib.flash_bwd_dq(q, k, v, do, lse, delta, causal=causal)
    dk, dv = flash_lib.flash_bwd_dkv(q, k, v, do, lse, delta, causal=causal)
    torch.cuda.synchronize()
    p_o, p_lse = flash_lib.flash_fwd_plain(q, k, v, causal=causal)
    p_dq = flash_lib.flash_bwd_dq_plain(q, k, v, do, p_lse, delta, causal=causal)
    p_dk, p_dv = flash_lib.flash_bwd_dkv_plain(q, k, v, do, p_lse, delta,
                                               causal=causal)
    rel, row_rel = {}, {}
    for name, kern, got, want in (
            ("o", "flash_fwd", o, p_o), ("lse", "flash_fwd", lse, p_lse),
            ("dq", "flash_bwd_dq", dq, p_dq),
            ("dk", "flash_bwd_dkv", dk, p_dk),
            ("dv", "flash_bwd_dkv", dv, p_dv)):
        require(bool(torch.isfinite(got.float()).all()),
                f"flash {name} not finite (a NaN-poisoned tail was read?)")
        err = float((got.float() - want.float()).abs().max())
        top = float(want.float().abs().max())
        rel[name] = err / top
        if dtype == torch.float32:
            errs[kern] = max(errs[kern], err)
        require(err <= FLASH_TOL[dtype] * top,
                f"flash {name} ({bh},{sq},{skv},{d}) {dtype} causal="
                f"{causal}: max |kernel-plain| {err:.3e} > "
                f"{FLASH_TOL[dtype]:g} x max|plain| {top:.3e}")
        if dtype == torch.bfloat16 and name != "lse":
            if name == "dq" and causal:
                # query 0 sees key 0 alone, so its dS = P (dP - delta)
                # cancels exactly: its dQ row is fp32 rounding noise in
                # kernel and plain alike, held to 64 fp32 ulps of the
                # cancelling terms' scale (as in tests/test_torch_gpu.py),
                # the other rows to the per-row check
                bound = 64 * 2.0 ** -23 * d ** 0.5 * float(
                    do.float().abs().max() * v.float().abs().max()
                    * torch.maximum(q.float().abs().max(),
                                    k.float().abs().max()))
                err0 = float((got[:, 0].float() - want[:, 0].float())
                             .abs().max())
                require(err0 <= bound,
                        f"flash dq ({bh},{sq},{skv},{d}) bf16 causal: "
                        f"query 0's cancelled row off by {err0:.3e} > "
                        f"{bound:.3e}")
                got, want = got[:, 1:], want[:, 1:]
            row_rel[name] = _row_relative_err(got, want)
            require(row_rel[name] <= FLASH_BF16_ROW_TOL,
                    f"flash {name} ({bh},{sq},{skv},{d}) bf16 causal="
                    f"{causal}: |kernel-plain| / (|plain| + row max"
                    f" |plain|) {row_rel[name]:.3e} > "
                    f"{FLASH_BF16_ROW_TOL:g}")
    log(f"  flash BH={bh} Sq={sq} Skv={skv} d={d} "
        f"{str(dtype).split('.')[-1]} causal={causal}: max|kernel-plain|"
        f" / max|plain| " + ", ".join(f"{n} {r:.2e}" for n, r in rel.items())
        + f" (tol {FLASH_TOL[dtype]:g})"
        + ("; per row " + ", ".join(f"{n} {r:.2e}" for n, r in row_rel.items())
           + f" (tol {FLASH_BF16_ROW_TOL:g})" if row_rel else ""))
    del q, k, v, do, o, lse, dq, dk, dv, p_o, p_lse, p_dq, p_dk, p_dv


def _full_codes(gen, shape, bits):
    """Codes over the full signed range, -2^(bits-1) included."""
    v = 1 << (bits - 1)
    return torch.randint(-v, v, shape, generator=gen, device=DEV,
                         dtype=torch.int32).to(torch.int8)


# M of the packed GEMMs: decode rows (8 slots) and a long prompt's prefill
# rows (the quant phase checks the trace's own prefill rows as well)
INT_GEMM_ROWS = (8, 512)
# ragged (M, K, N): K off the codes per word and the 64-wide K tile, M and N
# off the row and 128-column tiles
INT_GEMM_RAGGED = ((1, 4093, 1027), (33, 203, 77), (13, 100, 300))


def _check_int_gemms(gen, errs: dict, m: int, k: int, n: int, bits: int,
                     fuses=(False, True)) -> None:
    """quant_gemm (K cut to a multiple of 8/bits) and packed_gemm against
    their plain versions, int32 and fused float32: EQUAL, or fail."""
    x = _full_codes(gen, (m, k), 8)
    w = _full_codes(gen, (k, n), bits)
    scales = torch.rand((1, n), generator=gen, device=DEV) * 1e-2 + 1e-4
    kq = k - k % (8 // bits)
    w_packed = ops_lib.pack_values(w[:kq], bits)
    words = packing.pack_codes(w, bits)
    for fuse in fuses:
        for name, got, plain in (
                ("quant_gemm",
                 lambda: qg_lib.quant_gemm(x[:, :kq], w_packed, scales, bits=bits,
                                           fuse_dequant=fuse),
                 lambda: ref_lib.quant_gemm_ref(x[:, :kq], w_packed, scales,
                                                bits=bits, fuse_dequant=fuse)),
                ("packed_gemm",
                 lambda: pg_lib.packed_gemm(x, words, scales, bits=bits, k=k,
                                            fuse_dequant=fuse),
                 lambda: ref_lib.packed_gemm_ref(x, words, scales, bits=bits,
                                                 k=k, fuse_dequant=fuse))):
            out = got()
            torch.cuda.synchronize()
            want = plain()
            d = float((out.double() - want.double()).abs().max()) if out.numel() else 0.0
            errs[name] = max(errs[name], d)
            require(out.dtype == want.dtype and torch.equal(out, want),
                    f"{name} ({m},{k},{n}) bits={bits} fuse={fuse}: max "
                    f"|kernel-plain| {d} (want equal)")
    # the integer oracle, independent of both plain versions
    oracle = gemm_sims.bgemm_exact(x, w)
    got = pg_lib.packed_gemm(x, words, bits=bits, k=k)
    require(torch.equal(got, oracle), f"packed_gemm ({m},{k},{n}) bits={bits} "
                                      f"differs from the integer GEMM")


def _int_gemm_kernels(gen, errs: dict) -> None:
    """The packed GEMMs at bits {2, 4, 8}, fused dequant on and off: the
    path's site shapes at decode and prefill rows, and ragged shapes."""
    shapes = [(m, k, n) for m in INT_GEMM_ROWS for (k, n) in
              sorted(set(SITE_SHAPES))] + list(INT_GEMM_RAGGED)
    for (m, k, n) in shapes:
        for bits in (2, 4, 8):
            _check_int_gemms(gen, errs, m, k, n, bits)
    log(f"  quant_gemm, packed_gemm: {len(shapes)} shapes x bits 2/4/8 x "
        f"fused on/off equal to their plain versions (int32 and float32)")


# (M, N) of block_stats: the site weights, as (K, N), ragged shapes, and
# more than 65,535 tile rows at every tile
BLOCK_STATS_SHAPES = (*sorted(set(SITE_SHAPES)), (1, 1), (33, 70),
                      (1000, 777), (4095, 14337), (2_100_000, 32))


def _block_stats_kernels(gen, errs: dict) -> None:
    """block_stats at every tile 1..128 EQUAL to the plain version, on
    per-tensor 4-bit codes of a weight, on the full int8 range (-128
    included) and on zeros; the launch's two sums equal the statistics'."""
    cases = 0
    for (m, n) in BLOCK_STATS_SHAPES:
        w = torch.randn((m, n), generator=gen, device=DEV)
        inputs = {"4-bit codes": quantize(w, bits=4, per_channel=False).values,
                  "int8 codes": _full_codes(gen, (m, n), 8),
                  "zeros": torch.zeros((m, n), dtype=torch.int8, device=DEV)}
        inputs["int8 codes"].view(-1)[::7] = -128
        del w
        for what, q in inputs.items():
            for tile in bs_lib.TILES:
                maxes, zeros, sums = bs_lib.block_stats_with_sums(q, tile=tile)
                torch.cuda.synchronize()
                want_max, want_zero = ref_lib.block_stats_ref(q, tile)
                d = max(int((maxes - want_max).abs().max()),
                        int((zeros - want_zero).abs().max()))
                errs["block_stats"] = max(errs["block_stats"], float(d))
                require(torch.equal(maxes, want_max) and torch.equal(zeros, want_zero),
                        f"block_stats ({m},{n}) {what} tile={tile}: max "
                        f"|kernel-plain| {d} (want 0)")
                want_sums = [int(want_max.sum(dtype=torch.int64)),
                             int(want_zero.sum(dtype=torch.int64))]
                require(sums.tolist() == want_sums,
                        f"block_stats ({m},{n}) {what} tile={tile}: sums "
                        f"{sums.tolist()} != {want_sums}")
                cases += 1
        del inputs
    log(f"  block_stats: {len(BLOCK_STATS_SHAPES)} shapes x (4-bit, int8 "
        f"with -128, zeros) x tiles {list(bs_lib.TILES)} = {cases} cases equal "
        f"to the plain version, fused sums equal")


# ---------------------------------------------------------------------------
# phase 3: probes
# ---------------------------------------------------------------------------

def phase_probes() -> None:
    cfg = configs.get_smoke_config("llama3-8b").replace(
        compute_dtype="float32", param_dtype="float32")
    gen = torch.Generator(device=DEV)
    gen.manual_seed(0)
    params = model_lib.init_params(cfg, gen, device=DEV)
    for page in (4, 16):
        diff = paged_vs_contiguous_probe(cfg, params, page_size=page)
        fdiff = fused_vs_gather_probe(cfg, params, page_size=page)
        log(f"probes (page {page}): paged vs contiguous max |dlogit| {diff:.3e} "
            f"(want 0.0); fused vs gather {fdiff:.3e} (tol {FUSED_LOGIT_TOL:g})")
        require(diff == 0.0, f"paged decode differs from contiguous: {diff}")
        require(fdiff <= FUSED_LOGIT_TOL,
                f"fused decode off the gather oracle: {fdiff}")


# ---------------------------------------------------------------------------
# phase 4: serve at full width
# ---------------------------------------------------------------------------

class _Digest:
    """Order-sensitive digest of every site's int32 GEMM output."""

    def __init__(self) -> None:
        self.items: list[tuple[str, tuple[int, ...], int, int]] = []

    def __call__(self, site: str, out: torch.Tensor) -> None:
        flat = out.reshape(-1).to(torch.int64)
        weights = (torch.arange(flat.numel(), device=flat.device) % 8191) + 1
        self.items.append((site, tuple(out.shape), int(flat.sum()),
                           int((flat * weights).sum())))


def _device_rows(prof) -> list[tuple[float, str, int]]:
    """(device µs, name, count) of what ran on the card: kernels, copies,
    fills.  The host-side operators above them (``aten::mm``, an autograd
    Function) report the same device time again, so only events whose device
    type is CUDA are summed."""
    from torch.autograd import DeviceType
    rows = [(e.self_device_time_total, e.key, e.count) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    return [r for r in rows if r[0] > 0]


def _decode_step_profile(engine, cfg, kernels: dict[str, str]) -> None:
    """Steady-state decode step of the main path: 8 active slots at context
    300, timed with a synchronise per step, then traced for three steps;
    ``kernels`` maps each hand-written kernel of the path to a piece of its
    traced name, whose device time and launches a step are printed."""
    dev = engine.device
    b = engine.max_batch
    cache = engine.new_cache()
    tables = []
    for i in range(b):
        cache.allocate(i, 400)
        tables.append(cache.block_table_row(i))
    d_bt = torch.from_numpy(np.stack(tables)).to(dev)
    cache.k_pool.normal_()
    cache.v_pool.normal_()
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    tokens = torch.randint(0, cfg.vocab_size, (b, 1), generator=gen, device=dev,
                           dtype=torch.int32)
    active = torch.ones((b,), dtype=torch.bool, device=dev)
    state = {"lengths": torch.full((b,), 300, dtype=torch.int32, device=dev)}

    def one_step():
        _, _, _, state["lengths"] = engine._decode(
            engine._exec_params, tokens, cache.k_pool, cache.v_pool, d_bt,
            state["lengths"], active)

    with engine._scope(), activation_scaling("per-row"):
        _step_profile(one_step, "steady decode step (8 slots, context 300)",
                      kernels, top=10)


def _fused_gather_divergence(cfg, fused, gather, *, steps: int = 4,
                             prompt_len: int = 256) -> None:
    """Count what separates fused and gather decode under 4-bit per-row
    execution: prefill one seeded prompt per slot, then run ``steps`` decode
    steps through both engines from identical pools and tokens (both are fed
    the gather engine's token, and the fused engine's pools are reset to the
    gather engine's after every step).  Per step it reports how many
    activation codes entering the dense sites differ, where the first one
    is, and the logit gap beside each row's top-1/top-2 margin.
    """
    dev, b = fused.device, fused.max_batch
    base = backends.resolve("tubgemm_cuda", bits=4)
    seen: list[torch.Tensor] = []

    def recording(a, w, bits):
        seen.append(a)
        return base.spec.exact_fn(a, w, bits)

    rec = dataclasses.replace(
        base, spec=dataclasses.replace(base.spec, exact_fn=recording))

    def scope():
        return backends.use_backend(rec, weight_cache=fused.weight_cache)

    rng = np.random.default_rng(3)
    prompts = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (b, prompt_len)).astype(np.int32)).to(dev)
    with scope(), activation_scaling("per-row"):
        logits, k_l, v_l = gather._prefill(prompts)
    tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
    caches = {"gather": gather.new_cache(), "fused": fused.new_cache()}
    for cache in caches.values():
        for i in range(b):
            cache.allocate(i, prompt_len + steps + 1)
            cache.write_prefill(i, k_l[:, i], v_l[:, i])
    tables = {name: np.stack([c.block_table_row(i) for i in range(b)])
              for name, c in caches.items()}
    require(bool((tables["gather"] == tables["fused"]).all()),
            "the two caches handed out different pages")
    d_bt = torch.from_numpy(tables["gather"]).to(dev)
    del logits, k_l, v_l
    active = torch.ones((b,), dtype=torch.bool, device=dev)
    leaves = ("wq", "wk", "wv", "wo", "w_up", "w_gate", "w_down")
    for step in range(steps):
        lengths = torch.full((b,), prompt_len + step, dtype=torch.int32,
                             device=dev)
        got = {}
        for name, eng in (("gather", gather), ("fused", fused)):
            seen.clear()
            cache = caches[name]
            with scope(), activation_scaling("per-row"):
                lg, _, _, _ = eng._decode(eng.params, tok, cache.k_pool,
                                          cache.v_pool, d_bt, lengths, active)
            got[name] = (lg[:, 0], list(seen))
        (lg_g, codes_g), (lg_f, codes_f) = got["gather"], got["fused"]
        require(len(codes_g) == len(codes_f) == 7 * cfg.num_layers + 1,
                "divergence probe saw the wrong number of dense sites")
        per_site = torch.stack([(x != y).sum() for x, y in
                                zip(codes_f, codes_g)]).cpu()
        biggest = max(int((x.int() - y.int()).abs().max())
                      for x, y in zip(codes_f, codes_g))
        total = sum(x.numel() for x in codes_g)
        hit = torch.nonzero(per_site)
        first = int(hit[0]) if len(hit) else None
        where = ("nowhere" if first is None
                 else "lm_head" if first == 7 * cfg.num_layers
                 else f"layer {first // 7} {leaves[first % 7]}")
        gap = (lg_f - lg_g).abs().amax(dim=-1)
        top2 = lg_g.topk(2, dim=-1).values
        margin = top2[:, 0] - top2[:, 1]
        flips = int((lg_f.argmax(dim=-1) != lg_g.argmax(dim=-1)).sum())
        log(f"  divergence step {step} (context {prompt_len + step}): "
            f"{int(per_site.sum())} of {total} activation codes differ "
            f"(largest code difference {biggest}), first at {where}, "
            f"{int((per_site > 0).sum())} of {len(per_site)} sites touched; "
            f"max |dlogit| per row {float(gap.min()):.3e}..{float(gap.max()):.3e}, "
            f"top-1/top-2 margin per row {float(margin.min()):.3e}.."
            f"{float(margin.max()):.3e}, logit std {float(lg_g.std()):.3e}, "
            f"argmax differs in {flips} of {b} rows")
        # wq/wk/wv of layer 0 read the same hidden state in both engines
        require(int(per_site[:3].sum()) == 0,
                "activation codes differ before the first attention output")
        caches["fused"].k_pool.copy_(caches["gather"].k_pool)
        caches["fused"].v_pool.copy_(caches["gather"].v_pool)
        tok = torch.argmax(lg_g, dim=-1).to(torch.int32)[:, None]


def served_model(layers: int):
    """llama3-8b at its published widths, ``layers`` deep, fp32 parameters
    and compute, weights from seed 0: the model the serve and quant phases
    share."""
    cfg = configs.get_config("llama3-8b").replace(
        num_layers=layers, param_dtype="float32", compute_dtype="float32")
    log(f"served model: llama3-8b widths d_model={cfg.d_model} heads="
        f"{cfg.num_heads} kv_heads={cfg.num_kv_heads} head_dim="
        f"{cfg.resolved_head_dim} d_ff={cfg.d_ff} vocab={cfg.vocab_size}, "
        f"layers={cfg.num_layers}, fp32 parameters, seed 0")
    gen = torch.Generator(device=DEV)
    gen.manual_seed(0)
    t0 = time.perf_counter()
    params = model_lib.init_params(cfg, gen, device=DEV)
    torch.cuda.synchronize()
    n_params = model_lib.count_params(params)
    log(f"  parameters: {n_params / 1e9:.2f} B ({n_params * 4 / 2**30:.1f} GiB) "
        f"drawn in {time.perf_counter() - t0:.1f} s")
    return cfg, params


def serve_trace(requests: int):
    return generate_trace(TrafficConfig(
        num_requests=requests, arrival_rate=0.5, prompt_short=(16, 64),
        prompt_long=(256, 512), output_short=(8, 32), output_long=(64, 128),
        seed=0))


SERVE_KW = dict(bits=4, max_batch=8, page_size=16, max_seq_len=1024)


def phase_serve(cfg, params, requests: int) -> dict:
    log(f"serve: tubgemm_cuda@4 per-row, fused decode, {requests} requests")
    torch.cuda.reset_peak_memory_stats()
    trace = serve_trace(requests)
    kw = dict(backend="tubgemm_cuda", device=DEV, **SERVE_KW)
    sites = 7 * cfg.num_layers + 1

    t0 = time.perf_counter()
    engine = ServingEngine(cfg, params, attention="fused", **kw)
    torch.cuda.synchronize()
    log(f"  engine built (weights profiled for Eq.-1 energy) in "
        f"{time.perf_counter() - t0:.1f} s")

    # ---- main path, tub + fused: counters zeroed just before, read just after
    ug.reset_launches()
    fused_lib.reset_launches()
    t0 = time.perf_counter()
    with activation_scaling("per-row"):
        rep = engine.run(trace, "continuous")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"tub_gemm": ug.LAUNCHES["tub_gemm"],
                "fused_paged_decode": fused_lib.LAUNCHES["fused_paged_decode"]}
    tu_during_tub = ug.LAUNCHES["tu_gemm"]
    log(f"  [tubgemm_cuda@4, fused] requests {rep.requests}/{len(trace)}, "
        f"tokens {rep.tokens}, steps {rep.steps}, decode steps "
        f"{rep.decode_steps}, prefill calls {rep.prefill_calls}, "
        f"tok/step {rep.throughput_tok_per_step:.3f}, p50 {rep.latency_p50:.1f}, "
        f"p99 {rep.latency_p99:.1f}, occupancy {rep.occupancy:.3f}, "
        f"energy {rep.energy_per_token_uj:.2f} uJ/token")
    log(f"  wall {wall:.2f} s, {rep.decode_steps / wall:.2f} decode steps/s "
        f"(prefill included in the wall), {rep.tokens / wall:.2f} tokens/s")
    log(f"  launches: fused {launches['fused_paged_decode']} (= layers x decode "
        f"steps = {cfg.num_layers * rep.decode_steps}), tub "
        f"{launches['tub_gemm']} (= sites x (decode steps + prefill calls) = "
        f"{sites * (rep.decode_steps + rep.prefill_calls)})")
    require(rep.requests == len(trace), "not every request completed")
    require(all(len(rep.request_tokens[r.req_id]) == r.output_len
                for r in trace), "a request's stream has the wrong length")
    require(all(0 <= t < cfg.vocab_size for ts in rep.request_tokens.values()
                for t in ts), "token id out of range")
    require(launches["fused_paged_decode"] > 0 and launches["tub_gemm"] > 0,
            "the main path did not launch its kernels")
    require(launches["fused_paged_decode"] == cfg.num_layers * rep.decode_steps,
            "fused decode launch count != layers x decode steps")
    require(launches["tub_gemm"] == sites * (rep.decode_steps + rep.prefill_calls),
            "tub_gemm launch count != sites x (decode steps + prefill calls)")
    require(tu_during_tub == 0, "tu_gemm launched under tubgemm_cuda")

    # ---- main path, second backend: a short tugemm_cuda run
    short = trace[: min(3, len(trace))]
    tu_engine = ServingEngine(cfg, params, attention="fused",
                              **{**kw, "backend": "tugemm_cuda"})
    tu_digest = _Digest()
    tu_engine.on_gemm_output = tu_digest
    ug.reset_launches()
    fused_lib.reset_launches()
    t0 = time.perf_counter()
    with activation_scaling("per-row"):
        rep_tu = tu_engine.run(short, "continuous")
    torch.cuda.synchronize()
    wall_tu = time.perf_counter() - t0
    launches["tu_gemm"] = ug.LAUNCHES["tu_gemm"]
    require(rep_tu.requests == len(short), "tugemm_cuda run incomplete")
    require(launches["tu_gemm"] == sites * (rep_tu.decode_steps + rep_tu.prefill_calls)
            and launches["tu_gemm"] > 0, "tu_gemm launch count off")
    require(fused_lib.LAUNCHES["fused_paged_decode"]
            == cfg.num_layers * rep_tu.decode_steps, "fused count off (tu run)")
    del tu_engine

    # ---- comparisons (their launches are not counted above)
    tub_digest = _Digest()
    engine.on_gemm_output = tub_digest
    t0 = time.perf_counter()
    with activation_scaling("per-row"):
        rep_tub_short = engine.run(short, "continuous")
    torch.cuda.synchronize()
    wall_tub_short = time.perf_counter() - t0
    engine.on_gemm_output = None
    require(rep_tub_short.request_tokens == rep_tu.request_tokens,
            "tugemm_cuda and tubgemm_cuda sampled different tokens")
    require(len(tu_digest.items) == len(tub_digest.items) > 0
            and tu_digest.items == tub_digest.items,
            "tugemm_cuda integer site outputs differ from tubgemm_cuda's")
    log(f"  [tugemm_cuda@4, {len(short)} requests] {launches['tu_gemm']} "
        f"launches; all {len(tu_digest.items)} integer site outputs equal "
        f"tubgemm_cuda's on the same inputs")
    log(f"  [{len(short)} requests, {rep_tu.decode_steps} decode steps, prefill "
        f"included, host clock, both recording site outputs] wall tugemm_cuda "
        f"{wall_tu:.3f} s (the engine's first run), tubgemm_cuda "
        f"{wall_tub_short:.3f} s")

    # fused vs gather.  Strict on the float path, as in the serving CLI:
    # there the two differ by float32 re-association only.  Under 4-bit
    # per-row execution the next quantizer turns that difference into a
    # whole-code flip wherever an activation sits on a rounding tie, and the
    # flipped code moves the logits by a discrete amount; the divergence
    # probe below counts the flips and sets the logit gap beside the argmax
    # margin.  So the quantized comparison is reported, and gated only on
    # what cannot differ: the schedule and every request's first (prefill)
    # token.
    float_kw = {**kw, "backend": None}
    reps_f = {}
    for attention in ("fused", "gather"):
        eng = ServingEngine(cfg, params, attention=attention, **float_kw)
        t0 = time.perf_counter()
        reps_f[attention] = eng.run(trace, "continuous")
        torch.cuda.synchronize()
        log(f"  [float path, {attention}] tokens {reps_f[attention].tokens}, "
            f"decode steps {reps_f[attention].decode_steps}, wall "
            f"{time.perf_counter() - t0:.2f} s")
        del eng
    same_f = reps_f["fused"].request_tokens == reps_f["gather"].request_tokens
    log(f"  fused vs gather token streams on the full-width trace (float "
        f"path): identical: {same_f}")
    require(same_f, "fused and gather decode sampled different token streams "
                    "on the float path")
    require(reps_f["fused"].events == reps_f["gather"].events,
            "fused and gather float runs scheduled differently")

    gather = ServingEngine(cfg, params, attention="gather",
                           weight_cache=engine.weight_cache, **kw)
    t0 = time.perf_counter()
    with activation_scaling("per-row"):
        rep_g = gather.run(trace, "continuous")
    torch.cuda.synchronize()
    wall_g = time.perf_counter() - t0
    agree = [rep.request_tokens[r.req_id] == rep_g.request_tokens[r.req_id]
             for r in trace]
    prefix = [next((i for i, (x, y) in enumerate(zip(
        rep.request_tokens[r.req_id], rep_g.request_tokens[r.req_id])) if x != y),
        r.output_len) / r.output_len for r in trace]
    log(f"  fused vs gather under tubgemm_cuda@4 per-row (reported): "
        f"{sum(agree)}/{len(trace)} request streams identical, "
        f"mean agreeing prefix {100 * sum(prefix) / len(prefix):.1f} % "
        f"(gather replay wall {wall_g:.2f} s, "
        f"{rep_g.decode_steps / wall_g:.2f} decode steps/s)")
    require(rep.events == rep_g.events and rep.steps == rep_g.steps,
            "fused and gather runs scheduled differently")
    require(all(rep.request_tokens[r.req_id][0] == rep_g.request_tokens[r.req_id][0]
                for r in trace), "prefill tokens differ between the two runs")
    _fused_gather_divergence(cfg, engine, gather)
    del gather

    _decode_step_profile(engine, cfg, {"tub_gemm": "TubPulses",
                                       "fused_paged_decode": "fused_decode_split_kernel"})
    peak = torch.cuda.max_memory_allocated()
    log(f"  peak torch.cuda.max_memory_allocated(): {peak / 2**30:.2f} GiB")
    launches_run = {
        "tub_gemm": f"{len(trace)} requests under tubgemm_cuda",
        "fused_paged_decode": f"{len(trace)} requests under tubgemm_cuda",
        "tu_gemm": f"{len(short)} requests under tugemm_cuda"}
    return {"launches": launches, "launches_run": launches_run}


# ---------------------------------------------------------------------------
# phase 5: quant (cfg.quant_kernel, packed stores, bit-sparsity statistics)
# ---------------------------------------------------------------------------

def _quant_probe() -> None:
    """The smoke config's ``quant_kernel`` forward (fp32, 4 bits) on the
    card (quant_gemm kernel) and on the CPU (plain version), from identical
    parameters and tokens: logits within 1e-4 (float32 attention and norms
    sum in other orders), one launch per dense site on the card, none on
    the CPU."""
    cfg = configs.get_smoke_config("llama3-8b").replace(
        compute_dtype="float32", param_dtype="float32", quant_bits=QUANT_BITS,
        quant_kernel=True)
    gen = torch.Generator(device="cpu")
    gen.manual_seed(0)
    cpu_params = model_lib.init_params(cfg, gen, device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 17)).astype(np.int32))
    out, launched = [], []
    for dev in (DEV, torch.device("cpu")):
        qg_lib.reset_launches()
        logits, _ = model_lib.forward(_clone_tree(cpu_params, dev), cfg,
                                      tokens.to(dev))
        launched.append(qg_lib.LAUNCHES["quant_gemm"])
        out.append(logits.float().cpu())
    d = float((out[0] - out[1]).abs().max())
    want = QUANT_SITES_PER_LAYER * cfg.num_layers
    log(f"  probe (smoke config, quant_kernel@{QUANT_BITS}, fp32): max |card - "
        f"cpu logit| {d:.3e} (tol 1e-4); quant_gemm launches card "
        f"{launched[0]} (want {want}), cpu {launched[1]}")
    require(bool(torch.isfinite(out[0]).all()), "quant probe: logits not finite")
    require(d <= 1e-4, f"quant probe: card and cpu logits differ by {d}")
    require(launched == [want, 0], f"quant probe: launches {launched}")


def _site_weights(cfg, params):
    """(name, (K, N) view) of the 224 dense-site weights, layer by layer."""
    for i in range(cfg.num_layers):
        for (blk, leaf), (k, n) in zip(SITE_LEAVES, site_shapes(cfg)):
            yield f"layers/{i}/{blk}/{leaf}", params["layers"][blk][leaf][i].reshape(k, n)


def _quant_serve(cfg, params, trace) -> tuple[dict, int]:
    """Main path (a): the same trace through ``ServingEngine`` over
    ``cfg.quant_kernel`` at 4 bits, no backend scope, fused decode."""
    qcfg = cfg.replace(quant_bits=QUANT_BITS, quant_kernel=True)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    engine = ServingEngine(qcfg, params, attention="fused", device=DEV, **SERVE_KW)
    torch.cuda.synchronize()
    log(f"  engine built (weights profiled for Eq.-1 energy) in "
        f"{time.perf_counter() - t0:.1f} s")
    prefill_rows: set[int] = set()
    kernel = qg_lib.quant_gemm

    def recording(x, *args, **kw):            # the prefill rows the path runs
        if x.shape[0] != engine.max_batch:
            prefill_rows.add(int(x.shape[0]))
        return kernel(x, *args, **kw)

    qg_lib.quant_gemm = recording
    ug.reset_launches()
    fused_lib.reset_launches()
    qg_lib.reset_launches()
    try:
        t0 = time.perf_counter()
        rep = engine.run(trace, "continuous")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        qg_lib.quant_gemm = kernel
    launches = {"quant_gemm": qg_lib.LAUNCHES["quant_gemm"],
                "fused_paged_decode": fused_lib.LAUNCHES["fused_paged_decode"]}
    calls = rep.decode_steps + rep.prefill_calls
    want = QUANT_SITES_PER_LAYER * cfg.num_layers * calls
    log(f"  [quant_kernel@{QUANT_BITS}, fused] requests {rep.requests}/{len(trace)}, "
        f"tokens {rep.tokens}, steps {rep.steps}, decode steps "
        f"{rep.decode_steps}, prefill calls {rep.prefill_calls} (rows "
        f"{sorted(prefill_rows)}), tok/step {rep.throughput_tok_per_step:.3f}, "
        f"p50 {rep.latency_p50:.1f}, p99 {rep.latency_p99:.1f}, occupancy "
        f"{rep.occupancy:.3f}, energy {rep.energy_per_token_uj:.2f} uJ/token")
    log(f"  wall {wall:.2f} s, {rep.decode_steps / wall:.2f} decode steps/s "
        f"(prefill included in the wall), {rep.tokens / wall:.2f} tokens/s")
    log(f"  launches: quant_gemm {launches['quant_gemm']} (= {QUANT_SITES_PER_LAYER}"
        f" sites x {cfg.num_layers} layers x (decode steps + prefill calls) = "
        f"{want}), fused {launches['fused_paged_decode']} (= layers x decode "
        f"steps = {cfg.num_layers * rep.decode_steps})")
    require(rep.requests == len(trace), "quant run: not every request completed")
    require(all(len(rep.request_tokens[r.req_id]) == r.output_len
                for r in trace), "quant run: a stream has the wrong length")
    require(all(0 <= t < cfg.vocab_size for ts in rep.request_tokens.values()
                for t in ts), "quant run: token id out of range")
    require(launches["quant_gemm"] == want > 0,
            "quant_gemm launch count != 6 sites x layers x model calls")
    require(launches["fused_paged_decode"] == cfg.num_layers * rep.decode_steps,
            "quant run: fused decode launch count != layers x decode steps")
    require(ug.LAUNCHES["tub_gemm"] == ug.LAUNCHES["tu_gemm"] == 0,
            "a unary GEMM kernel launched without a backend scope")
    _decode_step_profile(engine, qcfg, {"quant_gemm": "int_mma_kernel",
                                        "fused_paged_decode": "fused_decode_split_kernel"})
    peak = torch.cuda.max_memory_allocated()
    log(f"  peak torch.cuda.max_memory_allocated(): {peak / 2**30:.2f} GiB")
    # the kernel at the trace's own prefill rows, every distinct site shape
    gen = torch.Generator(device=DEV)
    gen.manual_seed(5)
    errs = {name: 0.0 for name in INT_GEMMS}
    for m in sorted(prefill_rows):
        for (k, n) in sorted(set(site_shapes(cfg))):
            _check_int_gemms(gen, errs, m, k, n, QUANT_BITS, fuses=(True,))
    log(f"  quant_gemm and packed_gemm equal to their plain versions at the "
        f"trace's prefill rows {sorted(prefill_rows)} x the site shapes")
    return launches, rep.decode_steps


def _packed_stores(cfg, params) -> int:
    """Main path (b): every site weight frozen as a 4-bit word store and
    contracted at M = 8 with ``packed_matmul``, each output equal to the
    materialising reference."""
    stores = []
    t0 = time.perf_counter()
    for i in range(cfg.num_layers):
        for (blk, leaf), (k, n) in zip(SITE_LEAVES, site_shapes(cfg)):
            stores.append(packing.pack_quantized(
                params["layers"][blk][leaf][i], bits=QUANT_BITS, k=k, n_out=n))
    torch.cuda.synchronize()
    # the served tree with each stacked site leaf replaced by its stores
    layers = {key: dict(val) if isinstance(val, dict) else val
              for key, val in params["layers"].items()}
    for j, (blk, leaf) in enumerate(SITE_LEAVES):
        layers[blk][leaf] = stores[j::len(SITE_LEAVES)]
    report = packed_store_report({**params, "layers": layers})
    log(f"  {len(stores)} site weights packed at {QUANT_BITS} bits in "
        f"{time.perf_counter() - t0:.1f} s: packed sites {report.packed_sites}/"
        f"{report.total_sites}, {report.packed_float32_bytes / 2**30:.2f} GiB fp32 "
        f"-> {report.packed_stored_bytes / 2**30:.3f} GiB stored "
        f"({report.packed_reduction:.2f}x); whole tree "
        f"{report.float32_bytes / 2**30:.2f} -> {report.stored_bytes / 2**30:.2f} "
        f"GiB ({report.reduction:.2f}x)")
    require(report.packed_sites == len(stores) == 7 * cfg.num_layers,
            "packed store report miscounted the sites")
    gen = torch.Generator(device=DEV)
    gen.manual_seed(6)
    xs = {k: _full_codes(gen, (8, k), 8) for k in {s.k for s in stores}}
    pg_lib.reset_launches()
    outs = [pg_lib.packed_matmul(xs[s.k], s) for s in stores]
    torch.cuda.synchronize()
    launched = pg_lib.LAUNCHES["packed_gemm"]
    for s, out in zip(stores, outs):
        want = ref_lib.packed_gemm_ref(xs[s.k], s.packed, s.scale.reshape(1, -1),
                                       bits=s.bits, k=s.k, fuse_dequant=True)
        require(torch.equal(out, want), "packed_matmul differs from the "
                                        "materialising reference")
    log(f"  packed_matmul at M=8 over the {len(stores)} stores: {launched} "
        f"launches, every output equal to the materialising reference")
    require(launched == len(stores), "packed_gemm launches != stores")
    return launched


def _site_sparsity(cfg, params) -> tuple[int, float]:
    """Main path (c): the Eq.-1 statistics of every site weight's per-tensor
    4-bit codes from the block_stats kernel, within 1e-6 of
    ``profile_tensor`` on the same weight.  Returns the launches and the
    host wall of the ``bit_sparsity_stats`` calls alone (each ends in its
    one device-to-host read)."""
    bs_lib.reset_launches()
    worst = 0.0
    n_sites = 0
    wall = 0.0
    for name, w in _site_weights(cfg, params):
        codes = quantize(w, bits=QUANT_BITS, per_channel=False).values
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        word, blk = ops_lib.bit_sparsity_stats(codes, bits=QUANT_BITS)
        wall += time.perf_counter() - t0
        prof = profile_tensor(w, QUANT_BITS)
        d = max(abs(word - prof.word), abs(blk - prof.bit_blockmax))
        worst = max(worst, d)
        n_sites += 1
        require(d <= 1e-6, f"bit_sparsity_stats of {name} off profile_tensor by {d}")
    launched = bs_lib.LAUNCHES["block_stats"]
    log(f"  bit_sparsity_stats over the {n_sites} site weights: {launched} "
        f"block_stats launches, wall {wall:.4f} s ({wall / n_sites * 1e3:.3f} ms "
        f"a call), max |kernel stats - profile_tensor| {worst:.2e} (tol 1e-6)")
    require(launched == n_sites, "block_stats launches != site weights")
    return launched, wall


def phase_quant(cfg, params, requests: int) -> dict:
    _quant_probe()
    trace = serve_trace(requests)
    launches, _ = _quant_serve(cfg, params, trace)
    launches_run = {
        "quant_gemm": f"{len(trace)} requests under cfg.quant_kernel@{QUANT_BITS}"}
    launches["packed_gemm"] = _packed_stores(cfg, params)
    launches_run["packed_gemm"] = (f"packed_matmul at M=8 over the "
                                   f"{7 * cfg.num_layers} site stores")
    gc.collect()
    launches["block_stats"], wall = _site_sparsity(cfg, params)
    launches_run["block_stats"] = (f"bit_sparsity_stats over the "
                                   f"{7 * cfg.num_layers} site weights, wall "
                                   f"{wall:.4f} s")
    del launches["fused_paged_decode"]       # the serve phase's count stands
    return {"launches": launches, "launches_run": launches_run}


# ---------------------------------------------------------------------------
# phase 6: plan (per-site plan, kernel rewrite, packed serving)
# ---------------------------------------------------------------------------

PLAN_KW = dict(batch=8, designs=("tugemm", "tubgemm", "bgemm"),
               bits_candidates=(2, 4, 8), unit_n=128, num_units=64)
TEACHER_STEPS = 2


def _kernel_plan(plan):
    """The plan with every design that has a ``*_cuda`` mirror rewritten to
    it (tugemm -> tugemm_cuda, tubgemm -> tubgemm_cuda; bgemm stays)."""
    mirror = {sim: name for name, sim in backends.KERNEL_SIBLINGS.items()}
    return dataclasses.replace(plan, sites=tuple(
        dataclasses.replace(e, design=mirror.get(e.design, e.design))
        for e in plan.sites))


def _teacher_forced_sites(cfg, engines, *, steps: int = TEACHER_STEPS,
                          prompt_len: int = 32) -> list[list]:
    """Every dense site's int32 output, per engine, over one seeded prefill
    of a prompt per slot and ``steps`` decode steps, each engine under its
    own scope (per-row scales) and fed the first engine's tokens."""
    dev, b = engines[0].device, engines[0].max_batch
    rng = np.random.default_rng(5)
    prompts = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (b, prompt_len)).astype(np.int32)).to(dev)
    active = torch.ones((b,), dtype=torch.bool, device=dev)
    fed: list[torch.Tensor] = []
    recorded = []
    for eng in engines:
        outs: list = []
        eng.on_gemm_output = lambda site, out, _o=outs: _o.append((site, out))
        cache = eng.new_cache()
        with eng._scope(), activation_scaling("per-row"):
            logits, k_l, v_l = eng._prefill(prompts)
            for i in range(b):
                cache.allocate(i, prompt_len + steps + 1)
                cache.write_prefill(i, k_l[:, i], v_l[:, i])
            d_bt = torch.from_numpy(np.stack(
                [cache.block_table_row(i) for i in range(b)])).to(dev)
            tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
            del logits, k_l, v_l
            for step in range(steps):
                if len(fed) <= step:
                    fed.append(tok)
                lengths = torch.full((b,), prompt_len + step, dtype=torch.int32,
                                     device=dev)
                lg, _, _, _ = eng._decode(eng._exec_params, fed[step],
                                          cache.k_pool, cache.v_pool, d_bt,
                                          lengths, active)
                tok = torch.argmax(lg[:, 0], dim=-1).to(torch.int32)[:, None]
        eng.on_gemm_output = None
        recorded.append(outs)
        del cache
    return recorded


def _sites_equal(a: list, b: list) -> bool:
    return len(a) == len(b) > 0 and all(
        s == t and torch.equal(x, y) for (s, x), (t, y) in zip(a, b))


def _plan_serve(cfg, params, plan, trace, packed: bool, weight_cache=None):
    """One full-width serve of ``trace`` under ``plan`` (per-row scales,
    fused decode), counters zeroed just before and read just after."""
    t0 = time.perf_counter()
    engine = ServingEngine(cfg, params, plan=plan, packed=packed,
                           attention="fused", device=DEV,
                           weight_cache=weight_cache, **SERVE_KW)
    torch.cuda.synchronize()
    built = time.perf_counter() - t0
    ug.reset_launches()
    fused_lib.reset_launches()
    t0 = time.perf_counter()
    with activation_scaling("per-row"):
        rep = engine.run(trace, "continuous")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"tub_gemm": ug.LAUNCHES["tub_gemm"],
                "tu_gemm": ug.LAUNCHES["tu_gemm"],
                "fused_paged_decode": fused_lib.LAUNCHES["fused_paged_decode"]}
    calls = rep.decode_steps + rep.prefill_calls
    want = {name: calls * sum(e.count for e in plan.sites if e.design == design)
            for name, design in (("tub_gemm", "tubgemm_cuda"),
                                 ("tu_gemm", "tugemm_cuda"))}
    tag = "packed" if packed else "unpacked"
    log(f"  [{tag}] engine built in {built:.1f} s; requests "
        f"{rep.requests}/{len(trace)}, tokens {rep.tokens}, decode steps "
        f"{rep.decode_steps}, prefill calls {rep.prefill_calls}; wall "
        f"{wall:.2f} s, {rep.decode_steps / wall:.2f} decode steps/s, "
        f"{rep.tokens / wall:.2f} tokens/s (prefill included in the wall)")
    log(f"  [{tag}] launches: tub_gemm {launches['tub_gemm']} (plan: "
        f"{want['tub_gemm']}), tu_gemm {launches['tu_gemm']} (plan: "
        f"{want['tu_gemm']}), fused {launches['fused_paged_decode']} (= layers "
        f"x decode steps = {cfg.num_layers * rep.decode_steps})")
    require(rep.requests == len(trace), f"{tag} plan run: not every request "
                                        f"completed")
    require(all(len(rep.request_tokens[r.req_id]) == r.output_len
                for r in trace), f"{tag} plan run: a stream has the wrong length")
    require(launches["tub_gemm"] == want["tub_gemm"] > 0,
            f"{tag} plan run: tub_gemm launches != tubgemm_cuda sites x calls")
    require(launches["tu_gemm"] == want["tu_gemm"],
            f"{tag} plan run: tu_gemm launches != tugemm_cuda sites x calls")
    require(launches["fused_paged_decode"] == cfg.num_layers * rep.decode_steps,
            f"{tag} plan run: fused decode launches != layers x decode steps")
    return engine, rep, wall, launches


def phase_plan(cfg, params, requests: int) -> dict:
    from repro_torch.analysis import plan_lint
    from repro_torch.eval import planner
    log(f"plan: build_plan at batch {PLAN_KW['batch']}, designs "
        f"{PLAN_KW['designs']}, bits {PLAN_KW['bits_candidates']}, "
        f"{PLAN_KW['num_units']} units of {PLAN_KW['unit_n']}x{PLAN_KW['unit_n']}")
    torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()
    # ---- 1. plan the model
    t0 = time.perf_counter()
    sites = planner.discover_sites(cfg, params, batch=PLAN_KW["batch"])
    plan = planner.build_plan(cfg, params, sites=sites, **PLAN_KW)
    torch.cuda.synchronize()
    plan_wall = time.perf_counter() - t0
    names = [s.name for s in sites]
    for e in plan.sites:
        log(f"  {e.pattern:>20s} x{e.count:<3d} {e.engine_label:>11s} "
            f"bit_blockmax {e.bit_blockmax:.4f} rel_mse {e.rel_mse:.5f} "
            f"dyn {e.dyn_energy_uj:.4f} uJ{' (guard relaxed)' if e.guard_relaxed else ''}")
    totals = plan.metadata()["totals"]
    best = totals["uniform_best"]
    planned = totals["planned"]["dyn_energy_uj"]
    best_e = totals["uniform"][best]["dyn_energy_uj"] if best else math.inf
    log(f"  planned {planned:.4f} uJ per decode step against best uniform "
        f"{best} {best_e:.4f} uJ ({100 * (1 - planned / best_e):.2f} % less, "
        f"difference {planned - best_e:.3e} uJ); "
        f"planning wall {plan_wall:.2f} s (discovery on the meta device, "
        f"profiling and guard statistics on the card); peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    found = plan_lint.lint_plan(plan, site_names=names)
    require(not [f for f in found if f.severity == "error"],
            f"plan lint: {[f.render() for f in found]}")
    # the two totals sum the same site energies in other orders: as the
    # reference's planner tests, allow their rounding (1e-9 relative)
    require(best is not None and planned <= best_e * (1 + 1e-9),
            "planned energy above the best uniform plan's")
    require(backends.BackendPlan.from_json(plan.to_json()) == plan,
            "the plan does not survive its JSON round trip")
    t0 = time.perf_counter()
    by_name = {s.name: s for s in sites}
    for e in plan.sites:
        cyc = planner.measure_site_cycles(by_name[e.pattern], e,
                                          unit_n=PLAN_KW["unit_n"],
                                          num_units=PLAN_KW["num_units"])
        require(cyc["dyn_floor"] - 0.5 <= cyc["measured"] <= cyc["wc"] + 0.5,
                f"measured cycles of {e.pattern} outside [floor, wc]: {cyc}")
    log(f"  measured cycles within [floor, wc] at all {len(plan.sites)} sites "
        f"({time.perf_counter() - t0:.2f} s); lint: {len(found)} findings")
    # ---- 2. rewrite the plan for the kernels, through a file
    kplan = _kernel_plan(plan)
    with tempfile.TemporaryDirectory() as tmp:
        kplan = backends.load_plan(kplan.save(os.path.join(tmp, "plan.json")))
    require(not plan_lint.lint_plan(kplan, site_names=names),
            "the kernel plan does not lint clean")
    log(f"  kernel plan: {', '.join(f'{d}@{b}' for d, b in kplan.distinct_backends())}"
        f", saved, loaded back and lint-clean")
    # ---- 3. serve the trace, unpacked and packed
    trace = serve_trace(requests)
    unpacked, rep_u, wall_u, _ = _plan_serve(cfg, params, kplan, trace, False)
    packed, rep_p, wall_p, launches = _plan_serve(cfg, params, kplan, trace, True)
    store = packed_store_report(packed._exec_params)
    log(f"  packed store: {store.packed_sites}/{store.total_sites} sites, "
        f"{store.stored_bytes / 2**20:.1f} MiB stored against "
        f"{store.float32_bytes / 2**20:.1f} MiB fp32 ({store.reduction:.2f}x; "
        f"packed sites alone {store.packed_stored_bytes / 2**20:.1f} against "
        f"{store.packed_float32_bytes / 2**20:.1f} MiB, "
        f"{store.packed_reduction:.2f}x)")
    require(rep_u.request_tokens == rep_p.request_tokens
            and rep_u.events == rep_p.events,
            "packed and unpacked plan runs sampled different streams")
    log(f"  packed vs unpacked token streams: identical over "
        f"{len(trace)} requests; trace wall unpacked {wall_u:.2f} s, packed "
        f"{wall_p:.2f} s")
    # ---- 3b and 4. every site's int32 output, teacher-forced: packed and
    # the simulated designs against the unpacked kernel plan
    sim = ServingEngine(cfg, params, plan=plan, attention="fused", device=DEV,
                        weight_cache=unpacked.weight_cache, **SERVE_KW)
    t0 = time.perf_counter()
    ref, got_p, got_s = _teacher_forced_sites(cfg, [unpacked, packed, sim])
    require(_sites_equal(ref, got_p), "packed and unpacked plan runs differ "
                                      "in a site's int32 output")
    require(_sites_equal(ref, got_s), "the simulated plan and the kernel plan "
                                      "differ in a site's int32 output")
    log(f"  teacher-forced prefill + {TEACHER_STEPS} decode steps: all "
        f"{len(ref)} site int32 outputs equal, packed vs unpacked and "
        f"simulated plan vs kernel plan ({time.perf_counter() - t0:.1f} s)")
    del ref, got_p, got_s, sim, unpacked
    gc.collect()
    kernels = {"tub_gemm": "TubPulses",
               "fused_paged_decode": "fused_decode_split_kernel"}
    if launches["tu_gemm"]:
        kernels["tu_gemm"] = "TuPulses"
    log("  packed plan run, steady decode step:")
    _decode_step_profile(packed, cfg, kernels)
    log(f"  peak torch.cuda.max_memory_allocated(): "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; plan phase "
        f"wall {time.perf_counter() - t_phase:.1f} s")
    # the serve phase's counts stay on the kernels line (its main path)
    return {"launches": {}, "launches_run": {}}


# ---------------------------------------------------------------------------
# phase 7: ugemm (uGEMM's multiplier and the rate-coded stochastic family)
# ---------------------------------------------------------------------------

#: a decode site's contraction (8 rows into w_up) and a prefill one (27 rows)
UGEMM_SHAPES = ((8, *UP_SHAPE), (27, 4096, 4096))
UGEMM_BITS = 4
#: (rng, stream length) of the stochastic checks, at UGEMM_BITS
STOCHASTIC_CASES = (("sobol", 16), ("sobol", 64), ("lfsr", 16))
UGEMM_SPECS = ("ugemm", "ugemm_stochastic:16")
UGEMM_REQUESTS = 3
UGEMM_PLAN_KW = dict(batch=8, designs=("tugemm", "tubgemm", "bgemm",
                                       "ugemm_stochastic"),
                     bits_candidates=(4, 8), stream_lens=(16, 32, 64),
                     unit_n=128, num_units=64)


def _wall(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _ugemm_card_vs_cpu() -> None:
    """uGEMM's and the stochastic engine's counts on the card against the
    CPU, bit for bit, on seeded codes at the phase's shapes."""
    gen = torch.Generator().manual_seed(20)
    for m, k, n in UGEMM_SHAPES:
        for bits in (2, 4, 8):
            v = 2 ** (bits - 1) - 1
            a = torch.randint(-v, v + 1, (m, k), generator=gen, dtype=torch.int8)
            b = torch.randint(-v, v + 1, (k, n), generator=gen, dtype=torch.int8)
            t0 = time.perf_counter()
            want = gemm_sims.ugemm_exact(a, b, bits=bits)
            cpu_s = time.perf_counter() - t0
            ad, bd = a.to(DEV), b.to(DEV)
            gemm_sims.ugemm_exact(ad, bd, bits=bits)           # warm
            got, card_s = _wall(lambda: gemm_sims.ugemm_exact(ad, bd, bits=bits))
            (stream, cycles), _ = _wall(lambda: gemm_sims.ugemm_stream(ad, bd, bits))
            require(torch.equal(got.cpu(), want) and torch.equal(stream.cpu(), want),
                    f"ugemm_exact/ugemm_stream at ({m},{k},{n}) {bits} bits: "
                    f"card != CPU")
            require(cycles == 2 ** bits, "ugemm_stream cycles != 2^bits")
            log(f"  ugemm_exact ({m},{k},{n}) {bits} bits: card == CPU and "
                f"ugemm_stream == it, bit for bit; card {card_s * 1e3:.2f} ms "
                f"(one call, host wall with a synchronise), CPU "
                f"{cpu_s * 1e3:.1f} ms; {len(gemm_sims._unified_groups(bits).thresholds)}"
                f" threshold products of the weight size")
            if bits != UGEMM_BITS:
                continue
            for kind, L in STOCHASTIC_CASES:
                want_s = sgemm.stochastic_gemm(a, b, bits, stream_len=L,
                                               rng_kind=kind)
                got_s, s_card = _wall(lambda: sgemm.stochastic_gemm(
                    ad, bd, bits, stream_len=L, rng_kind=kind))
                require(torch.equal(got_s.cpu(), want_s),
                        f"stochastic_gemm {kind} L={L} at ({m},{k},{n}): "
                        f"card != CPU")
                rel = gemm_sims.rel_rmse(got_s, got)
                bound = ranges.stochastic_error_bound(bits, L)
                log(f"  stochastic_gemm {kind} L={L} ({m},{k},{n}) {bits} bits: "
                    f"card == CPU; rel-RMSE vs ugemm_exact {rel:.5f} (bound "
                    f"expected {bound.expected:.5f}, tail {bound.tail:.5f}); "
                    f"card {s_card * 1e3:.2f} ms")
                require(rel <= bound.tail, f"stochastic {kind} L={L} rel-RMSE "
                                           f"{rel} above the tail bound")


def _slim_cpu_tree(tree):
    """The leaves ``validate_backend_numerics`` reads, on the CPU: every
    matrix cut to its first 2,048 elements (the tiles come from the first
    512 of each), every vector whole, in the same tree layout."""
    if isinstance(tree, dict):
        return {k: _slim_cpu_tree(v) for k, v in tree.items()}
    if tree.ndim >= 2:
        return tree.reshape(-1)[:2048].reshape(1, -1).cpu()
    return tree.cpu()


def _direct(spec: str):
    backend = backends.resolve(spec, bits=UGEMM_BITS)
    if backend.stream_len:
        return lambda a, w: sgemm.stochastic_gemm(
            a, w, UGEMM_BITS, stream_len=backend.stream_len)
    return lambda a, w: gemm_sims.ugemm_exact(a, w, bits=UGEMM_BITS)


#: columns of the site the plain forms below recompute
PLAIN_SITE_COLS = 256


def _plain_site(spec: str, a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """A site's decoded output by the reference's plain forms, none of them
    the threshold-grouping engine: uGEMM's LUT gather ``LUT[|a|, |b|] *
    sgn(a) sgn(b)``; the stochastic engine's materialized Sobol bitstreams,
    contracted cycle by cycle.  Both sum as int64 over K on the device."""
    backend = backends.resolve(spec, bits=UGEMM_BITS)
    a, w = a.to(torch.int64), w.to(torch.int64)
    if backend.stream_len:
        L = backend.stream_len
        sa, sb = (sgemm._bitstreams(x, UGEMM_BITS, L, dim=d, seed=0,
                                    rng_kind="sobol").to(torch.int64)
                  for x, d in ((a, 0), (w, 1)))
        counts = sum((sa[t][:, :, None] * sb[t][None]).sum(dim=1)
                     for t in range(L))
    else:
        L = 2 ** UGEMM_BITS
        ta, tb = gemm_sims._unified_tables(UGEMM_BITS)
        lut = (ta.to(torch.int64) @ tb.to(torch.int64).T).to(a.device)
        sgn = torch.sign(a)[:, :, None] * torch.sign(w)[None]
        counts = (lut[torch.abs(a)[:, :, None], torch.abs(w)[None]]
                  * sgn).sum(dim=1)
    v = 2 ** (UGEMM_BITS - 1) - 1
    return counts.to(torch.float32) * float(np.float32(v * v / L))


def _ugemm_site_outputs(engine, cfg, spec: str) -> None:
    """One decode step (8 slots at context 300, seeded tokens and pools)
    under ``spec``: every site's output (``on_output``) equals a direct
    call on the codes it contracted (the ``on_output`` plumbing); layer 0's
    q/k/v also the CPU's; and layer 0's first up-projection-wide site, on
    its first ``PLAIN_SITE_COLS`` columns, the plain form of
    :func:`_plain_site`."""
    base = backends.resolve(spec, bits=UGEMM_BITS)
    seen: list = []

    def recording(a, w, bits):
        seen.append((a, w))
        return base.spec.exact_fn(a, w, bits)

    rec = dataclasses.replace(
        base, spec=dataclasses.replace(base.spec, exact_fn=recording))
    outs: list = []
    dev, b = engine.device, engine.max_batch
    cache = engine.new_cache()
    for i in range(b):
        cache.allocate(i, 400)
    d_bt = torch.from_numpy(np.stack([cache.block_table_row(i)
                                      for i in range(b)])).to(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(4)
    cache.k_pool.normal_(generator=gen)
    cache.v_pool.normal_(generator=gen)
    tokens = torch.randint(0, cfg.vocab_size, (b, 1), generator=gen, device=dev,
                           dtype=torch.int32)
    lengths = torch.full((b,), 300, dtype=torch.int32, device=dev)
    active = torch.ones((b,), dtype=torch.bool, device=dev)
    with backends.use_backend(rec, weight_cache=engine.weight_cache,
                              on_output=lambda s, o: outs.append((s, o))), \
            activation_scaling("per-row"):
        engine._decode(engine._exec_params, tokens, cache.k_pool, cache.v_pool,
                       d_bt, lengths, active)
    sites = 7 * cfg.num_layers + 1
    require(len(outs) == len(seen) == sites,
            f"{spec}: {len(outs)} site outputs for {sites} sites")
    direct = _direct(spec)
    require(all(torch.equal(out, direct(a, w))
                for (_, out), (a, w) in zip(outs, seen)),
            f"{spec}: a site's output differs from a direct call on its codes")
    for (site, out), (a, w) in list(zip(outs, seen))[:3]:
        require(torch.equal(out.cpu(), direct(a.cpu(), w.cpu())),
                f"{spec}: {site} on the card != on the CPU")
    site, out, a, w = next((site, out, a, w) for (site, out), (a, w)
                           in zip(outs, seen)
                           if w.shape[1] == cfg.d_ff)
    cols = slice(0, PLAIN_SITE_COLS)
    plain = _plain_site(spec, a, w[:, cols])
    require(torch.equal(out[:, cols], plain),
            f"{spec}: {site}'s output != the plain form on its first "
            f"{PLAIN_SITE_COLS} columns (max |diff| "
            f"{(out[:, cols] - plain).abs().max().item():.3g})")
    log(f"  [{spec}] one decode step: all {sites} site outputs equal a direct "
        f"call on the same codes; layer 0's wq/wk/wv equal the CPU's; "
        f"{site} ({tuple(a.shape)} x {tuple(w.shape)}) equals the plain "
        f"{'bitstream' if base.stream_len else 'LUT-gather'} form on its "
        f"first {PLAIN_SITE_COLS} columns")
    del cache, seen, outs


def _ugemm_serve(cfg, params, spec: str, trace, weight_cache=None):
    t0 = time.perf_counter()
    engine = ServingEngine(cfg, params, backend=spec, attention="fused",
                           device=DEV, weight_cache=weight_cache, **SERVE_KW)
    torch.cuda.synchronize()
    built = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    ug.reset_launches()
    fused_lib.reset_launches()
    t0 = time.perf_counter()
    with activation_scaling("per-row"):
        rep = engine.run(trace, "continuous")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    fused = fused_lib.LAUNCHES["fused_paged_decode"]
    log(f"  [{spec}@{UGEMM_BITS}, {len(trace)} requests, prompts "
        f"{[r.prompt_len for r in trace]}, outputs {[r.output_len for r in trace]}] "
        f"engine built in {built:.1f} s; tokens {rep.tokens}, decode steps "
        f"{rep.decode_steps}, prefill calls {rep.prefill_calls}; wall "
        f"{wall:.2f} s, {rep.decode_steps / wall:.3f} decode steps/s, "
        f"{rep.tokens / wall:.3f} tokens/s (prefill included); energy "
        f"{rep.energy_per_token_uj:.2f} uJ/token; peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    require(rep.requests == len(trace), f"{spec}: not every request completed")
    require(all(len(rep.request_tokens[r.req_id]) == r.output_len
                for r in trace), f"{spec}: a stream has the wrong length")
    require(fused == cfg.num_layers * rep.decode_steps > 0,
            f"{spec}: fused decode launches {fused} != layers x decode steps")
    require(ug.LAUNCHES["tub_gemm"] == ug.LAUNCHES["tu_gemm"] == 0,
            f"{spec}: a unary kernel launched")
    return engine, wall


def phase_ugemm(cfg, params, requests: int) -> dict:
    from repro_torch.analysis import plan_lint
    from repro_torch.eval import planner
    t_phase = time.perf_counter()
    log("ugemm: card against CPU")
    _ugemm_card_vs_cpu()
    # ---- serve the first requests under uGEMM and the rate-coded family
    trace = serve_trace(max(requests, UGEMM_REQUESTS))[:UGEMM_REQUESTS]
    slim = _slim_cpu_tree(params)
    cache = None
    walls = {}
    for spec in UGEMM_SPECS:
        if spec != UGEMM_SPECS[0] and 2 * walls[UGEMM_SPECS[0]] > 150:
            trace = trace[:1]
            log(f"  the {UGEMM_SPECS[0]} run took {walls[UGEMM_SPECS[0]]:.1f} s: "
                f"{spec} serves the first request alone")
        engine, walls[spec] = _ugemm_serve(cfg, params, spec, trace, cache)
        cache = engine.weight_cache
        backend = backends.resolve(spec, bits=UGEMM_BITS)
        oracle = "ugemm" if backend.stream_len else "bgemm"
        rel = validate_backend_numerics(params, backend, oracle=oracle)
        require(math.isfinite(rel), f"{spec}: numerics not finite")
        if oracle == "bgemm":
            rel_cpu = validate_backend_numerics(slim, backend, oracle=oracle)
            # float64 means reduce in another order on the card
            require(abs(rel - rel_cpu) <= 1e-12 * max(rel, rel_cpu),
                    f"{spec}: numerics on the card {rel} != CPU {rel_cpu}")
            log(f"  [{spec}] numerics vs binary oracle: relRMSE {rel:.6e} "
                f"(CPU {rel_cpu:.6e})")
        else:
            log(f"  [{spec}] numerics vs exact-uGEMM oracle: relRMSE {rel:.6e}")
        _ugemm_site_outputs(engine, cfg, spec)
        log(f"  [{spec}] steady decode step:")
        _decode_step_profile(engine, cfg, {
            "fused_paged_decode": "fused_decode_split_kernel"})
        del engine
        gc.collect()
        torch.cuda.empty_cache()
    del cache
    gc.collect()
    torch.cuda.empty_cache()
    # ---- plan with rate-coded candidates
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sites = planner.discover_sites(cfg, params, batch=UGEMM_PLAN_KW["batch"])
    plan = planner.build_plan(cfg, params, sites=sites, **UGEMM_PLAN_KW)
    torch.cuda.synchronize()
    plan_wall = time.perf_counter() - t0
    for e in plan.sites:
        log(f"  {e.pattern:>20s} x{e.count:<3d} {e.engine_label:>22s} "
            f"rel_mse {e.rel_mse:.5f} dyn {e.dyn_energy_uj:.4f} uJ"
            f"{' (guard relaxed)' if e.guard_relaxed else ''}")
    meta = plan.metadata()
    totals = meta["totals"]
    best = totals["uniform_best"]
    planned = totals["planned"]["dyn_energy_uj"]
    best_e = totals["uniform"][best]["dyn_energy_uj"] if best else math.inf
    stochastic = sum(e.stream_len > 0 for e in plan.sites)
    pruned = sum(r["design"] == "ugemm_stochastic" for r in meta["range_pruned"])
    log(f"  plan with ugemm_stochastic candidates: {stochastic} of "
        f"{len(plan.sites)} sites chose a stochastic entry; {pruned} "
        f"stochastic candidates pruned by the analytic bound or the envelope; "
        f"planned {planned:.4f} uJ against best uniform {best} {best_e:.4f} "
        f"uJ; planning wall {plan_wall:.2f} s; peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    found = plan_lint.lint_plan(plan, site_names=[s.name for s in sites])
    require(not [f for f in found if f.severity == "error"],
            f"stochastic plan lint: {[f.render() for f in found]}")
    require(best is not None and planned <= best_e * (1 + 1e-9),
            "stochastic plan: planned energy above the best uniform plan's")
    back = backends.BackendPlan.from_json(plan.to_json())
    require(back == plan and [e.stream_len for e in back.sites]
            == [e.stream_len for e in plan.sites],
            "the stochastic plan does not survive its JSON round trip")
    log(f"  lint: {len(found)} findings; JSON round trip keeps every "
        f"stream_len; ugemm phase wall {time.perf_counter() - t_phase:.1f} s")
    return {"launches": {}, "launches_run": {}}


# ---------------------------------------------------------------------------
# phase 10: grid (PE-array grids, grid plans, the sweet-spot report)
# ---------------------------------------------------------------------------

GRID = (2, 2)
#: a decode step's contraction (8 rows) into every distinct dense-site shape,
#: and a prefill one (27 rows): at 2x2 the shards are (8, 2048, 512),
#: (8, 2048, 2048), (8, 2048, 7168), (8, 7168, 2048) and (27, 2048, 2048),
#: every shard shape the grid-served trace gives tub_gemm at these rows
GRID_SHAPES = (*((8, k, n) for k, n in sorted(set(SITE_SHAPES))),
               (27, 4096, 4096))
#: uGEMM's grid is not on the served path: a decode and a prefill shape
UGEMM_GRID_SHAPES = ((8, *UP_SHAPE), (27, 4096, 4096))
GRID_CASES = (("tubgemm_cuda", (2, 4, 8)), ("tugemm_cuda", (2, 4, 8)),
              ("ugemm", (4,)))
GRID_PLAN_KW = dict(PLAN_KW, grid=GRID)


def _exact_product(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The plain integer product on the card: float64 holds every partial
    sum of int8 codes over these K exactly (< 2^53)."""
    return torch.matmul(a.to(torch.float64), w.to(torch.float64)).to(torch.int32)


def _grid_vs_unit() -> None:
    gen = torch.Generator(device=DEV)
    gen.manual_seed(21)
    for spec, widths in GRID_CASES:
        for bits in widths:
            unit = backends.resolve(spec, bits=bits)
            grid = backends.as_grid(unit, *GRID)
            for m, k, n in UGEMM_GRID_SHAPES if spec == "ugemm" else GRID_SHAPES:
                a, w = _codes(gen, (m, k), bits), _codes(gen, (k, n), bits)
                codes = grid.shard_codes(w)
                ug.reset_launches()
                got = grid.execute(a, codes)
                torch.cuda.synchronize()
                shard_launches = dict(ug.LAUNCHES)
                want = unit.execute(a, w)
                require(torch.equal(got, want),
                        f"{spec}@{bits} {GRID} grid != single unit at {(m, k, n)}")
                if spec == "ugemm":
                    plain = gemm_sims.ugemm_exact(a.cpu(), w.cpu(), bits=bits)
                    require(torch.equal(got.cpu(), plain),
                            f"ugemm@{bits} grid on the card != CPU at {(m, k, n)}")
                else:
                    require(torch.equal(got, _exact_product(a, w)),
                            f"{spec}@{bits} grid != the integer product")
                kernel = {"tubgemm_cuda": "tub_gemm",
                          "tugemm_cuda": "tu_gemm"}.get(spec)
                if kernel:
                    require(shard_launches[kernel] == GRID[0] * GRID[1],
                            f"{spec}: {shard_launches[kernel]} launches for "
                            f"{GRID[0] * GRID[1]} shards")
                t_grid = _time_ms(lambda: grid.execute(a, codes), reps=10)
                t_unit = _time_ms(lambda: unit.execute(a, w), reps=10)
                line = (f"  [{spec}@{bits} {(m, k, n)}] grid == unit == plain; "
                        f"grid {t_grid:.4f} ms, unit {t_unit:.4f} ms")
                if kernel:
                    sub = codes.shards[(0, 0)]
                    a0 = a[:, :sub.shape[0]].contiguous()
                    fn = ug.tub_gemm if kernel == "tub_gemm" else ug.tu_gemm
                    t_shard = _time_ms(lambda: fn(a0, sub, bits=bits), reps=10)
                    line += (f"; {shard_launches[kernel]} {kernel} launches, "
                             f"one shard {(m, *sub.shape)} {t_shard:.4f} ms")
                log(line)


def _rewrite_mirrors(gplan):
    """The grid plan with every design that has a ``*_cuda`` mirror
    rewritten to it, in the aggregate and in every shard."""
    return dataclasses.replace(
        gplan, aggregate=_kernel_plan(gplan.aggregate),
        shards=tuple((key, _kernel_plan(p)) for key, p in gplan.shards))


def _grid_serve(cfg, params, trace, **kw):
    """One full-width serve of ``trace`` (per-row, fused decode), counters
    zeroed just before and read just after."""
    torch.cuda.reset_peak_memory_stats()
    engine = ServingEngine(cfg, params, attention="fused", device=DEV, **kw,
                           **SERVE_KW)
    ug.reset_launches()
    fused_lib.reset_launches()
    t0 = time.perf_counter()
    with activation_scaling("per-row"):
        rep = engine.run(trace, "continuous")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"tub_gemm": ug.LAUNCHES["tub_gemm"],
                "tu_gemm": ug.LAUNCHES["tu_gemm"],
                "fused_paged_decode": fused_lib.LAUNCHES["fused_paged_decode"]}
    tag = "grid" if engine.grid else "flat"
    log(f"  [{tag}] requests {rep.requests}/{len(trace)}, tokens {rep.tokens}, "
        f"decode steps {rep.decode_steps}, prefill calls {rep.prefill_calls}; "
        f"wall {wall:.2f} s, {rep.decode_steps / wall:.2f} decode steps/s, "
        f"{rep.tokens / wall:.2f} tokens/s (prefill included); "
        f"{rep.energy_per_token_uj:.2f} uJ/token (Eq. 1, "
        f"{type(engine.energy.step_cost(8)).__name__}); launches {launches}; "
        f"peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    require(rep.requests == len(trace), f"{tag} run: not every request completed")
    require(launches["fused_paged_decode"] == cfg.num_layers * rep.decode_steps,
            f"{tag} run: fused decode launches != layers x decode steps")
    return engine, rep, wall, launches


def phase_grid(cfg, params, requests: int) -> dict:
    from repro_torch.analysis import plan_lint
    from repro_torch.eval import planner
    from repro_torch.eval import report as report_lib
    from repro_torch.eval import sweetspot
    t_phase = time.perf_counter()
    # ---- 1. grid vs unit vs plain, per-shard launches and times
    log(f"grid: as_grid(b, {GRID[0]}, {GRID[1]}).execute against the single unit")
    _grid_vs_unit()
    # ---- 2. plan the grid
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sites = planner.discover_sites(cfg, params, batch=GRID_PLAN_KW["batch"])
    gplan = planner.build_grid_plan(cfg, params, sites=sites, **GRID_PLAN_KW)
    torch.cuda.synchronize()
    plan_wall = time.perf_counter() - t0
    meta = gplan.metadata()
    agg = meta["totals"]["aggregate"]
    best = agg["uniform_best"]
    best_e = agg["uniform"][best]["dyn_energy_uj"] if best else math.inf
    planned = agg["planned"]["dyn_energy_uj"]
    hetero_e = agg["planned_heterogeneous"]["dyn_energy_uj"]
    log(f"  build_grid_plan {GRID[0]}x{GRID[1]}: wall {plan_wall:.2f} s (profile "
        f"of every shard's slice on the card), peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    for e in gplan.aggregate.sites:
        per_shard = ", ".join(
            f"{key}:{p.assignment_for(e.pattern).engine_label}"
            for key, p in gplan.shards)
        log(f"  {e.pattern:>20s} x{e.count:<3d} aggregate {e.engine_label:>11s} "
            f"dyn {e.dyn_energy_uj:.4f} uJ; shards {per_shard}")
    log(f"  heterogeneous sites: {list(gplan.heterogeneous_sites()) or 'none'}; "
        f"aggregate planned {planned:.4f} uJ, per-shard heterogeneous "
        f"{hetero_e:.4f} uJ, best uniform {best} {best_e:.4f} uJ "
        f"({100 * (1 - planned / best_e):.2f} % less)")
    names = [s.name for s in sites]
    found = plan_lint.lint_plan(gplan, site_names=names)
    require(not found, f"grid plan lint: {[f.render() for f in found]}")
    require(best is not None and planned <= best_e * (1 + 1e-9),
            "grid plan: planned energy above the best uniform grid plan's")
    require(backends.GridPlan.from_json(gplan.to_json()) == gplan,
            "the grid plan does not survive its JSON round trip")
    t0 = time.perf_counter()
    by_name = {s.name: s for s in sites}
    for e in gplan.aggregate.sites:
        cyc = planner.measure_grid_site_cycles(
            by_name[e.pattern], e, grid=GRID, unit_n=GRID_PLAN_KW["unit_n"],
            num_units=GRID_PLAN_KW["num_units"])
        for coord, c in cyc.items():
            require(c["dyn_floor"] - 0.5 <= c["measured"] <= c["wc"] + 0.5,
                    f"measured cycles of {e.pattern} [{coord}] outside "
                    f"[floor, wc]: {c}")
    log(f"  lint clean; measured cycles within [floor, wc] on every shard of "
        f"all {len(gplan.aggregate.sites)} sites "
        f"({time.perf_counter() - t0:.2f} s)")
    # ---- 3. serve the trace under the grid plan and its aggregate flat plan
    kplan = _rewrite_mirrors(gplan)
    with tempfile.TemporaryDirectory() as tmp:
        kplan = backends.load_plan(kplan.save(os.path.join(tmp, "grid.json")))
    trace = serve_trace(requests)
    flat, rep_f, wall_f, launch_f = _grid_serve(cfg, params, trace,
                                                plan=kplan.aggregate)
    del flat
    gc.collect()
    torch.cuda.empty_cache()
    engine, rep_g, wall_g, launch_g = _grid_serve(cfg, params, trace, plan=kplan,
                                                  grid=GRID)
    # ---- 3b. every site's int32 output, teacher-forced: the grid plan
    # against its aggregate flat plan, bit for bit
    flat = ServingEngine(cfg, params, plan=kplan.aggregate, attention="fused",
                         device=DEV, **SERVE_KW)
    t0 = time.perf_counter()
    ref, got = _teacher_forced_sites(cfg, [flat, engine])
    require(_sites_equal(ref, got), "the grid plan and its aggregate flat plan "
                                    "differ in a site's int32 output")
    log(f"  teacher-forced prefill + {TEACHER_STEPS} decode steps: all "
        f"{len(ref)} site int32 outputs equal, grid plan vs its aggregate flat "
        f"plan ({time.perf_counter() - t0:.1f} s)")
    del ref, got, flat
    gc.collect()
    torch.cuda.empty_cache()
    cache_gib = sum(wq.values.nbytes() for _, wq in engine.weight_cache.values())
    log(f"  grid engine's code cache: {len(engine.weight_cache)} weights in "
        f"shard blocks, {cache_gib / 2**30:.2f} GiB")
    require(rep_g.request_tokens == rep_f.request_tokens
            and rep_g.events == rep_f.events,
            "the grid plan and its aggregate flat plan sampled different streams")
    for name in ("tub_gemm", "tu_gemm"):
        require(launch_g[name] == GRID[0] * GRID[1] * launch_f[name],
                f"{name}: {launch_g[name]} launches on the grid, "
                f"{launch_f[name]} flat (want x{GRID[0] * GRID[1]})")
    require(launch_g["tub_gemm"] + launch_g["tu_gemm"] > 0,
            "the grid run launched no unary kernel")
    log(f"  grid vs flat token streams: identical over {len(trace)} requests; "
        f"trace wall grid {wall_g:.2f} s against flat {wall_f:.2f} s "
        f"({wall_g / wall_f:.2f}x)")
    kernels = {"fused_paged_decode": "fused_decode_split_kernel"}
    if launch_g["tub_gemm"]:
        kernels["tub_gemm"] = "TubPulses"
    if launch_g["tu_gemm"]:
        kernels["tu_gemm"] = "TuPulses"
    log("  grid plan run, steady decode step:")
    _decode_step_profile(engine, cfg, kernels)
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    # ---- 4. the sweet-spot report, its cross-check on the card
    ug.reset_launches()
    t0 = time.perf_counter()
    report = sweetspot.build_report(device=DEV)
    torch.cuda.synchronize()
    cross = report.kernel_crosscheck
    log(f"  sweet-spot report: {len(report.points)} points, "
        f"{len(report.winners)} winners, {len(report.crossovers)} crossovers, "
        f"grid fidelity {report.grid_fidelity}; kernel_crosscheck "
        f"{len(cross)} rows on the card, launches tub {ug.LAUNCHES['tub_gemm']} "
        f"tu {ug.LAUNCHES['tu_gemm']} ({time.perf_counter() - t0:.2f} s)")
    require(cross and all(r["output_ok"] and r["cycles_ok"] for r in cross),
            f"kernel_crosscheck on the card: {cross}")
    require(ug.LAUNCHES["tub_gemm"] >= 3 and ug.LAUNCHES["tu_gemm"] >= 3,
            "kernel_crosscheck did not launch the kernels")
    with tempfile.TemporaryDirectory() as tmp:
        json_path, md_path = report_lib.write(report, tmp)
        require(os.path.getsize(json_path) > 0 and os.path.getsize(md_path) > 0,
                "the sweet-spot report was not written")
    for c in report.crossovers:
        log(f"    crossover {c.metric} {c.bits}b: {c.from_design} at n="
            f"{c.n_below} -> {c.to_design} from n={c.n_at}")
    energy = [w for w in report.winners if w.metric == "energy_nj"]
    log("    energy_nj winners: " + ", ".join(
        f"{w.bits}b/{w.n}:{w.design}({w.margin:.2f}x)" for w in energy))
    log(f"  grid phase wall {time.perf_counter() - t_phase:.1f} s")
    return {"launches": {}, "launches_run": {}}


# ---------------------------------------------------------------------------
# phase 8: train
# ---------------------------------------------------------------------------

def _tree_leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _tree_leaves(tree[k], prefix + (k,))
    else:
        yield "/".join(prefix), tree


def _train_probe() -> None:
    """One training step of the smoke config in fp32 on the card (flash
    kernels) and on the CPU (plain versions), from identical parameters and
    batch: loss within 1e-5 relative, every gradient leaf within 1e-4 x its
    largest entry.  fp32 matmuls run without TF32 (set in main)."""
    cfg = configs.get_smoke_config("llama3-8b").replace(
        compute_dtype="float32", param_dtype="float32")
    gen = torch.Generator(device="cpu")
    gen.manual_seed(0)
    cpu_params = model_lib.init_params(cfg, gen, device="cpu")
    rng = np.random.default_rng(0)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 100))
                                 .astype(np.int32)) for k in ("tokens", "targets")}
    out = []
    for dev in (DEV, torch.device("cpu")):
        tree = steps_lib._trainable(_clone_tree(cpu_params, dev))
        b = {k: v.to(dev) for k, v in batch.items()}
        flash_lib.reset_launches()
        loss, _, grads = steps_lib.loss_and_grads(cfg, tree, b)
        launched = dict(flash_lib.LAUNCHES)
        state = steps_lib.TrainState(params=tree, opt=adamw_init(tree, AdamWConfig()),
                                     step=torch.zeros((), dtype=torch.int32))
        _, metrics = steps_lib.make_train_step(cfg, AdamWConfig())(state, b)
        out.append((float(loss), {k: g.cpu() for k, g in _tree_leaves(grads)},
                    float(metrics["loss"]), float(metrics["grad_norm"]), launched))
    (loss_g, grads_g, step_loss_g, gn_g, launched_g), \
        (loss_c, grads_c, step_loss_c, gn_c, launched_c) = out
    rel = abs(loss_g - loss_c) / abs(loss_c)
    worst = max((float((grads_g[k] - grads_c[k]).abs().max())
                 / max(float(grads_c[k].abs().max()), 1e-30), k) for k in grads_c)
    log(f"  probe (smoke config, fp32, 2 x 100 tokens): loss card {loss_g:.7f} "
        f"cpu {loss_c:.7f} (rel {rel:.2e}, tol 1e-5); worst gradient leaf "
        f"{worst[1]} max|card-cpu| / max|cpu| {worst[0]:.2e} (tol 1e-4); train "
        f"step loss rel {abs(step_loss_g - step_loss_c) / abs(step_loss_c):.2e}, "
        f"grad_norm {gn_g:.6f} vs {gn_c:.6f}; card launches {launched_g}")
    require(rel <= 1e-5, f"train probe: loss card {loss_g} vs cpu {loss_c}")
    require(worst[0] <= 1e-4, f"train probe: gradient {worst[1]} off by {worst[0]}")
    require(abs(step_loss_g - step_loss_c) <= 1e-5 * abs(step_loss_c)
            and abs(gn_g - gn_c) <= 1e-4 * abs(gn_c), "train probe: step metrics")
    require(launched_g == {n: cfg.num_layers for n in FLASH},
            f"train probe: flash launches {launched_g} != {cfg.num_layers} each")
    require(not any(launched_c.values()), "the CPU run launched a kernel")


def _clone_tree(tree, dev):
    if isinstance(tree, dict):
        return {k: _clone_tree(v, dev) for k, v in tree.items()}
    return tree.detach().to(dev, copy=True)


def _train_step_profile(cfg, state, loop) -> None:
    """One more step of the slice, traced with torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    step_fn = steps_lib.make_train_step(
        cfg, AdamWConfig(lr=loop.lr),
        cosine_schedule(loop.lr, loop.warmup, loop.steps))
    batch_np = next(iter(SyntheticLM(DataConfig(
        batch_size=loop.batch, seq_len=loop.seq + 1, vocab_size=cfg.vocab_size,
        seed=loop.seed + 1))))
    batch = {k: torch.from_numpy(v).to(DEV) for k, v in batch_np.items()}
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, _ = step_fn(state, batch)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = _device_rows(prof)
    busy_us = sum(r[0] for r in rows)
    require(busy_us > 0, "the profiler reported no device time for a training "
                         "step: device busy share not measured")
    log(f"  traced step: device busy {busy_us / 1e3:.2f} ms of {wall_us / 1e3:.2f} "
        f"ms under the profiler = {100 * busy_us / wall_us:.1f} % busy, "
        f"{100 - 100 * busy_us / wall_us:.1f} % idle")
    for t, key, count in sorted(rows, reverse=True)[:12]:
        log(f"    {t / 1e3:9.3f} ms  x{count:<6d} {key[:90]}")
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        t, n = (sum(r[i] for r in rows if f"{name}_" in r[1]) for i in (0, 2))
        log(f"    {name}: {t / 1e3:.3f} ms of the step ({n} launches, "
            f"{100 * t / busy_us:.1f} % of device busy)")


def phase_train(layers: int, steps: int) -> dict:
    _train_probe()
    cfg = configs.get_config("llama3-8b").replace(
        num_layers=layers, param_dtype="float32", compute_dtype="bfloat16",
        remat=True)
    loop = train_lib.TrainLoopConfig(steps=steps, log_every=1, batch=4, seq=2048,
                                     lr=3e-4, warmup=2, seed=0)
    log(f"train: llama3-8b widths d_model={cfg.d_model} heads={cfg.num_heads} "
        f"kv_heads={cfg.num_kv_heads} head_dim={cfg.resolved_head_dim} "
        f"d_ff={cfg.d_ff} vocab={cfg.vocab_size}, layers={cfg.num_layers} (cut "
        f"from 32: fp32 parameters + fp32 AdamW moments at 32 layers need "
        f"~128 GB), fp32 parameters, bf16 compute, remat, batch "
        f"{loop.batch} x {loop.seq}, AdamW defaults, cosine lr {loop.lr:g} "
        f"warmup {loop.warmup}, {steps} steps, seed 0")
    torch.cuda.reset_peak_memory_stats()
    flash_lib.reset_launches()
    t0 = time.perf_counter()
    state, history, _ = train_lib.train(cfg, loop, device=DEV)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(flash_lib.LAUNCHES)
    losses = [m["loss"] for _, m in history]
    secs = [m["step_s"] for _, m in history]
    n_params = model_lib.count_params(state.params)
    peak = torch.cuda.max_memory_allocated()
    med = statistics.median(secs[1:]) if len(secs) > 1 else secs[0]
    tokens = loop.batch * loop.seq
    log(f"  parameters {n_params / 1e9:.3f} B; losses "
        + " ".join(f"{x:.4f}" for x in losses))
    log(f"  step wall (host clock, a synchronise per step): first {secs[0]:.3f} s, "
        f"median of the rest {med:.3f} s (min {min(secs[1:] or secs):.3f}, max "
        f"{max(secs[1:] or secs):.3f}) = {tokens / med:.0f} tokens/s; train() "
        f"wall {wall:.1f} s incl. init; peak max_memory_allocated "
        f"{peak / 2**30:.2f} GiB")
    log(f"  launches: flash_fwd {launches['flash_fwd']} (want 2 x layers x steps "
        f"= {2 * layers * steps}), flash_bwd_dq {launches['flash_bwd_dq']}, "
        f"flash_bwd_dkv {launches['flash_bwd_dkv']} (want layers x steps = "
        f"{layers * steps})")
    require(len(losses) == steps, "train() did not log every step")
    require(all(math.isfinite(x) for x in losses), "a training loss is not finite")
    require(losses[-1] < losses[0], f"loss did not fall: {losses[0]} -> {losses[-1]}")
    require(launches["flash_fwd"] == 2 * layers * steps,
            "flash_fwd launches != 2 x layers x steps (remat recomputes)")
    require(launches["flash_bwd_dq"] == launches["flash_bwd_dkv"] == layers * steps,
            "flash backward launches != layers x steps")
    _train_step_profile(cfg, state, loop)
    run = (f"{steps} training steps of llama3-8b, {layers} layers, batch "
           f"{loop.batch} x {loop.seq}, bf16 compute, remat")
    return {"launches": launches, "launches_run": {n: run for n in FLASH},
            "step_s": med, "peak_gib": peak / 2**30}


# ---------------------------------------------------------------------------
# phase 11: families (the attention-transformer families at full width)
# ---------------------------------------------------------------------------

FAMILY_IDS = ("gemma-7b", "phi3-mini-3.8b", "internlm2-1.8b", "chameleon-34b",
              "musicgen-medium", "phi3.5-moe-42b-a6.6b", "deepseek-v3-671b")
MOE_ID, MLA_ID, AUDIO_ID = "phi3.5-moe-42b-a6.6b", "deepseek-v3-671b", "musicgen-medium"
SERVED_DENSE = ("gemma-7b", "phi3-mini-3.8b", "internlm2-1.8b", "chameleon-34b")
FAMILY_TOL = 1e-4          # card vs CPU, the same port code, fp32
SELF_TOL = 1e-3            # cached vs full-sequence logits at full width, fp32
CHECK_STEPS = 3            # decode steps held against the full-sequence pass
# full-width cuts (widths kept, depth cut): phi3.5-moe is ~1.30 B parameters
# a layer, deepseek-v3 11.3 B of routed experts in ONE layer (fp32: 53 GB
# with embedding and head)
MOE_SERVE = dict(layers=4, batch=4, prompt=64, tokens=16)
MOE_TRAIN = dict(layers=2, batch=2, seq=1024, steps=3)
MLA_RUN = dict(layers=1, batch=2, prompt=32)
DENSE_LAYERS = 2
FAMILY_REQUESTS = 3
AUDIO_RUN = dict(batch=2, seq=128)


def narrow_family(arch: str):
    """``arch`` at narrow widths that keep its head dims (MLA: its q/k nope
    and rope and its V), 2 layers, 4 experts top-2 with the published
    capacity factor, fp32."""
    full = configs.get_config(arch)
    cfg = configs.get_smoke_config(arch).replace(
        num_layers=2, param_dtype="float32", compute_dtype="float32")
    if full.attention == "mla":
        cfg = cfg.replace(num_heads=2, num_kv_heads=2, mla=dataclasses.replace(
            full.mla, q_lora_rank=64, kv_lora_rank=32))
    else:
        cfg = cfg.replace(
            d_model=2 * full.resolved_head_dim, num_heads=2, head_dim=full.head_dim,
            num_kv_heads=1 if full.num_kv_heads < full.num_heads else 2)
    if full.is_moe:
        cfg = cfg.replace(moe=dataclasses.replace(full.moe, num_experts=4, top_k=2,
                                                  d_ff_expert=64))
    return cfg


def _no_drop(cfg):
    """``cfg`` with every expert's capacity at T: no token is dropped.  A
    forward over T tokens and a prefill over fewer route different tokens
    past a bounded capacity, so the cached-vs-full comparison of a decode
    step is made at this capacity (the same weights)."""
    m = cfg.moe
    return cfg.replace(moe=dataclasses.replace(
        m, capacity_factor=m.num_experts / m.top_k))


def expected_sites(cfg, cached: bool = False) -> list[str]:
    """The dense sites one forward records, in order: MLA's ``w_uk`` /
    ``w_uv`` only without a cache, the MoE's shared expert only (router and
    routed experts stay float), ``lm_head`` unless tied."""
    if cfg.attention == "mla":
        attn = ["w_dq", "w_uq", "w_dkv", "w_kr"] + ([] if cached else ["w_uk", "w_uv"])
    else:
        attn = ["wq", "wk", "wv"]
    gated = ("w_up", "w_gate", "w_down") if cfg.activation in ("swiglu", "geglu") \
        else ("w_up", "w_down")
    if cfg.is_moe:
        ffn = [f"moe/shared/{n}" for n in gated] if cfg.moe.num_shared_experts else []
    else:
        ffn = [f"mlp/{n}" for n in gated]
    layer = [f"layers/attn/{n}" for n in attn + ["wo"]] + [f"layers/{n}" for n in ffn]
    return layer * cfg.num_layers + ([] if cfg.tie_embeddings else ["lm_head"])


def _greedy(logits) -> torch.Tensor:
    return torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)


def _cached_logits(params, cfg, prompt=None, *, embeds=None, steps=CHECK_STEPS,
                   caches=None):
    """Prefill then ``steps`` greedy decode steps over a float32 cache (new,
    or ``caches``, which the model writes in place): (prefill logits, [last
    prompt position, then each step's logits], generated tokens (B, steps))."""
    inp = embeds if embeds is not None else prompt
    b, s = inp.shape[:2]
    if caches is None:
        caches = model_lib.init_caches(cfg, b, s + steps, dtype=torch.float32,
                                       device=inp.device)
    pre, caches = model_lib.prefill(params, cfg, prompt, caches=caches,
                                    embeds=embeds)
    rows, toks, tok = [pre[:, -1]], [], _greedy(pre)
    for i in range(steps):
        step, caches = model_lib.decode_step(params, cfg, tok, caches=caches,
                                             cache_pos=s + i)
        toks.append(tok)
        rows.append(step[:, 0])
        tok = _greedy(step)
    return pre, torch.stack(rows, dim=1), torch.cat(toks, dim=1) if toks else None


def _decode_vs_forward(params, cfg, prompt) -> float:
    """max |cached - full| over the last prompt position and CHECK_STEPS
    decode steps, the full pass over the prompt and the fed tokens."""
    _, rows, toks = _cached_logits(params, cfg, prompt)
    s = prompt.shape[1]
    full, _ = model_lib.forward(params, cfg, torch.cat([prompt, toks], dim=1))
    return float((rows - full[:, s - 1:]).abs().max())


def _sites_run(fn, cfg, spec: str = "tubgemm_cuda"):
    """Run ``fn`` under ``spec``@4 with per-row scaling: (sites recorded,
    tub_gemm launches, flash_fwd launches, result)."""
    ug.reset_launches()
    flash_lib.reset_launches()
    with backends.use_backend(spec, bits=4) as ex, activation_scaling("per-row"):
        out = fn()
    torch.cuda.synchronize()
    return ([c.site for c in ex.calls], ug.LAUNCHES["tub_gemm"],
            flash_lib.LAUNCHES["flash_fwd"], out)


def _init_family(cfg, what: str):
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=DEV)
    gen.manual_seed(0)
    t0 = time.perf_counter()
    params = model_lib.init_params(cfg, gen, device=DEV)
    torch.cuda.synchronize()
    n = model_lib.count_params(params)
    log(f"  {what}: {cfg.arch_id} d_model={cfg.d_model} heads={cfg.num_heads} "
        f"kv_heads={cfg.num_kv_heads} head_dim={cfg.resolved_head_dim} d_ff="
        f"{cfg.d_ff} vocab={cfg.vocab_size}"
        + (f" experts={cfg.moe.num_experts} top_k={cfg.moe.top_k} d_ff_expert="
           f"{cfg.moe.d_ff_expert} shared={cfg.moe.num_shared_experts}"
           if cfg.is_moe else "")
        + (f" mla={dataclasses.asdict(cfg.mla)}" if cfg.attention == "mla" else "")
        + f", {cfg.num_layers} layers, {n / 1e9:.2f} B parameters "
        f"({n * 4 / 2**30:.1f} GiB fp32) drawn in {time.perf_counter() - t0:.1f} s")
    return params


def _family_card_vs_cpu(arch: str) -> None:
    """Narrow ``arch`` on the card (kernels) and the CPU (plain versions),
    identical parameters and inputs: forward, prefill and CHECK_STEPS
    decode logits within FAMILY_TOL, greedy tokens equal; for MoE also the
    routing indices, the loss and every gradient."""
    cfg = narrow_family(arch)
    gen = torch.Generator(device="cpu")
    gen.manual_seed(0)
    cpu_params = model_lib.init_params(cfg, gen, device="cpu")
    card_params = _clone_tree(cpu_params, DEV)
    rng = np.random.default_rng(0)
    b, s = 2, 40
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32))
    embeds = (torch.from_numpy(rng.standard_normal((b, s, cfg.d_model)).astype(np.float32))
              if cfg.frontend_stub else None)

    def run(params, dev):
        kw = ({"embeds": embeds.to(dev)} if embeds is not None
              else {"tokens": tokens.to(dev)})
        fwd, aux = model_lib.forward(params, cfg, **kw)
        pre, rows, toks = _cached_logits(params, cfg, kw.get("tokens"),
                                         embeds=kw.get("embeds"))
        return [x.cpu() for x in (fwd, pre, rows)], toks.cpu(), float(aux)

    flash_lib.reset_launches()
    with torch.no_grad():
        card, card_toks, card_aux = run(card_params, DEV)
        torch.cuda.synchronize()
        fwd_launches = flash_lib.LAUNCHES["flash_fwd"]
        cpu, cpu_toks, cpu_aux = run(cpu_params, torch.device("cpu"))
    errs = [float((a - c).abs().max()) for a, c in zip(card, cpu)]
    d_qk = (cfg.mla.nope_head_dim + cfg.mla.rope_head_dim if cfg.attention == "mla"
            else cfg.resolved_head_dim)
    line = (f"  {arch} narrow (d_model {cfg.d_model}, q/k head dim {d_qk}"
            + (f", V {cfg.mla.v_head_dim}" if cfg.attention == "mla" else "")
            + f"): card vs CPU max|dlogit| forward {errs[0]:.2e}, prefill "
            f"{errs[1]:.2e}, {CHECK_STEPS} decode steps {errs[2]:.2e} (tol "
            f"{FAMILY_TOL:g}); greedy tokens equal {torch.equal(card_toks, cpu_toks)}; "
            f"flash_fwd launches {fwd_launches}")
    require(max(errs) <= FAMILY_TOL, f"{arch} narrow: card vs CPU logits {errs}")
    require(torch.equal(card_toks, cpu_toks), f"{arch} narrow: greedy tokens differ")
    require(fwd_launches == cfg.num_layers, f"{arch}: flash_fwd launches {fwd_launches}")
    require(abs(card_aux - cpu_aux) <= FAMILY_TOL, f"{arch}: aux {card_aux} vs {cpu_aux}")
    if cfg.is_moe:
        from repro_torch.models import moe as moe_lib
        x = torch.from_numpy(rng.standard_normal((b * s, cfg.d_model)).astype(np.float32))
        router = cpu_params["layers"]["moe"]["router"][0]
        idx_cpu = moe_lib._routing(router, x, cfg)[0]
        idx_card = moe_lib._routing(router.to(DEV), x.to(DEV), cfg)[0].cpu()
        require(torch.equal(idx_card, idx_cpu), f"{arch}: routing indices differ")
        out = []
        for dev in (DEV, torch.device("cpu")):
            tree = steps_lib._trainable(_clone_tree(cpu_params, dev))
            batch = {"tokens": tokens[:, :-1].to(dev), "targets": tokens[:, 1:].to(dev)}
            flash_lib.reset_launches()
            loss, parts, grads = steps_lib.loss_and_grads(cfg, tree, batch)
            out.append((float(loss), float(parts["aux"]),
                        {k: g.cpu() for k, g in _tree_leaves(grads)},
                        dict(flash_lib.LAUNCHES)))
        (loss_g, aux_g, grads_g, launched), (loss_c, aux_c, grads_c, _) = out
        worst = max((float((grads_g[k] - grads_c[k]).abs().max()), k) for k in grads_c)
        line += (f"; routing indices equal; loss card {loss_g:.7f} cpu {loss_c:.7f} "
                 f"(aux {aux_g:.5f}), worst gradient {worst[1]} {worst[0]:.2e}; "
                 f"backward launches {launched}")
        require(abs(loss_g - loss_c) <= FAMILY_TOL and worst[0] <= FAMILY_TOL,
                f"{arch} narrow: loss {loss_g} vs {loss_c}, gradient {worst}")
        require(aux_g > 0.0, f"{arch}: the MoE aux loss did not reach loss_fn")
        require(launched == {n: cfg.num_layers for n in FLASH},
                f"{arch}: flash launches in the gradient run {launched}")
    log(line)


def _step_profile(step, what: str, kernels: dict[str, str] | None = None,
                  top: int = 6) -> dict:
    """Host wall of ``step`` (10 runs, a synchronise each) and a trace of 3;
    ``kernels`` maps each hand-written kernel of the path to a piece of its
    traced name, whose device time and launches a step are printed."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(2):
        step()
    torch.cuda.synchronize()
    times = []
    for _ in range(10):
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(3):
            step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = _device_rows(prof)
    busy_us = sum(r[0] for r in rows)
    require(busy_us > 0, f"{what}: the profiler reported no device time")
    med = statistics.median(times)
    log(f"  {what}: median {med:.2f} ms host wall with a synchronise (min "
        f"{min(times):.2f}, max {max(times):.2f}); traced 3: device busy "
        f"{busy_us / 3e3:.2f} ms of {wall_us / 3e3:.2f} ms = "
        f"{100 * busy_us / wall_us:.1f} % busy, {sum(r[2] for r in rows) // 3} "
        f"device operations each")
    for t, key, count in sorted(rows, reverse=True)[:top]:
        log(f"    {t / 3e3:8.3f} ms  x{count // 3:<5d} {key[:90]}")
    for name, piece in (kernels or {}).items():
        t, n = (sum(r[i] for r in rows if piece in r[1]) for i in (0, 2))
        log(f"    {name}: {t / 3e3:.3f} ms/step ({n // 3} launches a step, "
            f"{100 * t / busy_us:.1f} % of device busy)")
    return {"wall_ms": med, "busy_ms": busy_us / 3e3}


@torch.no_grad()
def _moe_serve() -> dict:
    """phi3.5-moe at its published widths, MOE_SERVE['layers'] deep: the
    one-shot serve mode's functions under tubgemm_cuda@4 per-row, then the
    cached paths held against the full-sequence forward."""
    from repro_torch.launch import serve as serve_lib
    from repro_torch.models import moe as moe_lib
    cfg = configs.get_config(MOE_ID).replace(
        num_layers=MOE_SERVE["layers"], param_dtype="float32", compute_dtype="float32")
    params = _init_family(cfg, "MoE serve")
    rng = np.random.default_rng(0)
    b, s, new = MOE_SERVE["batch"], MOE_SERVE["prompt"], MOE_SERVE["tokens"]
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)).to(DEV)
    t0 = time.perf_counter()
    toks = serve_lib.generate(cfg, params, prompt, new)
    torch.cuda.synchronize()
    log(f"  generate (float path): {tuple(toks.shape)} tokens in "
        f"{time.perf_counter() - t0:.2f} s")
    ug.reset_launches()
    rel = serve_lib.validate_backend_numerics(params, "tubgemm_cuda", 4)
    tiles = ug.LAUNCHES["tub_gemm"]      # run_backend_execution repeats this check
    require(rel == 0.0, f"tubgemm_cuda numerics on phi3.5-moe weights: {rel}")
    t0 = time.perf_counter()
    rec, stats = serve_lib.build_workload(cfg, params, b, s, 4)
    names = [c.name for c in rec.calls]
    require({"layers/moe/router", "layers/moe/w_gate", "layers/moe/w_up",
             "layers/moe/w_down", "lm_head"} <= set(names),
            f"build_workload priced {names}")
    expert = next(c for c in rec.calls if c.name == "layers/moe/w_up")
    cost = backends.resolve("tubgemm", bits=4).price(rec.calls, unit_n=128, num_units=64)
    log(f"  build_workload: {len(names)} matrices priced in "
        f"{time.perf_counter() - t0:.2f} s, the expert stacks as the reference "
        f"reshapes them (w_up ({expert.k}, {expert.n_out})); tubGEMM@4 "
        f"{cost.dyn_energy_uj:.2f} uJ a decode step")
    ug.reset_launches()
    with activation_scaling("per-row"):
        res = serve_lib.run_backend_execution(
            cfg, params, prompt, backends.resolve("tubgemm_cuda", bits=4), new,
            unit_n=128, num_units=64, stats=stats)
    sites = expected_sites(cfg)
    launched = ug.LAUNCHES["tub_gemm"]
    log(f"  run_backend_execution tubgemm_cuda@4 per-row: {res['sites']} sites, "
        f"wall {res['wall_s']:.2f} s, drift {res['drift']:.3e}, top-1 agreement "
        f"{res['top1_agreement']:.3f}, tub_gemm launches {launched} (prefill, "
        f"{new - 1} decode steps and the prefill-logit pass: "
        f"{len(sites)} x {new + 1} = {len(sites) * (new + 1)}, + {tiles} numerics tiles)")
    require(res["sites"] == len(set(sites)), f"sites executed {res['sites']}")
    require(launched == len(sites) * (new + 1) + tiles,
            f"run_backend_execution: {launched} tub_gemm launches, want "
            f"{len(sites)} x {new + 1} + {tiles}")
    # the cached paths against the full-sequence pass (float path)
    fwd, aux = model_lib.forward(params, cfg, prompt)
    pre, _, _ = _cached_logits(params, cfg, prompt, steps=0)
    err_pre = float((pre - fwd).abs().max())
    err_dec = _decode_vs_forward(params, _no_drop(cfg), prompt)
    err_cap = _decode_vs_forward(params, cfg, prompt)
    log(f"  float path: prefill vs forward over the prompt (same T, so the "
        f"same capacity) max|dlogit| {err_pre:.3e}; prefill + {CHECK_STEPS} "
        f"decode steps vs forward, capacity at T {err_dec:.3e} (tol {SELF_TOL:g}); "
        f"at the published capacity {err_cap:.3e} (reported: tokens past "
        f"capacity differ between T = {b * s} and T = {b * (s + CHECK_STEPS)}); "
        f"aux {float(aux):.5f}")
    require(err_pre <= SELF_TOL and err_dec <= SELF_TOL,
            f"phi3.5-moe cached vs full: {err_pre}, {err_dec}")
    # one decode step: every site launches tub_gemm once, lm_head included
    caches = model_lib.init_caches(cfg, b, s + 1, dtype=torch.float32, device=DEV)
    _, caches = model_lib.prefill(params, cfg, prompt, caches=caches)
    tok = toks[:, :1].contiguous()

    def step():
        return model_lib.decode_step(params, cfg, tok, caches=caches, cache_pos=s)

    got, tub, _, _ = _sites_run(step, cfg)
    require(got == sites and tub == len(sites),
            f"decode step under tubgemm_cuda: sites {got}, {tub} launches")
    with backends.use_backend("tubgemm_cuda", bits=4), activation_scaling("per-row"):
        prof = _step_profile(step, f"decode step (B={b}, context {s}, "
                                   f"tubgemm_cuda@4 per-row)")
        h = torch.randn((b, 1, cfg.d_model), device=DEV)
        moe0 = model_lib.blocks_lib.layer_slice(params["layers"], 0)["moe"]
        moe = _step_profile(lambda: moe_lib.moe_fwd(moe0, h, cfg),
                            f"one layer's moe_fwd at the decode step's {b} tokens "
                            f"({cfg.moe.num_experts} experts in turn)")
    share = cfg.num_layers * moe["wall_ms"] / prof["wall_ms"]
    log(f"  the per-expert loop: {cfg.num_layers} x {moe['wall_ms']:.2f} ms = "
        f"{100 * share:.1f} % of the decode step's host wall; "
        f"{cfg.num_layers * moe['busy_ms']:.2f} of {prof['busy_ms']:.2f} ms device busy")
    peak = torch.cuda.max_memory_allocated()
    log(f"  peak max_memory_allocated {peak / 2**30:.2f} GiB")
    return {"tub_gemm": {"run_backend_execution": launched, "decode step": tub},
            "decode_ms": prof["wall_ms"],
            "decode_busy_ms": prof["busy_ms"], "peak_gib": peak / 2**30}


def _moe_train() -> dict:
    cfg = configs.get_config(MOE_ID).replace(
        num_layers=MOE_TRAIN["layers"], param_dtype="float32",
        compute_dtype="bfloat16", remat=True)
    steps = MOE_TRAIN["steps"]
    loop = train_lib.TrainLoopConfig(steps=steps, log_every=1, batch=MOE_TRAIN["batch"],
                                     seq=MOE_TRAIN["seq"], lr=3e-4, warmup=1, seed=0)
    torch.cuda.reset_peak_memory_stats()
    flash_lib.reset_launches()
    t0 = time.perf_counter()
    state, history, _ = train_lib.train(cfg, loop, device=DEV)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(flash_lib.LAUNCHES)
    losses = [m["loss"] for _, m in history]
    auxes = [m["aux"] for _, m in history]
    peak = torch.cuda.max_memory_allocated()
    gen = torch.Generator(device=DEV)
    gen.manual_seed(loop.seed)
    init = model_lib.init_params(cfg, gen, device=DEV)
    still = [k for (k, a), (_, w) in zip(_tree_leaves(init), _tree_leaves(state.params))
             if torch.equal(a, w)]
    layers = cfg.num_layers
    log(f"  MoE train: {cfg.arch_id} published widths, {layers} layers, fp32 "
        f"parameters, bf16 compute, remat, batch {loop.batch} x {loop.seq}: losses "
        + " ".join(f"{x:.4f}" for x in losses) + " (aux "
        + " ".join(f"{x:.4f}" for x in auxes) + f"), step walls "
        + " ".join(f"{m['step_s']:.2f}" for _, m in history)
        + f" s, train() {wall:.1f} s incl. init, peak {peak / 2**30:.2f} GiB; "
        f"launches {launches}; leaves unmoved {still or 'none'}")
    require(len(losses) == steps and all(math.isfinite(x) for x in losses),
            f"MoE train losses {losses}")
    require(all(a > 0 for a in auxes), "MoE train: aux loss is 0")
    require(not still, f"MoE train: parameters did not move: {still}")
    require(launches["flash_fwd"] == 2 * layers * steps
            and launches["flash_bwd_dq"] == launches["flash_bwd_dkv"] == layers * steps,
            f"MoE train: flash launches {launches}")
    del state, init
    return {"launches": launches, "step_s": history[-1][1]["step_s"],
            "peak_gib": peak / 2**30}


@torch.no_grad()
def _mla_full() -> dict:
    """deepseek-v3 at its published widths, MLA_RUN['layers'] deep: forward
    (flash at q/k 192, V 128) against prefill + CHECK_STEPS absorbed decode
    steps, float path at fp32; then both under tubgemm_cuda@4 per-row."""
    cfg = configs.get_config(MLA_ID).replace(
        num_layers=MLA_RUN["layers"], param_dtype="float32", compute_dtype="float32")
    params = _init_family(cfg, "MLA + MoE")
    rng = np.random.default_rng(0)
    b, s = MLA_RUN["batch"], MLA_RUN["prompt"]
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)).to(DEV)
    flash_lib.reset_launches()
    t0 = time.perf_counter()
    fwd, aux = model_lib.forward(params, cfg, prompt)
    torch.cuda.synchronize()
    fwd_wall = time.perf_counter() - t0
    require(flash_lib.LAUNCHES["flash_fwd"] == cfg.num_layers, "MLA forward: flash_fwd")
    pre, _, _ = _cached_logits(params, cfg, prompt, steps=0)
    err_pre = float((pre - fwd).abs().max())
    err_dec = _decode_vs_forward(params, _no_drop(cfg), prompt)
    log(f"  float path (fp32): forward {fwd_wall:.2f} s (flash_fwd at q/k "
        f"{cfg.mla.nope_head_dim + cfg.mla.rope_head_dim}, V {cfg.mla.v_head_dim} "
        f"zero-padded); prefill (absorbed) vs forward max|dlogit| {err_pre:.3e}; "
        f"prefill + {CHECK_STEPS} absorbed decode steps vs forward, capacity at T "
        f"{err_dec:.3e} (tol {SELF_TOL:g}); aux {float(aux):.5f}")
    require(err_pre <= SELF_TOL and err_dec <= SELF_TOL,
            f"deepseek cached vs full: {err_pre}, {err_dec}")
    # under tubgemm_cuda: w_uk / w_uv are sites of the forward only
    got, tub_f, flash_f, (q_fwd, _) = _sites_run(
        lambda: model_lib.forward(params, cfg, prompt), cfg)
    require(got == expected_sites(cfg) and tub_f == len(got) and flash_f == cfg.num_layers,
            f"MLA forward under tubgemm_cuda: {got}, tub {tub_f}, flash {flash_f}")
    got, tub_c, _, (_, q_rows, _) = _sites_run(
        lambda: _cached_logits(params, cfg, prompt), cfg)
    want = expected_sites(cfg, cached=True) * (1 + CHECK_STEPS)
    require(got == want and tub_c == len(want),
            f"MLA cached calls under tubgemm_cuda: {got}, tub {tub_c}")
    log(f"  tubgemm_cuda@4 per-row: forward {tub_f} tub_gemm launches at "
        f"{len(expected_sites(cfg))} sites (w_uk, w_uv included), prefill + "
        f"{CHECK_STEPS} decode steps {tub_c} at {len(expected_sites(cfg, True))} "
        f"sites a call (w_uk, w_uv plain einsums); max|dlogit| forward vs "
        f"prefill at the last prompt position "
        f"{float((q_rows[:, 0] - q_fwd[:, -1]).abs().max()):.3e} (reported: the "
        f"forward quantizes w_uk and w_uv, the absorbed path does not)")
    caches = model_lib.init_caches(cfg, b, s + 1, dtype=torch.float32, device=DEV)
    _, caches = model_lib.prefill(params, cfg, prompt, caches=caches)
    tok = _greedy(pre)
    with backends.use_backend("tubgemm_cuda", bits=4), activation_scaling("per-row"):
        prof = _step_profile(lambda: model_lib.decode_step(
            params, cfg, tok, caches=caches, cache_pos=s),
            f"absorbed decode step (B={b}, context {s}, tubgemm_cuda@4, "
            f"{cfg.moe.num_experts} experts in turn)")
        fprof = _step_profile(lambda: model_lib.forward(params, cfg, prompt),
                              f"forward (B={b} x {s}, tubgemm_cuda@4)")
    peak = torch.cuda.max_memory_allocated()
    log(f"  peak max_memory_allocated {peak / 2**30:.2f} GiB")
    return {"tub_gemm": {"forward": tub_f, f"prefill + {CHECK_STEPS} decode steps": tub_c},
            "flash_fwd": flash_f,
            "decode_ms": prof["wall_ms"], "forward_ms": fprof["wall_ms"],
            "peak_gib": peak / 2**30}


@torch.no_grad()
def _dense_serve(arch: str) -> dict:
    cfg = configs.get_config(arch).replace(
        num_layers=DENSE_LAYERS, param_dtype="float32", compute_dtype="float32")
    params = _init_family(cfg, "dense serve")
    trace = serve_trace(FAMILY_REQUESTS)
    kw = dict(device=DEV, **SERVE_KW)
    engine = ServingEngine(cfg, params, attention="fused", backend="tubgemm_cuda", **kw)
    ug.reset_launches()
    fused_lib.reset_launches()
    t0 = time.perf_counter()
    with activation_scaling("per-row"):
        rep = engine.run(trace, "continuous")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n_sites = len(expected_sites(cfg))
    tub, fused = ug.LAUNCHES["tub_gemm"], fused_lib.LAUNCHES["fused_paged_decode"]
    require(rep.requests == len(trace), f"{arch}: not every request completed")
    require(fused == cfg.num_layers * rep.decode_steps,
            f"{arch}: fused decode launches {fused}")
    require(tub == n_sites * (rep.decode_steps + rep.prefill_calls),
            f"{arch}: tub_gemm launches {tub}")
    reps = {}
    for attention in ("fused", "gather"):
        eng = ServingEngine(cfg, params, attention=attention, **kw)
        reps[attention] = eng.run(trace, "continuous")
        del eng
    same = reps["fused"].request_tokens == reps["gather"].request_tokens
    peak = torch.cuda.max_memory_allocated()
    log(f"  [{arch}, {cfg.num_layers} layers, head dim {cfg.resolved_head_dim}, "
        f"tubgemm_cuda@4 per-row, fused] {rep.requests} requests, {rep.tokens} "
        f"tokens, {rep.decode_steps} decode steps in {wall:.2f} s "
        f"({rep.decode_steps / wall:.2f} decode steps/s); launches fused {fused}, "
        f"tub {tub} (= {n_sites} sites x {rep.decode_steps + rep.prefill_calls}); "
        f"float path fused == gather: {same}; peak {peak / 2**30:.2f} GiB")
    require(same, f"{arch}: fused and gather sampled different tokens (float path)")
    del engine
    return {"tub_gemm": tub, "fused_paged_decode": fused, "wall_s": wall,
            "steps_per_s": rep.decode_steps / wall, "peak_gib": peak / 2**30}


@torch.no_grad()
def _audio_forward() -> dict:
    cfg = configs.get_config(AUDIO_ID).replace(
        num_layers=DENSE_LAYERS, param_dtype="float32", compute_dtype="float32")
    params = _init_family(cfg, "audio frontend stub")
    rng = np.random.default_rng(0)
    b, s = AUDIO_RUN["batch"], AUDIO_RUN["seq"]
    embeds = torch.from_numpy(rng.standard_normal((b, s, cfg.d_model))
                              .astype(np.float32)).to(DEV)
    flash_lib.reset_launches()
    fwd, _ = model_lib.forward(params, cfg, embeds=embeds)
    launched = flash_lib.LAUNCHES["flash_fwd"]
    pre, _, _ = _cached_logits(params, cfg, embeds=embeds, steps=0)
    err = float((pre - fwd).abs().max())
    got, tub, _, (q_logits, _) = _sites_run(
        lambda: model_lib.forward(params, cfg, embeds=embeds), cfg)
    log(f"  [{cfg.arch_id}, {cfg.num_layers} layers, forward from ({b}, {s}, "
        f"{cfg.d_model}) embeddings] logits {tuple(fwd.shape)}, prefill vs "
        f"forward max|dlogit| {err:.3e} (tol {SELF_TOL:g}), flash_fwd {launched}; "
        f"under tubgemm_cuda@4 {tub} tub_gemm launches at {len(got)} sites")
    require(tuple(fwd.shape) == (b, s, cfg.vocab_size)
            and bool(torch.isfinite(fwd).all()) and bool(torch.isfinite(q_logits).all()),
            "musicgen forward: shape or finiteness")
    require(err <= SELF_TOL and launched == cfg.num_layers, "musicgen prefill vs forward")
    require(got == expected_sites(cfg) and tub == len(got), f"musicgen sites {got}")
    return {"tub_gemm": tub, "flash_fwd": launched}


@contextlib.contextmanager
def _tub_gemm_shapes():
    """Collects each distinct (M, K, N, bits) ``ug.tub_gemm`` is called at
    inside the block (``ops.tub_matmul`` looks the wrapper up at call time);
    the wrapper itself, and its launch count, are untouched."""
    seen: set = set()
    real = ug.tub_gemm

    def logged(a, b, *, bits=8):
        seen.add((int(a.shape[0]), int(a.shape[1]), int(b.shape[1]), bits))
        return real(a, b, bits=bits)

    ug.tub_gemm = logged
    try:
        yield seen
    finally:
        ug.tub_gemm = real


def _family_gemm_exact(seen: set, what: str = "families") -> float:
    """tub_gemm at every (M, K, N, bits) ``what``'s paths gave it, and at
    8 bits at each (K, N)'s smallest and largest M, on fresh codes (the
    weights over the whole int8 range): EQUAL to its plain slot loop and to
    the float64 integer product.  Returns the largest |difference| (0)."""
    gen = torch.Generator(device=DEV)
    gen.manual_seed(22)
    by_kn: dict = {}
    for m, k, n, bits in seen:
        by_kn.setdefault((k, n), set()).add((m, bits))
    worst, cases, t0 = 0.0, 0, time.perf_counter()
    for (k, n), ms in sorted(by_kn.items()):
        rows = sorted(m for m, _ in ms)
        cases_kn = ms | {(rows[0], 8), (rows[-1], 8)}
        b = _full_codes(gen, (k, n), 8)
        for m, bits in sorted(cases_kn):
            a = _codes(gen, (m, k), bits)
            out, _ = ug.tub_gemm(a, b, bits=bits)
            torch.cuda.synchronize()
            d = max(int((out.long() - ref_lib.tub_gemm_ref(a, b, bits=bits).long())
                        .abs().max()),
                    int((out.long() - _exact_product(a, b).long()).abs().max()))
            worst = max(worst, float(d))
            cases += 1
            require(d == 0, f"tub_gemm ({m},{k},{n}) bits={bits} on a {what} "
                            f"site shape: max |kernel - plain| {d}")
        del b
        log(f"  tub_gemm == plain == integer product at (K, N) = ({k}, {n}), "
            f"M {rows}, bits {sorted({bits for _, bits in cases_kn})}")
    log(f"  tub_gemm held at {cases} (M, K, N, bits) of the {what} paths in "
        f"{time.perf_counter() - t0:.1f} s")
    return worst


@contextlib.contextmanager
def _flash_shapes():
    """Collects each distinct (BH, Sq, Skv, D, dtype, causal) the three flash
    wrappers launch their kernels at inside the block (``flash_attention``
    looks them up at call time); calls on ``meta`` (a plan's site
    discovery) launch nothing and are left out.  The wrappers, and their
    launch counts, are untouched."""
    seen: set = set()
    real = {name: getattr(flash_lib, name) for name in FLASH}

    def logged(name):
        def call(q, k, v, *rest, causal):
            if q.device.type == "cuda":
                seen.add((int(q.shape[0]), int(q.shape[1]), int(k.shape[1]),
                          int(q.shape[2]), q.dtype, causal))
            return real[name](q, k, v, *rest, causal=causal)
        return call

    for name in FLASH:
        setattr(flash_lib, name, logged(name))
    try:
        yield seen
    finally:
        for name, fn in real.items():
            setattr(flash_lib, name, fn)


def _flash_exact(seen: set, what: str) -> dict:
    """The three flash kernels at every (BH, Sq, Skv, D) ``what``'s paths
    gave them, on fresh NaN-tailed slabs, in fp32 and bf16, causal and not,
    against their plain versions (``_flash_case``).  Returns each kernel's
    largest fp32 |kernel - plain|."""
    gen = torch.Generator(device=DEV)
    gen.manual_seed(23)
    errs = {name: 0.0 for name in FLASH}
    shapes: dict = {}
    for bh, sq, skv, d, dtype, causal in seen:
        shapes.setdefault((bh, sq, skv, d), set()).add(
            f"{str(dtype).split('.')[-1]} causal={causal}")
    t0 = time.perf_counter()
    for (bh, sq, skv, d), met in sorted(shapes.items()):
        log(f"  flash at a {what} shape BH={bh} Sq={sq} Skv={skv} d={d} (met as "
            f"{', '.join(sorted(met))})")
        for dtype in (torch.float32, torch.bfloat16):
            for causal in (True, False):
                _flash_case(gen, errs, bh, sq, skv, d, dtype, causal)
    log(f"  flash held at the {len(shapes)} (BH, Sq, Skv, D) of the {what} paths "
        f"in {time.perf_counter() - t0:.1f} s")
    return errs


def phase_families() -> dict:
    """The attention-transformer families: card against CPU at narrow widths
    that keep each arch's head dims, then every new arch at its published
    widths (depth cut).  Kernel launches are counted per path (zeroed just
    before it, read just after) and printed, not put on the kernels line."""
    t_phase = time.perf_counter()
    log("families: card vs CPU at narrow widths, fp32, 2 layers")
    for arch in FAMILY_IDS:
        _family_card_vs_cpu(arch)
    out = {}
    paths = [("moe_serve", _moe_serve), ("moe_train", _moe_train),
             ("mla", _mla_full), ("audio", _audio_forward),
             *((arch, lambda arch=arch: _dense_serve(arch)) for arch in SERVED_DENSE)]
    with _tub_gemm_shapes() as seen:
        for name, fn in paths:
            t0 = time.perf_counter()
            out[name] = fn()
            log(f"  ({name}: {time.perf_counter() - t0:.1f} s)")
            gc.collect()
            torch.cuda.empty_cache()
    with torch.no_grad():
        err = _family_gemm_exact(seen)
    launches = {
        "tub_gemm": {k: v["tub_gemm"] for k, v in out.items() if "tub_gemm" in v},
        "flash_fwd": {"mla (D=192)": out["mla"]["flash_fwd"],
                      "audio": out["audio"]["flash_fwd"],
                      "moe_train": out["moe_train"]["launches"]["flash_fwd"]},
        "flash_bwd_dq": {"moe_train": out["moe_train"]["launches"]["flash_bwd_dq"]},
        "flash_bwd_dkv": {"moe_train": out["moe_train"]["launches"]["flash_bwd_dkv"]},
        "fused_paged_decode": {a: out[a]["fused_paged_decode"] for a in SERVED_DENSE}}
    log(f"  launches by path: {json.dumps(launches)}")
    log(f"  families phase: {time.perf_counter() - t_phase:.1f} s")
    return {"launches": launches, "errs": {"tub_gemm": err}}


# ---------------------------------------------------------------------------
# phase 12: recurrent (Mamba2 SSD, RWKV6, the zamba2 hybrid stack)
# ---------------------------------------------------------------------------

HYBRID_ID, RWKV_ID = "zamba2-1.2b", "rwkv6-3b"
MAMBA_ID = "mamba2"            # a pure Mamba2 stack (family "ssm"), narrow only
RECURRENT_IDS = (HYBRID_ID, RWKV_ID, MAMBA_ID)
# batch 4, prompt 100: not a multiple of the SSD chunk (64) or the WKV chunk
# (32), so the padding path runs; published widths and depth (zamba2 38
# layers, 1.17 B parameters; rwkv6 32 layers, 3.07 B)
RECURRENT_SERVE = dict(batch=4, prompt=100, tokens=16)
# fp32 parameters + fp32 AdamW moments: zamba2 18.7 GB, rwkv6 49.2 GB; both
# fit 80 GB at full depth with remat.  Three steps: the first runs at lr 0
# (warmup), and RWKV's mu_w has no gradient while the decay LoRA's wb is
# still at its zero init, so it moves at the third
RECURRENT_TRAIN = dict(batch=2, seq=1024, steps=3)
# forward at T against prefill of T - 3 and 3 decode steps, fp32, full width
# and depth (stated in PERF.md before the first run)
RECURRENT_TOL = 1e-3


def narrow_recurrent(arch: str):
    """``arch`` at narrow widths that keep its recurrent dims (SSD state 64,
    head 64, chunk 64; RWKV head 64, decay LoRA 64) and zamba2's attention
    head dim 64: d_model 128, fp32.  zamba2 at 3 layers with the shared
    block after 2 (one application and a tail layer); the pure Mamba2 stack
    with two B/C groups."""
    kw = dict(d_model=128, num_heads=2, num_kv_heads=2, d_ff=256, vocab_size=512,
              param_dtype="float32", compute_dtype="float32", remat=False)
    if arch == MAMBA_ID:
        full = configs.get_config(HYBRID_ID)
        return ModelConfig(arch_id=MAMBA_ID, family="ssm", attention="none",
                           num_layers=2, ssm=dataclasses.replace(full.ssm, n_groups=2),
                           **kw)
    if arch == HYBRID_ID:
        return configs.get_config(arch).replace(num_layers=3, hybrid_attn_every=2, **kw)
    return configs.get_config(arch).replace(num_layers=2, **kw)


def real_values(defs, params, rng):
    """``params`` (numpy arrays, or CPU tensors) as a new numpy tree in which
    every zeros / ones leaf has seeded random values: ``mu_*`` uniform in
    [0, 1), other zeros N(0, 0.3²), ones 1 + N(0, 0.3²).  At init those leaves
    (token-shift mixes, the decay LoRA's ``wb``, the bonus ``u``, norm scales
    and biases, conv biases, ``d_skip``) would leave the token shift, the
    decay LoRA and the bonus without effect.  ``tests/test_torch_recurrent.py``
    gives the reference and the port their parameters through this too."""
    out = {}
    for k in params:
        d, p = defs[k], params[k]
        if isinstance(p, dict):
            out[k] = real_values(d, p, rng)
        elif d.init == "zeros":
            out[k] = (rng.random(tuple(p.shape)) if k.startswith("mu_")
                      else 0.3 * rng.standard_normal(tuple(p.shape))).astype(np.float32)
        elif d.init == "ones":
            out[k] = (1.0 + 0.3 * rng.standard_normal(tuple(p.shape))).astype(np.float32)
        else:
            out[k] = np.asarray(p)
    return out


def recorded_sites(cfg, params) -> list[str]:
    """The dense sites one float pass records, in order (a pass over T
    tokens, a prefill or one decode step alike): a forward on the ``meta``
    device, which computes nothing."""
    meta = planner_lib.meta_like(params)
    with torch.no_grad(), backends.record_sites() as rec:
        model_lib.forward(meta, cfg, torch.zeros((1, 1), dtype=torch.int32,
                                                 device="meta"))
    return [c.site for c in rec.calls]


def _shared_applications(cfg) -> int:
    return model_lib.blocks_lib.hybrid_counts(cfg)[0] if cfg.family == "hybrid" else 0


def _recurrent_card_vs_cpu(arch: str) -> None:
    """Narrow ``arch`` on the card (flash for zamba2's shared attention) and
    the CPU (plain versions), identical parameters and inputs: forward,
    prefill and CHECK_STEPS decode logits within FAMILY_TOL, greedy tokens
    equal, every cache leaf (SSD / WKV state, conv tails, token-shift
    buffers, the shared block's KV) and the loss and every gradient within
    FAMILY_TOL of max(1, max|CPU|)."""
    cfg = narrow_recurrent(arch)
    gen = torch.Generator(device="cpu")
    gen.manual_seed(0)
    cpu_params = model_lib.params_from_numpy(real_values(
        model_lib.model_defs(cfg), model_lib.init_params(cfg, gen, device="cpu"),
        np.random.default_rng(0)), device="cpu")
    card_params = _clone_tree(cpu_params, DEV)
    rng = np.random.default_rng(0)
    b, s = 2, 40
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32))

    def run(params, dev):
        fwd, _ = model_lib.forward(params, cfg, tokens.to(dev))
        caches = model_lib.init_caches(cfg, b, s + CHECK_STEPS, dtype=torch.float32,
                                       device=dev)
        pre, rows, toks = _cached_logits(params, cfg, tokens.to(dev), caches=caches)
        return ([x.cpu() for x in (fwd, pre, rows)], toks.cpu(),
                {k: v.cpu() for k, v in _tree_leaves(caches)})

    def rel(a, c):
        return float((a - c).abs().max()) / max(1.0, float(c.abs().max()))

    flash_lib.reset_launches()
    with torch.no_grad():
        card, card_toks, card_c = run(card_params, DEV)
        torch.cuda.synchronize()
        fwd_launches = flash_lib.LAUNCHES["flash_fwd"]
        cpu, cpu_toks, cpu_c = run(cpu_params, torch.device("cpu"))
    errs = [float((a - c).abs().max()) for a, c in zip(card, cpu)]
    cache_errs = {k: rel(card_c[k], cpu_c[k]) for k in cpu_c}
    out = []
    for dev in (DEV, torch.device("cpu")):
        tree = steps_lib._trainable(_clone_tree(cpu_params, dev))
        batch = {"tokens": tokens[:, :-1].to(dev), "targets": tokens[:, 1:].to(dev)}
        flash_lib.reset_launches()
        loss, _, grads = steps_lib.loss_and_grads(cfg, tree, batch)
        out.append((float(loss), {k: g.cpu() for k, g in _tree_leaves(grads)},
                    dict(flash_lib.LAUNCHES)))
    (loss_g, grads_g, launched), (loss_c, grads_c, _) = out
    worst = max((rel(grads_g[k], grads_c[k]), k) for k in grads_c)
    apps = _shared_applications(cfg)
    log(f"  {arch} narrow (d_model {cfg.d_model}, {cfg.num_layers} layers"
        + (f", SSD state {cfg.ssm.state_dim} head {cfg.ssm.head_dim} groups "
           f"{cfg.ssm.n_groups} chunk {cfg.ssm.chunk}" if cfg.ssm else "")
        + (f", RWKV head {cfg.rwkv.head_dim}" if cfg.rwkv else "")
        + (f", shared attention x{apps} at head dim {cfg.resolved_head_dim}" if apps else "")
        + f"): card vs CPU max|dlogit| forward {errs[0]:.2e}, prefill {errs[1]:.2e}, "
        f"{CHECK_STEPS} decode steps {errs[2]:.2e} (tol {FAMILY_TOL:g}); greedy tokens "
        f"equal {torch.equal(card_toks, cpu_toks)}; caches (tol {FAMILY_TOL:g} x "
        f"max(1, max|cpu|)) " + ", ".join(f"{k} {v:.2e}" for k, v in cache_errs.items())
        + f"; loss card {loss_g:.7f} cpu {loss_c:.7f}, worst gradient {worst[1]} "
        f"{worst[0]:.2e}; flash launches forward {fwd_launches}, gradient run {launched}")
    require(max(errs) <= FAMILY_TOL, f"{arch} narrow: card vs CPU logits {errs}")
    require(torch.equal(card_toks, cpu_toks), f"{arch} narrow: greedy tokens differ")
    require(max(cache_errs.values()) <= FAMILY_TOL, f"{arch} narrow: caches {cache_errs}")
    require(abs(loss_g - loss_c) <= FAMILY_TOL * abs(loss_c) and worst[0] <= FAMILY_TOL,
            f"{arch} narrow: loss {loss_g} vs {loss_c}, gradient {worst}")
    require(fwd_launches == apps and launched == {n: apps for n in FLASH},
            f"{arch}: flash launches {fwd_launches}, {launched}")


@torch.no_grad()
def _recurrent_serve(arch: str) -> dict:
    """``arch`` at its published widths and depth: forward at T against
    prefill of T - 3 and 3 greedy decode steps (fp32), then the one-shot
    serve mode's functions under tubgemm_cuda@4 per-row, a traced decode
    step and one layer's block at the decode token."""
    from repro_torch.launch import serve as serve_lib
    from repro_torch.models import rwkv as rwkv_lib
    from repro_torch.models import ssm as ssm_lib
    cfg = configs.get_config(arch).replace(param_dtype="float32", compute_dtype="float32")
    params = _init_family(cfg, "recurrent serve")
    rng = np.random.default_rng(0)
    b, s, new = RECURRENT_SERVE["batch"], RECURRENT_SERVE["prompt"], RECURRENT_SERVE["tokens"]
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)).to(DEV)
    apps = _shared_applications(cfg)
    t0 = time.perf_counter()
    toks = serve_lib.generate(cfg, params, prompt, new)
    torch.cuda.synchronize()
    log(f"  generate (float path): {tuple(toks.shape)} tokens in "
        f"{time.perf_counter() - t0:.2f} s")
    # the cached paths against the full-sequence pass (float path)
    flash_lib.reset_launches()
    _, rows, dec = _cached_logits(params, cfg, prompt)
    flash_cached = flash_lib.LAUNCHES["flash_fwd"]
    flash_lib.reset_launches()
    full, _ = model_lib.forward(params, cfg, torch.cat([prompt, dec], dim=1))
    torch.cuda.synchronize()
    flash_full = flash_lib.LAUNCHES["flash_fwd"]
    ref = full[:, s - 1:]
    err = float((rows - ref).abs().max())
    same = torch.equal(rows.argmax(-1), ref.argmax(-1))
    log(f"  float path: prefill of T - {CHECK_STEPS} = {s} + {CHECK_STEPS} decode steps "
        f"vs forward at T = {s + CHECK_STEPS}: max|dlogit| {err:.3e} (tol "
        f"{RECURRENT_TOL:g}, max|logit| {float(ref.abs().max()):.2f}), greedy tokens "
        f"equal {same}; flash_fwd launches forward {flash_full}, cached {flash_cached}")
    require(err <= RECURRENT_TOL and same, f"{arch} cached vs full: {err}, tokens {same}")
    require(flash_full == apps and flash_cached == 0,
            f"{arch}: flash_fwd forward {flash_full}, cached {flash_cached}")
    ug.reset_launches()
    rel = serve_lib.validate_backend_numerics(params, "tubgemm_cuda", 4)
    tiles = ug.LAUNCHES["tub_gemm"]      # run_backend_execution repeats this check
    require(rel == 0.0, f"tubgemm_cuda numerics on {arch} weights: {rel}")
    t0 = time.perf_counter()
    rec, stats = serve_lib.build_workload(cfg, params, b, s, 4)
    cost = backends.resolve("tubgemm", bits=4).price(rec.calls, unit_n=128, num_units=64)
    log(f"  build_workload: {len(rec.calls)} matrices priced in "
        f"{time.perf_counter() - t0:.2f} s; tubGEMM@4 {cost.dyn_energy_uj:.2f} uJ a "
        f"decode step")
    ug.reset_launches()
    flash_lib.reset_launches()
    with activation_scaling("per-row"):
        res = serve_lib.run_backend_execution(
            cfg, params, prompt, backends.resolve("tubgemm_cuda", bits=4), new,
            unit_n=128, num_units=64, stats=stats)
    sites = recorded_sites(cfg, params)
    launched, flash_exec = ug.LAUNCHES["tub_gemm"], flash_lib.LAUNCHES["flash_fwd"]
    log(f"  run_backend_execution tubgemm_cuda@4 per-row: {res['sites']} sites, "
        f"wall {res['wall_s']:.2f} s, drift {res['drift']:.3e}, top-1 agreement "
        f"{res['top1_agreement']:.3f}, tub_gemm launches {launched} (prefill, "
        f"{new - 1} decode steps and the prefill-logit pass: {len(sites)} x {new + 1} "
        f"= {len(sites) * (new + 1)}, + {tiles} numerics tiles), flash_fwd {flash_exec}")
    require(res["sites"] == len(set(sites)), f"sites executed {res['sites']}")
    require(launched == len(sites) * (new + 1) + tiles,
            f"run_backend_execution: {launched} tub_gemm launches, want "
            f"{len(sites)} x {new + 1} + {tiles}")
    # one decode step: every site launches tub_gemm once, lm_head included
    caches = model_lib.init_caches(cfg, b, s + 1, dtype=torch.float32, device=DEV)
    _, caches = model_lib.prefill(params, cfg, prompt, caches=caches)
    tok = toks[:, :1].contiguous()

    def step():
        return model_lib.decode_step(params, cfg, tok, caches=caches, cache_pos=s)

    got, tub, _, _ = _sites_run(step, cfg)
    require(got == sites and tub == len(sites),
            f"decode step under tubgemm_cuda: {len(got)} sites, {tub} launches")
    h = torch.randn((b, 1, cfg.d_model), device=DEV)
    lp = model_lib.blocks_lib.layer_slice(params["layers"], 0)
    if cfg.rwkv is not None:
        lc = model_lib.blocks_lib.layer_slice(caches["rwkv"], 0)
        block, name = (lambda: rwkv_lib.rwkv_block_fwd(lp, h, cfg, cache=lc)), "rwkv_block_fwd"
    else:
        lc = model_lib.blocks_lib.layer_slice(caches["ssm"], 0)
        block, name = (lambda: ssm_lib.ssm_fwd(lp["ssm"], h, cfg, cache=lc)), "ssm_fwd"
    with backends.use_backend("tubgemm_cuda", bits=4), activation_scaling("per-row"):
        prof = _step_profile(step, f"decode step (B={b}, context {s}, "
                                   f"tubgemm_cuda@4 per-row, {len(sites)} sites)",
                             {"tub_gemm": "unary_mma_kernel"})
        one = _step_profile(block, f"one layer's {name} at the decode token")
    share = cfg.num_layers * one["wall_ms"] / prof["wall_ms"]
    log(f"  the recurrent layers: {cfg.num_layers} x {one['wall_ms']:.2f} ms = "
        f"{100 * share:.1f} % of the decode step's host wall; "
        f"{cfg.num_layers * one['busy_ms']:.2f} of {prof['busy_ms']:.2f} ms device busy")
    # the same step and the prompt's forward on the float path: the
    # recurrence's own cost, without the per-site quantize / tub_gemm chain
    chunk = cfg.ssm.chunk if cfg.ssm is not None else rwkv_lib.CHUNK
    fprof = _step_profile(step, "decode step, float path")
    fwd = _step_profile(lambda: model_lib.forward(params, cfg, prompt),
                        f"forward, float path ({b} x {s}, {-(-s // chunk)} chunks "
                        f"of {chunk} a layer)")
    log(f"  the backend chain: {prof['wall_ms'] - fprof['wall_ms']:.2f} ms of the "
        f"decode step's {prof['wall_ms']:.2f} ms host wall")
    peak = torch.cuda.max_memory_allocated()
    log(f"  peak max_memory_allocated {peak / 2**30:.2f} GiB")
    return {"tub_gemm": {"run_backend_execution": launched, "decode step": tub},
            "flash_fwd": flash_full, "decode_ms": prof["wall_ms"],
            "decode_busy_ms": prof["busy_ms"], "float_decode_ms": fprof["wall_ms"],
            "forward_ms": fwd["wall_ms"], "peak_gib": peak / 2**30}


def _recurrent_train(arch: str) -> dict:
    """``arch`` at its published widths and depth: bf16 compute, remat,
    AdamW on SyntheticLM; losses, every gradient (through its norm) and
    every parameter finite, every parameter moved; zamba2's shared
    attention through flash at D = 64, forward and backward."""
    t = RECURRENT_TRAIN
    cfg = configs.get_config(arch).replace(param_dtype="float32",
                                           compute_dtype="bfloat16", remat=True)
    loop = train_lib.TrainLoopConfig(steps=t["steps"], log_every=1, batch=t["batch"],
                                     seq=t["seq"], lr=3e-4, warmup=1, seed=0)
    torch.cuda.reset_peak_memory_stats()
    flash_lib.reset_launches()
    t0 = time.perf_counter()
    state, history, _ = train_lib.train(cfg, loop, device=DEV)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(flash_lib.LAUNCHES)
    losses = [m["loss"] for _, m in history]
    norms = [m["grad_norm"] for _, m in history]
    peak = torch.cuda.max_memory_allocated()
    state.opt = None                  # room for the init tree beside the trained one
    finite = all(bool(torch.isfinite(w).all()) for _, w in _tree_leaves(state.params))
    gen = torch.Generator(device=DEV)
    gen.manual_seed(loop.seed)
    init = model_lib.init_params(cfg, gen, device=DEV)
    still = [k for (k, a), (_, w) in zip(_tree_leaves(init), _tree_leaves(state.params))
             if torch.equal(a, w)]
    apps = _shared_applications(cfg)
    log(f"  train: {arch} published widths, {cfg.num_layers} layers "
        f"({model_lib.count_params(state.params) / 1e9:.3f} B parameters), fp32 "
        f"parameters, bf16 compute, remat, batch {loop.batch} x {loop.seq}: losses "
        + " ".join(f"{x:.4f}" for x in losses) + ", gradient norms "
        + " ".join(f"{x:.3f}" for x in norms) + ", step walls "
        + " ".join(f"{m['step_s']:.2f}" for _, m in history)
        + f" s, train() {wall:.1f} s incl. init, peak {peak / 2**30:.2f} GiB; "
        f"parameters finite {finite}; launches {launches} (want {apps} x "
        f"{loop.steps} each); leaves unmoved {still or 'none'}")
    require(len(losses) == loop.steps and all(map(math.isfinite, losses + norms)),
            f"{arch} train: losses {losses}, gradient norms {norms}")
    require(finite and not still, f"{arch} train: finite {finite}, unmoved {still}")
    require(launches == {n: apps * loop.steps for n in FLASH},
            f"{arch} train: flash launches {launches}")
    del state
    gc.collect()
    torch.cuda.empty_cache()
    if cfg.rwkv is not None:
        _init_gradients(cfg, loop, init, norms[:2])
    del init
    return {"launches": launches, "step_s": history[-1][1]["step_s"],
            "peak_gib": peak / 2**30}


# the rwkv6 init-gradient witness: a relative perturbation of every
# parameter (fp32 rounding is 6e-8) and the depths it is also taken at
INIT_GRAD_PERTURB = 1e-7
INIT_GRAD_DEPTHS = (2, 8)


def _init_gradients(cfg, loop, params, trainer_norms: list) -> None:
    """A second witness for RWKV's gradient norm at init, at the trainer's
    init parameters (``params``; its first step runs at lr 0, so its first
    two steps' gradients are both taken there) and on its first two
    batches: each global norm in bf16 compute (the trainer's) and fp32
    beside the trainer's, the norm without the bonus ``u`` and the largest
    leaves; on the second batch also the bf16 gradients' distance from the
    fp32 ones, ``u``'s fp32 norm by layer, the fp32 gradient at parameters
    perturbed by INIT_GRAD_PERTURB (its conditioning), and both dtypes at
    the first INIT_GRAD_DEPTHS layers.  Requires every norm finite."""
    data = iter(SyntheticLM(DataConfig(batch_size=loop.batch, seq_len=loop.seq + 1,
                                       vocab_size=cfg.vocab_size, seed=loop.seed)))
    batches = [{k: torch.from_numpy(v).to(DEV) for k, v in next(data).items()
                if k in ("tokens", "targets")} for _ in trainer_norms]
    steps_lib._trainable(params)
    name = cfg.arch_id

    def grads_of(tree, dtype, batch, layers=cfg.num_layers):
        _, _, g = steps_lib.loss_and_grads(
            cfg.replace(compute_dtype=dtype, num_layers=layers), tree, batch)
        torch.cuda.synchronize()
        return dict(_tree_leaves(g))

    def summary(grads, what):
        leaf = {k: float(g.float().norm()) for k, g in grads.items()}
        total = math.sqrt(sum(x * x for x in leaf.values()))
        rest = math.sqrt(sum(x * x for k, x in leaf.items() if k != "layers/tm/u"))
        top = sorted(leaf.items(), key=lambda kv: -kv[1])[:3]
        log(f"  {name} gradients at init, {what}: global norm {total:.6g}, without "
            f"layers/tm/u {rest:.6g}; largest leaves "
            + ", ".join(f"{k} {x:.6g}" for k, x in top))
        require(math.isfinite(total), f"{name} gradients at init, {what}: {total}")

    kept = {}
    for i, (batch, trainer) in enumerate(zip(batches, trainer_norms), start=1):
        for dtype in ("bfloat16", "float32"):
            grads = grads_of(params, dtype, batch)
            summary(grads, f"the trainer's batch {i} ({loop.batch} x {loop.seq}), "
                           f"{dtype} compute (the trainer's step {i}: {trainer:.6g})")
            if i == 2:
                kept[dtype] = grads
            del grads
    fp32 = kept["float32"]
    gap = {k: float((kept["bfloat16"][k].float() - g).norm()) for k, g in fp32.items()}
    del kept
    u = fp32["layers/tm/u"].flatten(1).norm(dim=1).tolist()
    all32 = math.sqrt(sum(float(g.norm()) ** 2 for g in fp32.values()))
    log(f"  |bf16 - fp32| gradient, batch 2: layers/tm/u {gap['layers/tm/u']:.6g} of "
        f"{float(fp32['layers/tm/u'].norm()):.6g}, all leaves "
        f"{math.sqrt(sum(x * x for x in gap.values())):.6g} of {all32:.6g}; fp32 "
        f"layers/tm/u norm by layer (first three, last three) "
        + " ".join(f"{x:.4g}" for x in u[:3]) + " ... "
        + " ".join(f"{x:.4g}" for x in u[-3:]))
    gen = torch.Generator(device=DEV)
    gen.manual_seed(7)
    moved = _new_leaves(params, lambda t: t * (1 + INIT_GRAD_PERTURB * torch.randn(
        t.shape, generator=gen, device=DEV)))
    again = grads_of(moved, "float32", batches[1])
    del moved
    shift = math.sqrt(sum(float((again[k] - g).norm()) ** 2 for k, g in fp32.items()))
    summary(again, f"batch 2, fp32, every parameter x (1 + {INIT_GRAD_PERTURB:g} N(0, 1))")
    log(f"  the perturbation moved the fp32 gradient by {shift:.6g} (its norm "
        f"{all32:.6g}); layers/tm/u by "
        f"{float((again['layers/tm/u'] - fp32['layers/tm/u']).norm()):.6g}")
    del again, fp32
    for layers in INIT_GRAD_DEPTHS:
        cut = {**params, "layers": _new_leaves(params["layers"], lambda t: t[:layers])}
        for dtype in ("bfloat16", "float32"):
            summary(grads_of(cut, dtype, batches[1], layers),
                    f"batch 2, the first {layers} layers, {dtype} compute")
        if layers == INIT_GRAD_DEPTHS[0]:
            _init_gradients_card_vs_cpu(cfg.replace(num_layers=layers), cut, batches[1])
        del cut


def _init_gradients_card_vs_cpu(cfg, params, batch) -> None:
    """``params`` (a cut of the trainer's init, on the card) and ``batch``:
    the global gradient norm and ``u``'s by layer on the CPU in bf16 and on
    the card in fp32 and bf16 compute, from identical inputs; on the card
    in bf16 also without remat and with cuBLAS's reduced-precision bf16
    reductions turned off; the leaves whose bf16 gradient differs most
    between the card and the CPU; and each run's smallest per-head variance
    of a WKV output at t = 1.  With ``u`` = 0 that output is ``v_0`` times
    one dot product r_1 . k_0 a head; where the product nearly cancels, the
    variance falls below group norm's eps (1e-5) and the gradient through
    it turns on the last bits of that sum."""
    from repro_torch.models import rwkv as rwkv_lib
    matmul = torch.backends.cuda.matmul
    cpu = torch.device("cpu")
    runs, kept, var1 = {}, {}, []
    group_norm = rwkv_lib._group_norm

    def watched(x, s, b, n_heads, eps=1e-5):
        var1.append(float(x.detach().reshape(*x.shape[:2], n_heads, -1).float()
                          .var(-1, unbiased=False)[:, 1].min()))
        return group_norm(x, s, b, n_heads, eps)

    for key, dev, dtype, remat, reduced in (
            ("cpu bf16", cpu, "bfloat16", True, None),
            ("card fp32", DEV, "float32", True, None),
            ("card bf16", DEV, "bfloat16", True, None),
            ("card bf16 without remat", DEV, "bfloat16", False, None),
            ("card bf16, reduced-precision bf16 reductions off", DEV, "bfloat16",
             True, False)):
        tree = _new_leaves(params, lambda t: t.to(dev))
        before = matmul.allow_bf16_reduced_precision_reduction
        if reduced is not None:
            matmul.allow_bf16_reduced_precision_reduction = reduced
        var1.clear()
        rwkv_lib._group_norm = watched
        try:
            loss, _, g = steps_lib.loss_and_grads(
                cfg.replace(compute_dtype=dtype, remat=remat), tree,
                {k: v.to(dev) for k, v in batch.items()})
        finally:
            matmul.allow_bf16_reduced_precision_reduction = before
            rwkv_lib._group_norm = group_norm
        g = dict(_tree_leaves(g))
        total = math.sqrt(sum(float(x.float().norm()) ** 2 for x in g.values()))
        runs[key] = (float(loss), total,
                     g["layers/tm/u"].float().flatten(1).norm(dim=1).tolist(), min(var1))
        require(math.isfinite(total), f"{key}: gradient norm {total}")
        if key in ("cpu bf16", "card bf16"):
            kept[key] = {k: x.float().cpu() for k, x in g.items()}
        del tree, g
    gap = sorted(((float((kept["card bf16"][k] - x).norm()) / max(float(x.norm()), 1e-30), k)
                  for k, x in kept["cpu bf16"].items()), reverse=True)[:4]
    log(f"  {cfg.arch_id}, the same {cfg.num_layers} layers and batch on the card and "
        f"the CPU: loss, global gradient norm, layers/tm/u's by layer, smallest "
        f"head variance of a WKV output at t = 1: "
        + "; ".join(f"{k} {loss:.7f}, {t:.6g}, " + " ".join(f"{x:.6g}" for x in u)
                    + f", {v:.4g}" for k, (loss, t, u, v) in runs.items())
        + "; largest |card - cpu| / |cpu| of the bf16 gradients: "
        + ", ".join(f"{k} {r:.3g}" for r, k in gap))


def _new_leaves(tree, fn):
    """``tree`` with every leaf replaced by ``fn(leaf)``, a new trainable
    tensor."""
    if isinstance(tree, dict):
        return {k: _new_leaves(v, fn) for k, v in tree.items()}
    with torch.no_grad():
        return fn(tree).clone().requires_grad_(True)


def phase_recurrent() -> dict:
    """The recurrent families: card against CPU at narrow widths, then
    zamba2-1.2b and rwkv6-3b at their published widths and depth (serve and
    train), then tub_gemm and flash at every shape those paths gave them.
    Launches are counted per path (zeroed just before it, read just after)."""
    t_phase = time.perf_counter()
    log("recurrent: card vs CPU at narrow widths, fp32")
    for arch in RECURRENT_IDS:
        _recurrent_card_vs_cpu(arch)
    out = {}
    paths = [("zamba2_serve", lambda: _recurrent_serve(HYBRID_ID)),
             ("rwkv6_serve", lambda: _recurrent_serve(RWKV_ID)),
             ("zamba2_train", lambda: _recurrent_train(HYBRID_ID)),
             ("rwkv6_train", lambda: _recurrent_train(RWKV_ID))]
    with _tub_gemm_shapes() as seen, _flash_shapes() as flash_seen:
        for name, fn in paths:
            t0 = time.perf_counter()
            out[name] = fn()
            log(f"  ({name}: {time.perf_counter() - t0:.1f} s)")
            gc.collect()
            torch.cuda.empty_cache()
    with torch.no_grad():
        err = _family_gemm_exact(seen, "recurrent")
        flash_errs = _flash_exact(flash_seen, "recurrent")
    require({d for _, _, _, d, _, _ in flash_seen} == {64},
            f"recurrent paths: flash met at {sorted(flash_seen, key=str)}")
    launches = {
        "tub_gemm": {k: v["tub_gemm"] for k, v in out.items() if "tub_gemm" in v},
        "flash_fwd": {"zamba2_serve (forward, D=64)": out["zamba2_serve"]["flash_fwd"],
                      "zamba2_train": out["zamba2_train"]["launches"]["flash_fwd"]},
        "flash_bwd_dq": {"zamba2_train": out["zamba2_train"]["launches"]["flash_bwd_dq"]},
        "flash_bwd_dkv": {"zamba2_train": out["zamba2_train"]["launches"]["flash_bwd_dkv"]}}
    log(f"  launches by path: {json.dumps(launches)}")
    log(f"  recurrent phase: {time.perf_counter() - t_phase:.1f} s")
    return {"launches": launches, "errs": {"tub_gemm": err, **flash_errs}}


# ---------------------------------------------------------------------------
# phase 13: analysis (the static gate, python -m repro_torch.analysis)
# ---------------------------------------------------------------------------

# what the reference's gate (python -m repro.analysis) reports on the same
# ten published configs: GEMM sites per arch, and its eight warnings
ANALYSIS_SITES = {"zamba2-1.2b": 14, "gemma-7b": 7, "phi3-mini-3.8b": 8,
                  "internlm2-1.8b": 8, "llama3-8b": 8, "deepseek-v3-671b": 11,
                  "phi3.5-moe-42b-a6.6b": 5, "rwkv6-3b": 8,
                  "musicgen-medium": 7, "chameleon-34b": 8}
REFERENCE_WARNINGS = tuple(("planner-invisible-gemm", where) for where in (
    "gemma-7b/embed", "deepseek-v3-671b/layers/moe/router",
    "phi3.5-moe-42b-a6.6b/layers/moe/router",
    "phi3.5-moe-42b-a6.6b/layers/moe/w_gate",
    "phi3.5-moe-42b-a6.6b/layers/moe/w_up",
    "phi3.5-moe-42b-a6.6b/layers/moe/w_down",
    "rwkv6-3b/layers/tm/wa", "rwkv6-3b/layers/tm/wb"))


def phase_analysis() -> dict:
    """The port's analysis gate in process at its default scope (all ten
    published configs at full depth on ``meta``, grids 1x1/2x2/4x1, the
    shipped plans, the source lint): exit 0, the reference's site counts
    and its eight warnings; the wall time of each arch's ranges pass."""
    from repro_torch.analysis.__main__ import main as analysis_main

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        report = os.path.join(tmp, "findings.json")
        rc = analysis_main(["--root", HERE, "--json", report])
        with open(report) as f:
            doc = json.load(f)
    wall = time.perf_counter() - t0
    per_arch = doc["ranges"]
    for arch, stats in per_arch.items():
        log(f"  analysis {arch}: {stats['seconds']:.2f} s, {stats['sites']} sites, "
            f"{stats['dot_generals']} dispatched products, "
            f"{stats['points_checked']} envelope points")
    found = {(f["rule"], f["where"]) for f in doc["findings"]}
    errors = [f for f in doc["findings"] if f["severity"] == "error"]
    log(f"  analysis gate: exit {rc}, {doc['verdict']}, {wall:.1f} s "
        f"(ranges {sum(s['seconds'] for s in per_arch.values()):.1f} s)")
    require(rc == 0 and not errors, f"analysis gate: exit {rc}, {errors[:3]}")
    sites = {a: s["sites"] for a, s in per_arch.items()}
    require(sites == ANALYSIS_SITES, f"analysis: site counts {sites}")
    require(found == set(REFERENCE_WARNINGS),
            f"analysis: warnings differ from the reference's: only ours "
            f"{sorted(found - set(REFERENCE_WARNINGS))}, only the reference's "
            f"{sorted(set(REFERENCE_WARNINGS) - found)}")
    return {"wall_s": wall,
            "per_arch_s": {a: s["seconds"] for a, s in per_arch.items()}}


# ---------------------------------------------------------------------------
# phase 14: pipeline (launch/pipeline.py on the card)
# ---------------------------------------------------------------------------

PIPELINE_RUN = dict(layers=8, stages=4, micro=4, mb=1, seq=2048)


def phase_pipeline() -> dict:
    """llama3-8b at full width, 8 layers in 4 stages of 2 (the port's
    transformer block through ``stack_fwd``), 4 microbatches of 1 x 2048,
    fp32 with remat, through ``pipeline_apply`` on the card, forward and
    the gradient of sum(out**2): the forward equal bit for bit to a
    sequential run over the same microbatches and within 1e-5 x max|ref|
    of one whole-batch run, every stacked leaf's gradient within 1e-4 x
    max|ref grad| of the whole-batch run's.  Flash launches are counted
    over the pipeline's forward and backward only; then the three flash
    kernels are held against their plain versions at the shape that run
    gave them (``_flash_exact``), whose fp32 errors the kernels line takes."""
    from repro_torch.launch.mesh import make_pipeline_mesh
    from repro_torch.launch.pipeline import (bubble_fraction, pipeline_apply,
                                             split_stages)
    from repro_torch.models import blocks
    from repro_torch.models.common import init_tree

    run = PIPELINE_RUN
    cfg = configs.get_config("llama3-8b").replace(
        num_layers=run["layers"], param_dtype="float32",
        compute_dtype="float32", remat=True)
    stage_cfg = cfg.replace(num_layers=run["layers"] // run["stages"])
    gen = torch.Generator(device=DEV)
    gen.manual_seed(0)
    layers = init_tree(blocks.stacked_layer_defs(cfg), gen, DEV, torch.float32)
    leaves = dict(_tree_leaves(layers))
    for leaf in leaves.values():
        leaf.requires_grad_(True)
    x = torch.randn((run["micro"], run["mb"], run["seq"], cfg.d_model),
                    generator=gen, device=DEV)
    positions = torch.arange(run["seq"], device=DEV)[None, :]

    def stage(stage_params, h):
        return blocks.stack_fwd({"layers": stage_params}, h, stage_cfg,
                                positions=positions)[0]

    names = sorted(leaves)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    flash_lib.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with _flash_shapes() as flash_seen:
        out = pipeline_apply(stage, split_stages(layers, run["stages"]), x,
                             make_pipeline_mesh(run["stages"], DEV))
        grads = torch.autograd.grad(torch.sum(out ** 2),
                                    [leaves[n] for n in names])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(flash_lib.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    log(f"  pipeline: llama3-8b widths, {run['layers']} layers in "
        f"{run['stages']} stages, {run['micro']} microbatches of {run['mb']} x "
        f"{run['seq']}, fp32, remat: forward + backward {wall:.2f} s, peak "
        f"{peak / 2**30:.2f} GiB, flash launches {launches}; the reference "
        f"schedule's bubble {bubble_fraction(run['stages'], run['micro']):.3f} "
        f"(not executed)")
    n_calls = run["layers"] * run["micro"]
    require(launches == {"flash_fwd": 2 * n_calls, "flash_bwd_dq": n_calls,
                         "flash_bwd_dkv": n_calls},
            f"pipeline: flash launches {launches}, want forward 2 x {n_calls} "
            f"(remat) and {n_calls} each backward")
    out = out.detach()
    with torch.no_grad():
        seq = torch.stack([blocks.stack_fwd({"layers": layers}, x[i], cfg,
                                            positions=positions)[0]
                           for i in range(run["micro"])])
    require(torch.equal(out, seq), "pipeline: forward differs from the "
            f"sequential run over the same microbatches by "
            f"{float((out - seq).abs().max()):.3e}")
    del seq
    whole = blocks.stack_fwd({"layers": layers},
                             x.reshape(-1, run["seq"], cfg.d_model), cfg,
                             positions=positions)[0].reshape(out.shape)
    ref_grads = torch.autograd.grad(torch.sum(whole ** 2),
                                    [leaves[n] for n in names])
    whole = whole.detach()
    fwd_err = float((out - whole).abs().max()) / float(whole.abs().max())
    grad_errs = {n: float((g - r).abs().max()) / float(r.abs().max())
                 for n, g, r in zip(names, grads, ref_grads)}
    worst = max(grad_errs, key=grad_errs.get)
    log(f"  pipeline vs one whole-batch run: forward max|diff| / max|ref| "
        f"{fwd_err:.2e} (tol 1e-5); worst gradient leaf {worst} "
        f"{grad_errs[worst]:.2e} (tol 1e-4); sequential run: bit for bit")
    require(fwd_err <= 1e-5, f"pipeline: forward off by {fwd_err:.3e}")
    require(grad_errs[worst] <= 1e-4,
            f"pipeline: gradient of {worst} off by {grad_errs[worst]:.3e}")
    del out, whole, grads, ref_grads
    with torch.no_grad():
        errs = _flash_exact(flash_seen, "pipeline")
    want = (run["mb"] * cfg.num_heads, run["seq"], run["seq"],
            cfg.resolved_head_dim)
    require({(bh, sq, skv, d) for bh, sq, skv, d, _, _ in flash_seen} == {want},
            f"pipeline: flash met at {sorted(flash_seen, key=str)}, want {want}")
    return {"launches": launches, "wall_s": wall, "peak_gib": peak / 2**30,
            "errs": errs}


# ---------------------------------------------------------------------------
# phase 15: dryrun (launch/dryrun.py: meta traces, then the train cell run)
# ---------------------------------------------------------------------------

DRYRUN_CELLS = (("llama3-8b", "train_4k"), ("llama3-8b", "prefill_32k"),
                ("llama3-8b", "decode_32k"), ("zamba2-1.2b", "long_500k"))
DRYRUN_TRAIN = dict(layers=8, batch=4, seq=2048, steps=3)
# the phase takes under a minute; past this every thread's Python stack is
# written to stderr, and again each time it passes, so that a stall leaves
# where it stood
DRYRUN_WATCHDOG_S = 180


def phase_dryrun() -> dict:
    """:func:`_dryrun_cells` with a watchdog: a stall dumps the stacks."""
    faulthandler.dump_traceback_later(DRYRUN_WATCHDOG_S, repeat=True)
    try:
        return _dryrun_cells()
    finally:
        faulthandler.cancel_dump_traceback_later()


def _dryrun_cells() -> dict:
    """The dry run's meta traces of four published cells (their roofline
    terms logged), then the train phase's cell (llama3-8b, 8 layers, 4 x
    2048, bf16 compute, remat, AdamW) traced and run for 3 steps on the
    card: its argument bytes equal to what the state and batch add to
    ``memory_allocated()`` within 1 %; the measured step against the
    model-FLOPs fraction, the counted flops and the trace's peak logged."""
    from repro_torch.launch import dryrun as dryrun_lib

    for arch, shape in DRYRUN_CELLS:
        rec = dryrun_lib.run_cell(arch, shape, out_dir=None)
        r, mem = rec["roofline"], rec["memory_analysis"]
        log(f"  dryrun {arch} x {shape}: trace {rec['trace_s']} s, counted "
            f"{rec['hlo_cost']['flops']:.4e} flops, {rec['hlo_cost']['bytes']:.4e} "
            f"bytes; terms compute {r['compute_s']:.4e} s, memory "
            f"{r['memory_s']:.4e} s, collective {r['collective_s']:.1f} s "
            f"({r['dominant']}); model flops {r['model_flops']:.4e}, useful "
            f"{r['useful_flops_ratio']:.3f}, roofline fraction "
            f"{r['roofline_fraction']:.4f}; arguments "
            f"{mem['argument_size_in_bytes'] / 2**30:.2f} GiB, eager peak "
            f"{mem['temp_peak_live_bytes_eager'] / 2**30:.1f} GiB")

    run = DRYRUN_TRAIN
    cfg = configs.get_config("llama3-8b").replace(
        num_layers=run["layers"], param_dtype="float32",
        compute_dtype="bfloat16", remat=True)
    opt_cfg = AdamWConfig(lr=3e-4)
    traced = dryrun_lib.trace_step(cfg, "train", run["batch"], run["seq"],
                                   opt_cfg=opt_cfg)
    cost = traced["cost"]
    tokens = run["batch"] * run["seq"]
    model_flops = 6.0 * dryrun_lib._param_sizes(cfg)[1] * tokens
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    gen = torch.Generator(device=DEV)
    gen.manual_seed(0)
    state = steps_lib.init_train_state(cfg, opt_cfg, gen, device=DEV)
    batch = {k: torch.randint(0, cfg.vocab_size, (run["batch"], run["seq"]),
                              generator=gen, device=DEV, dtype=torch.int32)
             for k in ("tokens", "targets")}
    # what earlier phases leave allocated (library workspaces, per-device
    # kernel buffers) is not the step's: the arguments are what the state
    # and the batch add
    allocated = torch.cuda.memory_allocated()
    rel = abs(allocated - base - traced["argument_bytes"]) / traced["argument_bytes"]
    log(f"  dryrun train cell (llama3-8b, {run['layers']} layers, "
        f"{run['batch']} x {run['seq']}, bf16 compute, remat, AdamW fp32): "
        f"argument bytes {traced['argument_bytes']} against the "
        f"{allocated - base} the state and batch allocated (rel {rel:.2e}, "
        f"tol 1e-2); memory_allocated {allocated} before the first step, "
        f"{base} before the state was built")
    require(rel <= 1e-2, f"dryrun: argument bytes {traced['argument_bytes']} "
                         f"vs {allocated - base} allocated for them")
    step_fn = steps_lib.make_train_step(cfg, opt_cfg)
    torch.cuda.reset_peak_memory_stats()
    flash_lib.reset_launches()
    secs, losses = [], []
    for _ in range(run["steps"]):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        losses.append(float(metrics["loss"]))
        log(f"    step {len(secs)}: {secs[-1]:.3f} s, loss {losses[-1]:.4f}")
    peak = torch.cuda.max_memory_allocated()
    step_s = statistics.median(secs[1:])
    mfu = model_flops / (step_s * BF16_OPS_PER_S)
    log(f"  dryrun train cell: step wall (host clock, a synchronise per step) "
        + " ".join(f"{s:.3f}" for s in secs) + f" s, median of the last "
        f"{len(secs) - 1} {step_s:.3f} s; model flops 6 x "
        f"{dryrun_lib._param_sizes(cfg)[1]:.4e} x {tokens} = {model_flops:.4e} "
        f"-> {100 * mfu:.2f} % of 989 TFLOP/s (predicted 20-25 %); counted "
        f"flops {cost.flops:.4e} (useful {model_flops / cost.flops:.3f}), "
        f"counted bytes {cost.bytes_accessed:.4e}, {cost.ops} operations; "
        f"trace peak (arguments + eager live) "
        f"{(traced['argument_bytes'] + cost.peak_live_bytes) / 2**30:.2f} GiB "
        f"against max_memory_allocated {peak / 2**30:.2f} GiB (not gated); "
        f"losses {' '.join(f'{x:.4f}' for x in losses)}; flash launches "
        f"{dict(flash_lib.LAUNCHES)}")
    require(all(math.isfinite(x) for x in losses), "dryrun: a loss is not finite")
    return {"step_s": step_s, "mfu": mfu}


# ---------------------------------------------------------------------------
# phase 9: times
# ---------------------------------------------------------------------------

_FLUSH = None


def _time_ms(fn, reps: int = 20, warmup: int = 3, clean_l2: bool = False) -> float:
    """Median CUDA-event time of one call, L2 flushed before each call.  A
    spin of about half a millisecond on the card after the flush lets the
    host queue the call before the start event runs, so a slow host's
    wrapper time does not show up as device time.  The flush writes a
    256 MiB buffer, so the call also pays for writing back the dirty lines it
    evicts; with ``clean_l2`` the flush reads the buffer instead."""
    global _FLUSH
    if _FLUSH is None:
        _FLUSH = torch.empty(256 * 2**20, dtype=torch.uint8, device=DEV)
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        if clean_l2:
            _FLUSH.sum(dtype=torch.int64)
        else:
            _FLUSH.zero_()
        torch.cuda._sleep(1_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _gemm_bound(m: int, k: int, n: int, *, w_bytes: float | None = None,
                extra_bytes: int = 0) -> tuple[float, str]:
    """Least time of an int8 (M,K) x (K,N) -> 4-byte (M,N) product: its
    bytes (the weight as stored: ``w_bytes``, K*N by default) at the HBM
    rate, or its int8 operations at the tensor-core peak."""
    w_bytes = k * n if w_bytes is None else w_bytes
    bytes_ms = (m * k + w_bytes + 4 * m * n + extra_bytes) / HBM_BYTES_PER_S * 1e3
    ops_ms = 2.0 * m * k * n / INT8_OPS_PER_S * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


LIBRARY_INT_MM = "torch._int_mm on the unpacked int8 operands"
LIBRARY_INT_MM_PADDED = LIBRARY_INT_MM + ", M padded to 32 rows (its smallest)"


def _int_mm_ms(a: torch.Tensor, b: torch.Tensor) -> float | None:
    """``torch._int_mm`` on the same int8 operands, the library yardstick;
    M <= 16 is padded with zero rows to 32, the smallest M it takes."""
    m = a.shape[0]
    if m <= 16:
        a = torch.cat([a, a.new_zeros((32 - m, a.shape[1]))])
    if a.shape[0] % 8 or a.shape[1] % 8 or b.shape[1] % 8:
        return None              # shapes cuBLASLt's int8 matmul refuses
    return _time_ms(lambda: torch._int_mm(a, b))


def _time_gemm(name: str, m: int, k: int, n: int, bits: int, gen) -> dict:
    a = _codes(gen, (m, k), bits)
    b = _codes(gen, (k, n), bits)
    fn = ug.tub_gemm if name == "tub_gemm" else ug.tu_gemm
    plain = ref_lib.tub_gemm_ref if name == "tub_gemm" else ref_lib.tu_gemm_ref
    ms = _time_ms(lambda: fn(a, b, bits=bits))
    plain_ms = _time_ms(lambda: plain(a, b, bits=bits), reps=5, warmup=1)
    library_ms = _int_mm_ms(a, b)
    bound_ms, bound_by = _gemm_bound(m, k, n)
    return {"shape": [m, k, n], "bits": bits, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms,
            "library_call": LIBRARY_INT_MM_PADDED if m <= 16 else LIBRARY_INT_MM}


def phase_times(errs: dict, launches: dict, launches_run: dict,
                layers: int, sass: dict) -> list[dict]:
    gen = torch.Generator(device=DEV)
    gen.manual_seed(1)
    # the main path's GEMM sites at bits=4: decode rows (M = 8) and a long
    # prompt's prefill rows (M = 512)
    site_shapes = [(4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096),
                   (4096, 128256)]
    rows = []
    for name in ("tub_gemm", "tu_gemm"):
        per_shape = []
        for m in (8, 512):
            for (k, n) in site_shapes:
                per_shape.append(_time_gemm(name, m, k, n, 4, gen))
        head = next(r for r in per_shape if r["shape"] == [8, 4096, 14336])
        # one decode step launches, per layer, 2x(4096,4096) 2x(4096,1024)
        # 2x(4096,14336) 1x(14336,4096), plus the lm_head once
        by = {tuple(r["shape"]): r for r in per_shape}
        per_layer = (2 * by[(8, 4096, 4096)]["ms"] + 2 * by[(8, 4096, 1024)]["ms"]
                     + 2 * by[(8, 4096, 14336)]["ms"] + by[(8, 14336, 4096)]["ms"])
        per_layer_bound = (2 * by[(8, 4096, 4096)]["bound_ms"]
                           + 2 * by[(8, 4096, 1024)]["bound_ms"]
                           + 2 * by[(8, 4096, 14336)]["bound_ms"]
                           + by[(8, 14336, 4096)]["bound_ms"])
        rows.append({
            "name": name, "route": "cuda", "source": SOURCE[name],
            "replaces": REPLACES[name], "launches": launches.get(name, 0),
            "launches_run": launches_run.get(name),
            "max_abs_err": errs[name], "ms": head["ms"],
            "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"], "library_ms": head["library_ms"],
            "library_call": head["library_call"],
            "shape": "M=8 K=4096 N=14336 bits=4",
            "per_shape": per_shape})
        for r in per_shape:
            lib = "n/a" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
            # the slot schedule's own least time: every slot one int8 product
            m, k, n = r["shape"]
            n_slots = (max(1, 2 ** (r["bits"] - 2)) if name == "tub_gemm"
                       else 2 ** (r["bits"] - 1))
            slot_bound_ms = n_slots * 2.0 * m * k * n / INT8_OPS_PER_S * 1e3
            log(f"  {name} {tuple(r['shape'])} bits=4: {r['ms']:.4f} ms, plain "
                f"{r['plain_ms']:.3f} ms, bound {r['bound_ms']:.4f} ms "
                f"({r['bound_by']}), slot schedule's bound "
                f"{slot_bound_ms:.4f} ms, torch._int_mm {lib} ms")
        log(f"  {name}: the {7 * layers + 1} launches of one {layers}-layer "
            f"decode step, each timed alone with a cold L2, sum to "
            f"{layers * per_layer + by[(8, 4096, 128256)]['ms']:.2f} ms (their "
            f"bounds to {layers * per_layer_bound + by[(8, 4096, 128256)]['bound_ms']:.2f} "
            f"ms); a sum of separate timings, not a measured step")

    # fused decode at the main path's geometry, ragged lengths to 1024
    q, pk, pv, _, _, bt, lens = _decode_case(gen, RAGGED_LENGTHS,
                                             pool_dtype=torch.float32)
    ms = _time_ms(lambda: fused_lib.fused_paged_decode_attention(
        q, pk, pv, bt, lens, num_heads=32))
    plain_ms = _time_ms(lambda: fused_lib.fused_decode_plain(
        q, pk, pv, bt, lens, num_heads=32), reps=5, warmup=1)
    gather_ms = _time_ms(lambda: paged_lib.paged_decode_attention(
        q, pk, pv, bt, lens, num_heads=32))
    kv_bytes = fused_lib.fused_decode_bytes_moved(
        RAGGED_LENGTHS, page_size=16, num_kv_heads=8, head_dim=128, dtype_bytes=4)
    io_bytes = kv_bytes + 2 * q.numel() * 4 + bt.numel() * 4 + lens.numel() * 4
    flops = sum(4.0 * 32 * 128 * n for n in RAGGED_LENGTHS)
    bytes_ms = io_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / FP32_OPS_PER_S * 1e3
    rows.insert(0, {
        "name": "fused_paged_decode", "route": "cuda",
        "source": SOURCE["fused_paged_decode"],
        "replaces": REPLACES["fused_paged_decode"],
        "launches": launches.get("fused_paged_decode", 0),
        "launches_run": launches_run.get("fused_paged_decode"),
        "max_abs_err": errs["fused_paged_decode"], "ms": ms,
        "plain_ms": plain_ms, "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": None,
        "shape": f"B=8 H=32 KVH=8 hd=128 page=16 fp32 lengths={list(RAGGED_LENGTHS)}",
        "gather_oracle_ms": gather_ms, "kv_bytes": kv_bytes})
    log(f"  fused_paged_decode: {ms:.4f} ms, plain walk {plain_ms:.3f} ms, "
        f"gather oracle {gather_ms:.4f} ms, bound {max(bytes_ms, ops_ms):.4f} ms "
        f"(bytes; {kv_bytes / 2**20:.1f} MiB of live K/V)")
    _decode_split_sweep(q, pk, pv, bt, lens, "the same")
    # the serve step's geometry: 8 slots at context 300 (+ the token this
    # step writes), page 16, 64-page block table; log lines only
    serve_lens = (301,) * 8
    q, pk, pv, _, _, bt, lens = _decode_case(gen, serve_lens,
                                             pool_dtype=torch.float32)
    step_ms = _time_ms(lambda: fused_lib.fused_paged_decode_attention(
        q, pk, pv, bt, lens, num_heads=32))
    step_bytes = (fused_lib.fused_decode_bytes_moved(
        serve_lens, page_size=16, num_kv_heads=8, head_dim=128, dtype_bytes=4)
        + 2 * q.numel() * 4 + bt.numel() * 4 + lens.numel() * 4)
    log(f"  fused_paged_decode at the serve step's geometry (B=8 x 301 tokens, "
        f"fp32): {step_ms:.4f} ms, bound {step_bytes / HBM_BYTES_PER_S * 1e3:.4f} "
        f"ms (bytes; {step_bytes / 2**20:.1f} MiB)")
    _decode_split_sweep(q, pk, pv, bt, lens, "the serve step's geometry")
    q, pk, pv, _, _, bt, lens = _decode_case(gen, RAGGED_LENGTHS,
                                             pool_dtype=torch.bfloat16)
    _decode_split_sweep(q, pk, pv, bt, lens, "ragged lengths, bf16 pools")
    rows.extend(_time_flash(gen, errs, launches, launches_run, sass))
    rows.extend(_time_int_gemms(gen, errs, launches, launches_run, layers))
    rows.append(_time_block_stats(gen, errs, launches, launches_run))
    return rows


def _decode_split_sweep(q, pk, pv, bt, lens, what: str) -> None:
    """Log the fused decode's time at its planned split count and at forced
    counts 1 (unsplit) to 64 (a page a split): whether the one-wave plan is
    the best count.  Log line only."""
    batch, _, h, hd = q.shape
    kvh, max_blocks = pk.shape[2], bt.shape[1]
    lanes, chunks, gtile = fused_lib.decode_geometry(hd, pk.element_size())
    resident = _build.resident_blocks(
        "fused_paged_decode_resident_blocks", 0, hd, lanes, chunks, gtile,
        0 if pk.dtype == torch.float32 else 1)
    rows = kvh * -(-(h // kvh) // gtile)
    sm_count = torch.cuda.get_device_properties(0).multi_processor_count
    plan = fused_lib.split_geometry(max_blocks, fused_lib.plan_decode_splits(
        batch, rows, max_blocks, sm_count, resident))[1]
    times = []
    for n in (None, 1, 2, 4, 8, 16, 32, 64):
        with _decode_splits(n):
            ms = _time_ms(lambda: fused_lib.fused_paged_decode_attention(
                q, pk, pv, bt, lens, num_heads=h))
        times.append(f"{'plan' if n is None else n}:{ms:.4f}")
    log(f"  fused_paged_decode split sweep, {what} (plan {plan} splits at "
        f"{resident} blocks an SM): ms by split count " + " ".join(times))


def _time_int_gemms(gen, errs: dict, launches: dict, launches_run: dict,
                    layers: int) -> list[dict]:
    """quant_gemm and packed_gemm at 4 bits with the fused dequant, as the
    quant path runs them: decode rows (M = 8) and prefill rows (M = 512) at
    the distinct site shapes; ``torch._int_mm`` on the unpacked int8
    weights as the library yardstick."""
    bits = QUANT_BITS
    rows = []
    for name in INT_GEMMS:
        per_shape = []
        for m in INT_GEMM_ROWS:
            for (k, n) in sorted(set(SITE_SHAPES)):
                x = _full_codes(gen, (m, k), 8)
                w = _codes(gen, (k, n), bits)
                scales = torch.rand((1, n), generator=gen, device=DEV) * 1e-2
                if name == "quant_gemm":
                    wp = ops_lib.pack_values(w, bits)
                    kern = lambda: qg_lib.quant_gemm(x, wp, scales, bits=bits,
                                                     fuse_dequant=True)
                    plain = lambda: ref_lib.quant_gemm_ref(
                        x, wp, scales, bits=bits, fuse_dequant=True)
                    stored = wp.numel()
                else:
                    words = packing.pack_codes(w, bits)
                    kern = lambda: pg_lib.packed_gemm(x, words, scales, bits=bits,
                                                      k=k, fuse_dequant=True)
                    plain = lambda: ref_lib.packed_gemm_ref(
                        x, words, scales, bits=bits, k=k, fuse_dequant=True)
                    stored = words.numel() * 4
                bound_ms, bound_by = _gemm_bound(m, k, n, w_bytes=stored,
                                                 extra_bytes=4 * n)
                per_shape.append({
                    "shape": [m, k, n], "bits": bits, "ms": _time_ms(kern),
                    "plain_ms": _time_ms(plain, reps=5, warmup=1),
                    "bound_ms": bound_ms, "bound_by": bound_by,
                    "library_ms": _int_mm_ms(x, w),
                    "library_call": (LIBRARY_INT_MM_PADDED if m <= 16
                                     else LIBRARY_INT_MM)})
                del x, w
        by = {tuple(r["shape"]): r for r in per_shape}
        head = by[(8, *UP_SHAPE)]
        rows.append({
            "name": name, "route": "cuda", "source": SOURCE[name],
            "replaces": REPLACES[name], "launches": launches.get(name, 0),
            "launches_run": launches_run.get(name), "max_abs_err": errs[name],
            **{key: head[key] for key in ("ms", "plain_ms", "bound_ms",
                                          "bound_by", "library_ms",
                                          "library_call")},
            "shape": f"M=8 K={UP_SHAPE[0]} N={UP_SHAPE[1]} bits={bits} "
                     f"fused dequant",
            "per_shape": per_shape})
        for r in per_shape:
            log(f"  {name} {tuple(r['shape'])} bits={bits} fused: {r['ms']:.4f} "
                f"ms, plain {r['plain_ms']:.3f} ms, bound {r['bound_ms']:.4f} ms "
                f"({r['bound_by']}), torch._int_mm {r['library_ms']:.4f} ms")
        if name == "quant_gemm":
            # a quant decode step: every site of each layer but wo
            step = [(8, *kn) for (_, leaf), kn in zip(SITE_LEAVES, SITE_SHAPES)
                    if leaf != "wo"]
            log(f"  quant_gemm: the {len(step) * layers} launches of one "
                f"{layers}-layer quant decode step, each timed alone with a "
                f"cold L2, sum to {layers * sum(by[s]['ms'] for s in step):.2f} "
                f"ms (their bounds to "
                f"{layers * sum(by[s]['bound_ms'] for s in step):.2f} ms, "
                f"torch._int_mm's to "
                f"{layers * sum(by[s]['library_ms'] for s in step):.2f} ms)")
    return rows


def _time_block_stats(gen, errs: dict, launches: dict,
                      launches_run: dict) -> dict:
    """block_stats over site-shaped per-tensor 4-bit codes; its bound is
    the code bytes read plus the two int32 statistics written."""
    per_shape = []
    for (m, n) in sorted(set(SITE_SHAPES)):
        q = quantize(torch.randn((m, n), generator=gen, device=DEV),
                     bits=QUANT_BITS, per_channel=False).values
        tiles = -(-m // 32) * -(-n // 32)
        bound_ms = (m * n + 2 * 4 * tiles) / HBM_BYTES_PER_S * 1e3
        per_shape.append({
            "shape": [m, n], "ms": _time_ms(lambda: bs_lib.block_stats(q)),
            "plain_ms": _time_ms(lambda: ref_lib.block_stats_ref(q), reps=5,
                                 warmup=1),
            "bound_ms": bound_ms, "bound_by": "bytes", "library_ms": None})
        del q
    head = next(r for r in per_shape if r["shape"] == list(UP_SHAPE))
    for r in per_shape:
        log(f"  block_stats {tuple(r['shape'])}: {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.3f} ms, bound {r['bound_ms']:.4f} ms (bytes)")
    # the other tiles at the headline shape, and tile 32 with an L2 that the
    # flush left clean: how much of the time is the write-back of the
    # flush's dirty lines (log lines only)
    q = quantize(torch.randn(UP_SHAPE, generator=gen, device=DEV),
                 bits=QUANT_BITS, per_channel=False).values
    log(f"  block_stats {UP_SHAPE} by tile: " + ", ".join(
        f"{t}: {_time_ms(lambda: bs_lib.block_stats(q, tile=t)):.4f} ms"
        for t in bs_lib.TILES))
    clean = _time_ms(lambda: bs_lib.block_stats(q), clean_l2=True)
    log(f"  block_stats {UP_SHAPE} tile 32, the L2 flushed by a read (clean): "
        f"{clean:.4f} ms (written, as above: {head['ms']:.4f} ms)")
    del q
    return {"name": "block_stats", "route": "cuda", "source": SOURCE["block_stats"],
            "replaces": REPLACES["block_stats"],
            "launches": launches.get("block_stats", 0),
            "launches_run": launches_run.get("block_stats"),
            "max_abs_err": errs["block_stats"],
            **{key: head[key] for key in ("ms", "plain_ms", "bound_ms",
                                          "bound_by", "library_ms")},
            "shape": f"M={UP_SHAPE[0]} N={UP_SHAPE[1]} int8 codes, 32x32 tiles",
            "per_shape": per_shape}


# (q/k head dim, V head dim): 128 is the training path's and the table's
# row; 192 / 128 is deepseek-v3's MLA, V zero-padded to 192 for the kernels
FLASH_TIMED_HEAD_DIMS = ((128, 128), (96, 96), (256, 256), (192, 128))


def _time_flash_at(gen, d: int, dv: int, with_plain: bool) -> dict:
    """The three bf16 flash kernels on B=4 x H=32 slabs, S=2048, q/k head
    dim ``d`` and V head dim ``dv`` (the kernels take V zero-padded to ``d``,
    as ``flash_attention`` hands it to them), causal, each beside its bound
    and SDPA on the same tensors (forward; forward + backward for the two
    backward kernels, whose work it computes together, and its backward
    alone); the plain versions too when ``with_plain``.  Bounds and rates
    count the function's work and bytes (:func:`flash_ops` with ``dv``:
    QK^T at d, PV at dv), not the padded work."""
    b, h, s = 4, 32, 2048
    bh, dt = b * h, torch.bfloat16
    q, k = (torch.randn((bh, s, d), generator=gen, device=DEV).to(dt) for _ in range(2))
    v, do = (torch.randn((bh, s, dv), generator=gen, device=DEV).to(dt) for _ in range(2))
    # what flash_attention hands the kernels for a narrower V
    vk, dok = (torch.nn.functional.pad(t, (0, d - dv)) for t in (v, do))
    o, lse = flash_lib.flash_fwd(q, k, vk, causal=True)
    delta = torch.sum(dok.float() * o.float(), dim=-1)
    calls = {
        "flash_fwd": (lambda: flash_lib.flash_fwd(q, k, vk, causal=True),
                      lambda: flash_lib.flash_fwd_plain(q, k, v, causal=True)),
        "flash_bwd_dq": (
            lambda: flash_lib.flash_bwd_dq(q, k, vk, dok, lse, delta, causal=True),
            lambda: flash_lib.flash_bwd_dq_plain(q, k, v, do, lse, delta, causal=True)),
        "flash_bwd_dkv": (
            lambda: flash_lib.flash_bwd_dkv(q, k, vk, dok, lse, delta, causal=True),
            lambda: flash_lib.flash_bwd_dkv_plain(q, k, v, do, lse, delta,
                                                  causal=True)),
    }
    sdpa = torch.nn.functional.scaled_dot_product_attention
    q4, k4 = (t.view(b, h, s, d) for t in (q, k))
    v4, do4 = (t.view(b, h, s, dv) for t in (v, do))
    qg, kg, vg = (t.detach().requires_grad_(True) for t in (q4, k4, v4))

    def sdpa_fwd_bwd():
        out = sdpa(qg, kg, vg, is_causal=True)
        return torch.autograd.grad(out, (qg, kg, vg), do4)

    try:
        lib_fwd = _time_ms(lambda: sdpa(q4, k4, v4, is_causal=True))
    except RuntimeError as exc:          # no SDPA backend for this dv: pad V
        log(f"  SDPA refuses d={d} with dv={dv} ({str(exc)[:80]}); timed on V "
            f"zero-padded to {d}")
        v4, do4 = (t.view(b, h, s, d) for t in (vk, dok))
        vg = v4.detach().requires_grad_(True)
        lib_fwd = _time_ms(lambda: sdpa(q4, k4, v4, is_causal=True))
    with torch.enable_grad():            # the times phase runs under no_grad
        out_g = sdpa(qg, kg, vg, is_causal=True)
        lib_fwd_bwd = _time_ms(sdpa_fwd_bwd)
        lib_bwd = _time_ms(lambda: torch.autograd.grad(
            out_g, (qg, kg, vg), do4, retain_graph=True))
    del out_g
    ops = flash_lib.flash_ops(bh, s, s, d, causal=True, dv=dv)
    qk = bh * s * d * 2                       # one bf16 (BH, S, d) tensor
    vo = bh * s * dv * 2                      # one bf16 (BH, S, dv) tensor
    stats = bh * s * 4                        # one fp32 (BH, S) tensor
    io_bytes = {"flash_fwd": 2 * qk + vo + vo + stats,            # q,k,v -> o, lse
                "flash_bwd_dq": 2 * qk + 2 * vo + 2 * stats + qk,  # q,k,v,dO,lse,delta -> dQ
                "flash_bwd_dkv": 2 * qk + 2 * vo + 2 * stats + qk + vo}
    out = {}
    for name in FLASH:
        kern, plain = calls[name]
        ms = _time_ms(kern)
        plain_ms = _time_ms(plain, reps=5, warmup=1) if with_plain else None
        bytes_ms = io_bytes[name] / HBM_BYTES_PER_S * 1e3
        ops_ms = ops[name] / BF16_OPS_PER_S * 1e3
        library_ms = lib_fwd if name == "flash_fwd" else lib_fwd_bwd
        out[name] = {
            "d": d, "dv": dv, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": library_ms,
            "library_bwd_only_ms": None if name == "flash_fwd" else lib_bwd,
            "tflops": ops[name] / ms / 1e9}
        log(f"  {name} BH={bh} S={s} d={d} dv={dv} bf16 causal: {ms:.3f} ms = "
            f"{ops[name] / ms / 1e9:.1f} TFLOP/s, plain "
            + (f"{plain_ms:.3f} ms" if with_plain else "not timed")
            + f", bound {max(bytes_ms, ops_ms):.4f} ms "
            f"({out[name]['bound_by']}; {ops[name] / 1e9:.1f} GFLOP, "
            f"{io_bytes[name] / 2**20:.0f} MiB), SDPA "
            f"{'forward' if name == 'flash_fwd' else 'forward + backward'} "
            f"{library_ms:.3f} ms"
            + ("" if name == "flash_fwd" else f" (backward alone {lib_bwd:.3f} ms)"))
    del q, k, v, do, vk, dok, o, lse, delta, q4, k4, v4, do4, qg, kg, vg
    return out


def _time_flash(gen, errs: dict, launches: dict, launches_run: dict,
                sass: dict) -> list[dict]:
    """The three flash kernels' rows: the training path's shape (d=128) on
    the row, head dims 96, 256 and MLA's 192 with a 128-wide V beside it
    (``per_head_dim``)."""
    by_d = {d: _time_flash_at(gen, d, dv, with_plain=d == 128)
            for d, dv in FLASH_TIMED_HEAD_DIMS}
    rows = []
    for name in FLASH:
        head = by_d[128][name]
        rows.append({
            "name": name, "route": "cuda", "source": SOURCE[name],
            "replaces": REPLACES[name], "launches": launches.get(name, 0),
            "launches_run": launches_run.get(name), "max_abs_err": errs[name],
            **{key: head[key] for key in ("ms", "plain_ms", "bound_ms", "bound_by",
                                          "library_ms", "library_bwd_only_ms",
                                          "tflops")},
            "library_call": ("scaled_dot_product_attention(is_causal=True) forward"
                             if name == "flash_fwd" else
                             "scaled_dot_product_attention(is_causal=True) forward "
                             "+ backward"),
            "sass_bf16": {str(k): u for k, u in sorted(sass.get(name, {}).items())},
            "shape": "BH=128 (B=4 x H=32) S=2048 d=128 bf16 causal",
            "per_head_dim": [by_d[d][name] for d, _ in FLASH_TIMED_HEAD_DIMS
                             if d != 128]})
    return rows


# ---------------------------------------------------------------------------

def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--layers", type=int, default=32,
                    help="depth of the served model (widths are never cut)")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--phases", default=",".join(ALL_PHASES),
                    help="comma-separated subset, for iterating on one phase")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.stderr.write("chip_smoke: torch.cuda.is_available() is False — this "
                         "check only means something on a CUDA device\n")
        return 2
    phases = args.phases.split(",")
    # fp32 products in full fp32 everywhere (the train probe compares card
    # and CPU at 1e-5); both are PyTorch's defaults for matmuls, stated here
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    errs = {name: math.nan for name in KERNELS}
    launches: dict = {}
    launches_run: dict = {}
    families: dict = {"launches": {}}
    recurrent: dict = {"launches": {}}
    pipeline: dict = {"launches": {}}
    rows: list[dict] = []
    try:
        with torch.no_grad():
            sass = phase_device()
            if "kernels" in phases:
                log("phase kernels")
                errs = phase_kernels()
            if "probes" in phases:
                log("phase probes")
                phase_probes()
            if {"serve", "quant", "plan", "ugemm", "grid"} & set(phases):
                cfg, params = served_model(args.layers)
                for name, phase in (("serve", phase_serve), ("quant", phase_quant),
                                    ("plan", phase_plan), ("ugemm", phase_ugemm),
                                    ("grid", phase_grid)):
                    if name in phases:
                        log(f"phase {name}")
                        served = phase(cfg, params, args.requests)
                        launches.update(served["launches"])
                        launches_run.update(served["launches_run"])
                        del served
                        gc.collect()
                        torch.cuda.empty_cache()
                del cfg, params
        # the served parameters and engines are gone
        gc.collect()
        torch.cuda.empty_cache()
        if "families" in phases:         # trains a MoE: outside no_grad
            log("phase families")
            families = phase_families()
            errs["tub_gemm"] = max(errs["tub_gemm"], families["errs"]["tub_gemm"])
            gc.collect()
            torch.cuda.empty_cache()
        if "recurrent" in phases:        # trains zamba2 and rwkv6: outside no_grad
            log("phase recurrent")
            recurrent = phase_recurrent()
            for name, err in recurrent["errs"].items():
                errs[name] = max(errs[name], err)
            gc.collect()
            torch.cuda.empty_cache()
        if "train" in phases:            # records gradients: outside no_grad
            log("phase train")
            trained = phase_train(TRAIN_LAYERS, TRAIN_STEPS)
            launches.update(trained["launches"])
            launches_run.update(trained["launches_run"])
            gc.collect()
            torch.cuda.empty_cache()
        if "analysis" in phases:         # the CPU and meta only
            log("phase analysis")
            phase_analysis()
        if "pipeline" in phases:         # gradients: outside no_grad
            log("phase pipeline")
            pipeline = phase_pipeline()
            for name, err in pipeline["errs"].items():
                errs[name] = max(errs[name], err)
            gc.collect()
            torch.cuda.empty_cache()
        if "dryrun" in phases:           # trains: outside no_grad
            log("phase dryrun")
            phase_dryrun()
            gc.collect()
            torch.cuda.empty_cache()
        if "times" in phases:
            log("phase times")
            with torch.no_grad():
                rows = phase_times(errs, launches, launches_run, args.layers, sass)
            for row in rows:              # each new path's own launches
                row["launches_families"] = families["launches"].get(row["name"])
                row["launches_recurrent"] = recurrent["launches"].get(row["name"])
                row["launches_pipeline"] = pipeline["launches"].get(row["name"])
    except Failed as exc:
        log(f"FAILED: {exc}")
        return 1
    full = phases == list(ALL_PHASES)
    if full:
        if sorted(row["name"] for row in rows) != sorted(KERNELS):
            log(f"FAILED: the kernels line lists {[r['name'] for r in rows]}, "
                f"want {list(KERNELS)}")
            return 1
        for row in rows:
            if not row["launches"] > 0:
                log(f"FAILED: kernel {row['name']} was never launched on the "
                    f"main path")
                return 1
    log(f"chip_smoke: {'all phases' if full else ','.join(phases)} passed in "
        f"{time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": rows}), flush=True)
    if not full:
        log("partial run: no final result line")
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
