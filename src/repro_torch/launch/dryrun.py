"""Dry run on one device: trace every (arch x shape) step on ``meta`` and
record its cost, memory and roofline terms.

Where the reference lowers and compiles each cell on 256- or 512-chip XLA
meshes and reads the compiled HLO, the port runs the step itself once on
the ``meta`` device — shapes only, no FLOPs, no memory — under
:class:`repro_torch.launch.hlo_cost.CostCounter`: the train step (loss,
autograd gradients, AdamW update in place), prefill into ``seq_len``
caches, or one decode token against a full ``seq_len`` cache.  The mesh is
the one device (``"mesh": "1"``, ``"chips": 1``); ``--multi-pod`` and
``--both`` ask for the reference's production meshes, which
``launch.mesh.make_production_mesh`` refuses in a world of another size
than theirs (512 ranks for the multi-pod mesh).  One device
has no expert parallelism, so the reference's ``--ep-impl`` has no
counterpart.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3-8b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out /tmp/dryrun

Writes one JSON per cell to ``--out`` (default ``experiments/dryrun_torch``)
with the reference's keys.  ``cost_analysis`` and ``hlo_cost`` hold the
same counts: eager dispatch has no scanned loop for a built-in analysis to
undercount.  ``memory_analysis`` holds the argument bytes (parameters,
optimizer state, inputs and caches: exact), the output bytes (every tensor
the step returns, state updated in place included, as XLA counts donated
outputs) and the trace's peak live bytes on top of the arguments: the
eager path's, with the flash kernels as the card runs them (no score
tile) and the cached path's plain attention as it is (``hlo_cost``).
"""

from __future__ import annotations

import argparse
import json
import os
import time
import traceback

import torch

from repro_torch import configs
from repro_torch.analysis.jaxpr_scan import abstract_params
from repro_torch.eval.planner import _walk
from repro_torch.launch import hlo_cost, hlo_stats
from repro_torch.launch import steps as steps_lib
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import model as model_lib
from repro_torch.models.config import ModelConfig
from repro_torch.optim import AdamWConfig, adamw_init

__all__ = ["model_flops", "lower_cell", "trace_step", "run_cell",
           "tree_bytes"]

DEFAULT_OUT = os.path.join("experiments", "dryrun_torch")


def _param_sizes(cfg: ModelConfig):
    """(total, matmul_active) parameter counts from defs (no allocation)."""
    total = active = 0.0
    expert_frac = None
    if cfg.is_moe:
        expert_frac = cfg.moe.top_k / cfg.moe.num_experts
    for path, d in _walk(model_lib.model_defs(cfg)):
        names = path.split("/")
        sz = 1.0
        for s in d.shape:
            sz *= s
        total += sz
        if len(d.shape) < 2:
            continue
        if "embed" in names and not cfg.tie_embeddings:
            continue  # lookup table: no matmul flops (lm_head counted separately)
        frac = 1.0
        if expert_frac is not None and "moe" in names and names[-1] in (
                "w_gate", "w_up", "w_down") and "shared" not in names:
            frac = expert_frac
        active += sz * frac
    return total, active


def model_flops(cfg: ModelConfig, shape_name: str) -> float:
    """Assignment convention: 6·N·D train / 2·N·D inference (N = active)."""
    sh = configs.SHAPES[shape_name]
    _, active = _param_sizes(cfg)
    if sh["step"] == "train":
        return 6.0 * active * sh["global_batch"] * sh["seq_len"]
    if sh["step"] == "prefill":
        return 2.0 * active * sh["global_batch"] * sh["seq_len"]
    return 2.0 * active * sh["global_batch"]  # decode: one token per request


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)
    elif hasattr(tree, "__dataclass_fields__"):     # TrainState, OptState
        for f in tree.__dataclass_fields__:
            yield from _tensors(getattr(tree, f))


def tree_bytes(tree) -> int:
    """Bytes of the distinct tensors in a tree of dicts, lists, tuples and
    dataclasses (a ``TrainState``, say), each tensor counted once."""
    seen = {id(t): t for t in _tensors(tree)}
    return sum(t.numel() * t.element_size() for t in seen.values())


def _abstract_train_state(cfg: ModelConfig, opt_cfg: AdamWConfig):
    params = steps_lib._trainable(abstract_params(cfg))
    return steps_lib.TrainState(params=params, opt=adamw_init(params, opt_cfg),
                                step=torch.zeros((), dtype=torch.int32))


def trace_step(cfg: ModelConfig, step: str, batch: int, seq_len: int,
               opt_cfg: AdamWConfig | None = None) -> dict:
    """Run one ``step`` ("train", "prefill" or "decode") of ``cfg`` on
    ``meta`` at ``batch`` x ``seq_len`` under a cost counter, its inputs
    ``steps.step_inputs``.

    Returns ``{"cost": HloCost, "argument_bytes", "output_bytes"}``.  The
    train step's AdamW state is bf16 for an FSDP config, as the reference
    picks it, unless ``opt_cfg`` is given.
    """
    inputs = steps_lib.step_inputs(cfg, step, batch, seq_len)
    inputs.pop("cache_pos", None)        # the decode position is seq_len - 1
    counter = hlo_cost.CostCounter()
    if step == "train":
        if opt_cfg is None:
            opt_cfg = AdamWConfig(
                state_dtype="bfloat16" if cfg.fsdp else "float32")
        state = _abstract_train_state(cfg, opt_cfg)
        args = (state, inputs)
        with counter:
            out = steps_lib.make_train_step(cfg, opt_cfg)(state, inputs)
    else:
        params = abstract_params(cfg)
        caches = steps_lib.cache_input_specs(cfg, batch, seq_len)
        args = (params, inputs, caches)
        with torch.no_grad(), counter:
            if step == "prefill":
                out = model_lib.prefill(params, cfg, inputs.get("tokens"),
                                        caches=caches,
                                        embeds=inputs.get("embeds"))
            else:
                # the last slot: one token against a full seq_len cache
                out = model_lib.decode_step(params, cfg, inputs["tokens"],
                                            caches=caches,
                                            cache_pos=seq_len - 1)
    return {"cost": counter.cost(), "argument_bytes": tree_bytes(args),
            "output_bytes": tree_bytes(out)}


def lower_cell(cfg: ModelConfig, shape_name: str) -> dict:
    """Trace the cell's step on ``meta`` (see :func:`trace_step`)."""
    sh = configs.SHAPES[shape_name]
    return trace_step(cfg, sh["step"], sh["global_batch"], sh["seq_len"])


def run_cell(arch: str, shape_name: str, multi_pod: bool = False,
             out_dir: str | None = DEFAULT_OUT,
             cfg: ModelConfig | None = None) -> dict:
    """Trace one cell and write its JSON record (``out_dir`` None: none).
    ``cfg`` overrides the published config (a cut, say)."""
    if multi_pod:
        make_production_mesh(multi_pod=True)   # raises below 512 ranks
    cfg = configs.get_config(arch) if cfg is None else cfg
    rec = {"arch": arch, "shape": shape_name, "mesh": "1", "chips": 1}
    t0 = time.perf_counter()
    traced = lower_cell(cfg, shape_name)
    rec["trace_s"] = round(time.perf_counter() - t0, 1)
    hc = traced["cost"]
    rec["cost_analysis"] = {"flops": hc.flops, "bytes accessed": hc.bytes_accessed}
    rec["memory_analysis"] = {
        "argument_size_in_bytes": traced["argument_bytes"],
        "output_size_in_bytes": traced["output_bytes"],
        "temp_peak_live_bytes_eager": int(hc.peak_live_bytes)}
    rec["hlo_cost"] = {"flops": hc.flops, "bytes": hc.bytes_accessed,
                       "collective_bytes": hc.collective_bytes,
                       "coll_by_op": hc.coll_by_op,
                       "coll_counts": hc.coll_counts}
    mf = model_flops(cfg, shape_name)
    terms = hlo_stats.roofline(rec["cost_analysis"], hlo_stats.no_collectives(),
                               rec["chips"], mf)
    rec["roofline"] = {
        "compute_s": terms.compute_s, "memory_s": terms.memory_s,
        "collective_s": terms.collective_s, "dominant": terms.dominant,
        "model_flops": mf,
        "useful_flops_ratio": terms.useful_flops_ratio,
        "roofline_fraction": terms.roofline_fraction,
        "step_time_s": terms.step_time_s,
    }
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        tag = f"{arch}_{shape_name}_{rec['mesh']}"
        with open(os.path.join(out_dir, tag.replace("/", "-") + ".json"), "w") as f:
            json.dump(rec, f, indent=1)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch", default=None, choices=list(configs.ARCH_IDS))
    ap.add_argument("--shape", default=None, choices=list(configs.SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true",
                    help="the reference's 2x16x16 mesh: refused on one device")
    ap.add_argument("--both", action="store_true",
                    help="one device and the 2x16x16 mesh: refused likewise")
    ap.add_argument("--out", default=DEFAULT_OUT)
    args = ap.parse_args(argv)

    if args.all:
        cells = configs.cells()
    else:
        if not args.arch or not args.shape:
            ap.error("--arch and --shape required unless --all")
        if not configs.shape_applicable(configs.get_config(args.arch), args.shape):
            print(f"SKIP {args.arch} x {args.shape}: long_500k needs "
                  "sub-quadratic attention")
            return 0
        cells = [(args.arch, args.shape)]

    pods = [False, True] if args.both else [args.multi_pod]
    failures = 0
    for arch, shape in cells:
        for mp in pods:
            tag = f"{arch} x {shape} x {'2x16x16' if mp else '1'}"
            try:
                rec = run_cell(arch, shape, mp, args.out)
                r = rec["roofline"]
                print(f"OK   {tag}: trace={rec['trace_s']}s "
                      f"dominant={r['dominant']} "
                      f"terms=({r['compute_s']:.2e},{r['memory_s']:.2e},"
                      f"{r['collective_s']:.2e})s "
                      f"useful={r['useful_flops_ratio']:.2f}", flush=True)
            except Exception:  # noqa: BLE001 — report every cell, then fail
                failures += 1
                print(f"FAIL {tag}\n{traceback.format_exc()}", flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
