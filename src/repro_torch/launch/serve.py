"""Serving entry point: ``serve traffic`` on the PyTorch/CUDA port.

    PYTHONPATH=src python -m repro_torch.launch.serve traffic --arch llama3-8b \
        --execute-backend tubgemm_cuda --bits 4 --act-scale per-row

Generates a seeded Poisson traffic trace and serves it through the paged
continuous-batching :class:`repro_torch.serving.ServingEngine` — once under
continuous batching, once under static batching — with every dense site
contracted on ``--execute-backend`` (a simulated design or a ``*_cuda``
kernel mirror) when one is given.  Runs on the card by default; ``--device
cpu`` runs the same code on the kernels' plain versions.  The one-shot
``serve`` and ``plan`` modes, ``--backend-plan``, ``--packed`` and ``--grid``
are not ported yet.
"""

from __future__ import annotations

import argparse

import torch

from repro_torch import backends as backends_lib
from repro_torch import configs
from repro_torch.models import common as common_lib
from repro_torch.models import model as model_lib
from repro_torch.serving import (FUSED_LOGIT_TOL, ServingEngine, TrafficConfig,
                                 fused_vs_gather_probe, generate_trace,
                                 paged_vs_contiguous_probe)


def run_traffic_mode(args, cfg, params) -> int:
    """``serve traffic``: continuous vs static batching on one seeded trace.

    Serves the trace twice through the SAME engine (same paged pool geometry,
    same backend scope) and reports throughput, latency percentiles, batch
    occupancy and Eq.-1 energy per token for both.  Gates (non-zero exit) on:

    * continuous throughput >= static throughput on the same trace,
    * both schedulers completing every request; the per-request token
      streams must also be identical across schedulers — a strict gate on
      the float path and, under --execute-backend, whenever ``--act-scale
      per-row`` is active (per-row activation quantization makes each
      request's integer codes a pure function of its own tokens); under the
      default per-tensor scale the check is informational,
    * under ``--decode-attention fused``: the continuous run replayed on the
      gather oracle samples identical token streams — a strict gate on the
      float path only.  Under --execute-backend it is reported: the page
      walk re-associates the float32 softmax (<= ``FUSED_LOGIT_TOL`` on a
      logit), the next quantizer turns that into whole-code flips wherever
      an activation sits on a rounding tie, and the number of such ties
      grows with width x depth x steps (none seen at smoke size, a first
      flip in every few decode steps at llama3-8b's widths, each moving its
      row's logits by more than the argmax margin; ``chip_smoke.py`` counts
      them),
    * the paged decode step equal to the contiguous ``decode_step``
      reference at fp32, and the fused page walk within ``FUSED_LOGIT_TOL``
      of the gather oracle.
    """
    tcfg = TrafficConfig(num_requests=args.requests,
                         arrival_rate=args.arrival_rate, seed=args.seed)
    trace = generate_trace(tcfg)
    engine_kw = dict(
        max_batch=args.batch, page_size=args.page_size,
        num_pages=args.num_pages, max_seq_len=args.max_seq_len,
        backend=args.execute_backend, bits=args.bits,
        unit_n=args.unit_n, num_units=args.units,
        pricing_design=args.gemm_backend, device=args.device)
    engine = ServingEngine(cfg, params, attention=args.decode_attention,
                           **engine_kw)
    scope = (f"backend {args.execute_backend}@{args.bits}"
             if args.execute_backend else "float model")
    print(f"\n=== serving traffic on {args.arch} [{args.device}]: "
          f"{len(trace)} requests "
          f"(Poisson rate {args.arrival_rate}/step, seed {args.seed}), "
          f"{args.batch} slots, {engine.num_pages} pages x {args.page_size} "
          f"slots, {scope}, energy priced on {engine.energy.design} ===")
    with common_lib.activation_scaling(args.act_scale):
        reports = {name: engine.run(trace, name)
                   for name in ("continuous", "static")}
    print(f"{'scheduler':>12s} {'reqs':>5s} {'tokens':>7s} {'steps':>6s} "
          f"{'tok/step':>9s} {'p50':>6s} {'p99':>7s} {'queue':>6s} "
          f"{'occup':>6s} {'uJ/tok':>9s}")
    for name, r in reports.items():
        print(f"{name:>12s} {r.requests:5d} {r.tokens:7d} {r.steps:6d} "
              f"{r.throughput_tok_per_step:9.3f} {r.latency_p50:6.1f} "
              f"{r.latency_p99:7.1f} {r.queue_delay_mean:6.2f} "
              f"{r.occupancy:6.3f} {r.energy_per_token_uj:9.4f}")
    rc, rs = reports["continuous"], reports["static"]
    ok = True
    gain = rc.throughput_tok_per_step / max(rs.throughput_tok_per_step, 1e-30)
    beats = rc.throughput_tok_per_step >= rs.throughput_tok_per_step
    print(f"continuous vs static on the same trace: {gain:.2f}x throughput, "
          f"p99 latency {rc.latency_p99:.0f} vs {rs.latency_p99:.0f} steps")
    if not beats:
        print("WARNING: continuous batching did not beat static batching")
        ok = False
    complete = (rc.requests == len(trace) == rs.requests)
    same_tokens = rc.request_tokens == rs.request_tokens
    quantized = bool(args.execute_backend)
    strict = (not quantized) or args.act_scale == "per-row"
    note = ("" if not quantized else
            " (strict: per-row act-quant decouples co-batched rows)"
            if strict else
            " (informational: per-tensor act-quant couples co-batched rows)")
    print(f"all {len(trace)} requests completed under both schedulers: "
          f"{complete}; per-request token streams identical: "
          f"{same_tokens}{note}")
    ok = ok and complete and (same_tokens or not strict)
    if args.decode_attention == "fused":
        # replay the continuous run on the gather oracle: the fused page
        # walk may move logits by <= FUSED_LOGIT_TOL, but on the float path
        # the sampled token streams must be identical
        gather_engine = ServingEngine(cfg, params, attention="gather",
                                      weight_cache=engine.weight_cache,
                                      **engine_kw)
        with common_lib.activation_scaling(args.act_scale):
            rg = gather_engine.run(trace, "continuous")
        fused_same = rc.request_tokens == rg.request_tokens
        fnote = (" (informational: quantizer rounding ties amplify the "
                 "page walk's float32 re-association)" if quantized else "")
        print(f"fused vs gather decode token streams (continuous): "
              f"identical: {fused_same}{fnote}")
        ok = ok and (fused_same or quantized)
    diff = paged_vs_contiguous_probe(cfg, params, page_size=args.page_size)
    tag = "exact" if diff == 0.0 else f"max |diff| {diff:.3e}"
    print(f"paged decode vs contiguous decode_step (fp32): {tag}")
    ok = ok and diff == 0.0
    fdiff = fused_vs_gather_probe(cfg, params, page_size=args.page_size)
    print(f"fused page-walk vs gather oracle (fp32): max |dlogit| "
          f"{fdiff:.3e} (tol {FUSED_LOGIT_TOL:.0e})")
    ok = ok and fdiff <= FUSED_LOGIT_TOL
    return 0 if ok else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="serve a seeded traffic trace on the PyTorch/CUDA port")
    ap.add_argument("mode", nargs="?", default="traffic", choices=["traffic"],
                    help="'traffic' serves a seeded Poisson trace through "
                         "the paged continuous-batching engine and compares "
                         "continuous vs static batching (the only mode "
                         "ported so far)")
    ap.add_argument("--arch", default="llama3-8b", choices=list(configs.ARCH_IDS))
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (default: cuda; 'cpu' "
                         "runs the kernels' plain versions)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--gemm-backend", default="tubgemm",
                    choices=["ugemm", "tugemm", "tubgemm", "bgemm"],
                    help="design the energy pricing charges")
    ap.add_argument("--execute-backend", default=None, metavar="SPEC",
                    help="EXECUTE prefill/decode with every quantized dense "
                         "layer contracted on this backend (simulated design "
                         "or *_cuda kernel mirror); one of "
                         f"{', '.join(backends_lib.available())}")
    ap.add_argument("--act-scale", default="per-tensor",
                    choices=["per-tensor", "per-row"],
                    help="activation quantization granularity under backend "
                         "execution; per-row decouples co-batched requests "
                         "and turns the identical-token-stream check into a "
                         "strict gate")
    ap.add_argument("--bits", type=int, default=4, choices=[2, 4, 8])
    ap.add_argument("--unit-n", type=int, default=128)
    ap.add_argument("--units", type=int, default=64)
    ap.add_argument("--requests", type=int, default=12,
                    help="number of requests in the seeded trace")
    ap.add_argument("--arrival-rate", type=float, default=1.0,
                    help="Poisson arrivals per scheduler step")
    ap.add_argument("--seed", type=int, default=0,
                    help="trace seed (arrivals + lengths)")
    ap.add_argument("--page-size", type=int, default=8,
                    help="KV-cache page size in token slots")
    ap.add_argument("--num-pages", type=int, default=None,
                    help="KV pool size in pages (default: every slot can "
                         "hold a worst-case request, +1 trash page)")
    ap.add_argument("--max-seq-len", type=int, default=64,
                    help="per-request position budget (prompt + output)")
    ap.add_argument("--decode-attention", default="fused",
                    choices=["fused", "gather"],
                    help="decode attention path: 'fused' walks each block "
                         "table page-by-page with online softmax (the "
                         "default), 'gather' materializes the padded KV "
                         "view (the exact oracle)")
    args = ap.parse_args(argv)

    if args.execute_backend:
        try:
            backends_lib.resolve(args.execute_backend, bits=args.bits)
        except (KeyError, ValueError) as exc:
            print(f"error: --execute-backend {args.execute_backend!r}: {exc}")
            return 2
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("error: --device cuda requested but no CUDA device is "
              "available (pass --device cpu to run on the CPU)")
        return 2
    cfg = (configs.get_smoke_config(args.arch) if args.smoke
           else configs.get_config(args.arch))
    # Serves with float32 activations whatever the config says.  At
    # bfloat16 the strict float-path fused==gather gate cannot hold: the
    # page walk (like the card's kernel) scores and normalises in float32,
    # while the gather oracle rounds q.k and the softmax weights to
    # bfloat16, enough to flip an argmax at random weights
    # (tests/test_torch_serving.py::test_bf16_fused_vs_gather_cause).
    cfg = cfg.replace(compute_dtype="float32")
    generator = torch.Generator(device=device)
    generator.manual_seed(0)
    params = model_lib.init_params(cfg, generator, device=device)
    return run_traffic_mode(args, cfg, params)


if __name__ == "__main__":
    raise SystemExit(main())
