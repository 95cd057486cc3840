"""Continuous-batching serving engine over the paged KV cache.

One :class:`ServingEngine` owns a fixed decode batch of ``max_batch`` slots,
a :class:`~repro_torch.serving.paged_kv.PagedKVCache`, and a decode step that
advances *every* slot one token per scheduler step:

* **prefill** (admission): the prompt runs through ``model_lib.prefill``
  (padded to a power-of-two bucket — causal attention makes the valid
  prefix independent of tail padding), its KV is copied into freshly
  allocated pages, and its first token comes off the prompt's last logits;
* **decode** (every step): the step embeds each slot's pending token at its
  own position, scatters the new K/V into its pages
  (``kernels.paged_attention.write_kv_token``, in place), attends over the
  pages with the fused page-walk kernel (or the gather oracle), and emits
  next-token logits.  The step mirrors ``models.blocks._transformer_block``
  op for op — same ``dense`` sites under the same ``site_scope`` names
  (``layers/attn/wq`` …, ``lm_head``) — so a ``use_backend(...)`` or
  ``use_plan(...)`` scope contracts every token on the selected unary
  engine(s) (from bit-packed weight stores under ``packed=True``), and
  paged decode logits equal ``model_lib.decode_step`` exactly whenever the
  requests are aligned.

The layer stack is a Python loop over the leading axis of the stacked
parameters (the reference scans it under ``jit``; eager PyTorch has nothing
to trace, so there is no compiled-prefill cache either).  Block tables,
lengths and pending tokens live on the device and are updated incrementally.
On a CUDA device with no process group the decode step is captured once
as a CUDA graph and replayed at every later step
(:meth:`ServingEngine._decode`): the same kernels on the same buffers,
without the Python loop's launches.  The engine keeps its paged pools from one :meth:`ServingEngine.run` to the next
(zeroed), so that one capture serves every run.
Two host syncs per step are the reference's own and are kept: the ``int()``
of each admission's first token and the copy of the step's sampled tokens.

Evicted/empty slots are kept deterministic: their hidden state is zeroed
after embedding and their block-table rows point at the reserved trash
page, so a freed slot can neither corrupt live pages nor leak
schedule-dependent garbage into the per-tensor activation-quantization
scales of a live backend scope.

Time is counted in scheduler steps (1 decode step each); energy in Eq.-1
dynamic µJ via :class:`~repro_torch.serving.energy.EnergyModel`.  Wall
time is left to :mod:`repro_torch.runtime.spans`: under
``spans.recording()`` :meth:`ServingEngine.run` records ``engine.step``,
``engine.decode`` (issuing the step), ``engine.decode.sync`` (waiting for
its tokens), ``engine.decode.bookkeep``, ``engine.schedule``,
``engine.prefill``, and a request's ``engine.admit`` and ``engine.queue``
(from the start of its arrival step); ``_decode`` records
``engine.decode.capture`` and ``engine.decode.replay`` around a graph's
capture and replay, and an eager step's ``layer.attn`` (``attn.kv_write``,
``attn.attend``) and ``layer.mlp``, which a replay does not run.  Off, each
site costs one flag test.

On a grid with a ``torch.distributed`` process group up, the engine serves
under ``launch.mesh.make_grid_mesh(*grid)``, one PE unit per rank: every
rank runs the same scheduler on the same seeded trace with the same
parameters, each dense site's shards run one per rank
(``GridBackend.execute``), and after every decode step a small
``all_gather`` of the step's token ids checks that every rank sampled the
same tokens (a rank whose scheduler diverged would deadlock in the next
collective); a mismatch raises, naming the rank and the step.

A mixture-of-experts decoder (``cfg.is_moe``, GQA attention, routed experts
only) runs its expert layers through ``models.moe.moe_serve``, in the
prefill and the decode step alike: dropless, rows no request holds (idle
slots, a prefill group's padding) reach no expert, and each local expert's
``w_gate`` / ``w_up`` / ``w_down`` are dense sites (``layers/moe/w_up``).
With a process group up the engine serves with expert parallelism: a
``("model",)`` mesh of the world, each rank holding ``E / world`` experts
of every layer (its own stacks, or the whole ones, sliced), the attention,
router, embedding and head replicated, one ``all_reduce(SUM)`` a layer;
the step stays eager, and the sampled tokens are checked across ranks as
on a grid.  The layer records the spans ``moe``, ``moe.route``,
``moe.dispatch``, ``moe.experts``, ``moe.combine`` and ``moe.exchange``;
:attr:`ServingEngine.expert_rows` counts on the device, by phase, layer
and local expert, the routed rows and the calls with a routed row, read
once a run into ``ServingReport.expert_rows``.
"""

from __future__ import annotations

import contextlib
import dataclasses
from collections import deque

import numpy as np
import torch

from repro_torch import backends as backends_lib
from repro_torch.backends.runtime import site_scope
from repro_torch.kernels import paged_attention as paged_lib
from repro_torch.launch import mesh as mesh_lib
from repro_torch.kernels import paged_attention_fused as fused_lib
from repro_torch.models import attention as attn_lib
from repro_torch.models import model as model_lib
from repro_torch.models import rope as rope_lib
from repro_torch.models.blocks import layer_slice
from repro_torch.models.common import activation_scale_mode, dense, rmsnorm
from repro_torch.models.config import ModelConfig
from repro_torch.models.mlp import mlp_fwd
from repro_torch.models import moe as moe_lib
from repro_torch.runtime import spans
from repro_torch.serving.energy import EnergyModel
from repro_torch.serving.paged_kv import PagedKVCache
from repro_torch.serving.scheduler import (Request, RequestState,
                                           _SchedulerBase, make_scheduler)
from repro_torch.serving.traffic import TrafficRequest

__all__ = ["ServingEngine", "ServingReport", "paged_vs_contiguous_probe",
           "fused_vs_gather_probe", "FUSED_LOGIT_TOL"]

#: gated max |Δlogit| between the fused online-softmax decode path and the
#: exact gather oracle on the fp32 smoke probe — online softmax re-associates
#: the reduction, so exact equality is not the contract; the sampled token
#: streams still must match exactly on the seeded traces.
FUSED_LOGIT_TOL = 1e-4


@dataclasses.dataclass(frozen=True)
class ServingReport:
    """Metrics of one trace served under one scheduler."""
    scheduler: str
    requests: int
    tokens: int
    steps: int
    throughput_tok_per_step: float
    latency_p50: float
    latency_p99: float
    queue_delay_mean: float
    occupancy: float
    energy_uj: float
    energy_per_token_uj: float
    design: str
    bits: int
    max_batch: int
    page_size: int
    num_pages: int
    events: tuple[tuple[int, str, int], ...]
    latencies: tuple[int, ...]
    request_tokens: dict[int, tuple[int, ...]]
    decode_steps: int = 0      # decode ticks actually executed
    prefill_calls: int = 0     # batched prefill forward passes
    # how the decode steps ran: eagerly, or from a graph replay (captured in
    # this run or earlier); decode_eager + decode_replays == decode_steps
    decode_eager: int = 0
    decode_replays: int = 0
    decode_captures: int = 0
    # an MoE engine's ``expert_rows`` for this run, [decode, prefill] x layer
    # x local expert x (routed rows, calls with a routed row); () otherwise
    expert_rows: tuple = ()

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["events"] = [list(e) for e in self.events]
        d["latencies"] = list(self.latencies)
        d["request_tokens"] = {str(k): list(v)
                               for k, v in self.request_tokens.items()}
        return d


@dataclasses.dataclass(eq=False)
class _DecodeGraph:
    """A decode step captured as one CUDA graph, the key it replays under
    (``ServingEngine._graph_key``), and what a replay redoes on the host."""
    key: tuple
    graph: object        # torch.cuda.CUDAGraph
    inputs: tuple        # static tokens, block tables, lengths, active
    outputs: tuple       # static logits, new lengths
    sites: list          # (site, int32 GEMM output buffer), in call order
    calls: list          # the step's ExecutedGemm records
    held: tuple          # what the key names by id, and the weight codes read


def _bucket(n: int, floor: int = 4) -> int:
    """Next power of two >= max(n, floor) — bounds the prefill shapes."""
    b = floor
    while b < n:
        b *= 2
    return b


def _params_device(params) -> torch.device:
    return params["embed"].device


@torch.no_grad()
def paged_vs_contiguous_probe(cfg: ModelConfig, params, *, batch: int = 2,
                              prompt_len: int = 5, steps: int = 3,
                              page_size: int = 4) -> float:
    """Max |paged - contiguous| decode logit difference at fp32 (0.0 = exact).

    Prefills each prompt once (the engine's bucketed prefill), seeds both a
    paged cache and a contiguous cache with that K/V, then runs ``steps``
    aligned decode steps (every slot at the same position, so
    ``model_lib.decode_step``'s scalar ``cache_pos`` applies) through both
    the engine's paged scatter/gather step and the contiguous cache path,
    greedy-feeding each path its own argmax token, and returns the worst
    absolute logit difference seen.  ``page_size`` deliberately defaults to
    a non-divisor of typical prompt lengths so partially filled pages are
    exercised.  The serving CLI, the card check and the tests all gate on
    this returning 0.0.
    """
    cfg = dataclasses.replace(cfg, compute_dtype="float32")
    device = _params_device(params)
    total = prompt_len + steps + 1
    # the gather path is the exactness oracle; the fused path is held to
    # FUSED_LOGIT_TOL by fused_vs_gather_probe instead
    engine = ServingEngine(cfg, params, max_batch=batch, page_size=page_size,
                           max_seq_len=_bucket(total), attention="gather",
                           device=device)
    rng = np.random.default_rng(1234)
    prompts = rng.integers(0, cfg.vocab_size,
                           (batch, prompt_len)).astype(np.int32)
    cache = engine.new_cache()
    btables = np.zeros((batch, cache.max_blocks), np.int32)
    worst = 0.0
    d_prompts = torch.from_numpy(prompts).to(device)
    # The contiguous cache is as wide as the gathered page view, and both
    # sides start from the same prefilled K/V: a float reduction over a
    # zero-padded row is only guaranteed to round identically at equal width.
    caches = model_lib.init_caches(cfg, batch, cache.max_seq_len,
                                   dtype=torch.float32, device=device)
    first = []
    for i in range(batch):
        logits, k_l, v_l = engine._prefill(d_prompts[i: i + 1])
        cache.allocate(i, total)
        cache.write_prefill(i, k_l[:, 0, :prompt_len], v_l[:, 0, :prompt_len])
        caches["attn"]["k"][:, i, :prompt_len] = k_l[:, 0, :prompt_len]
        caches["attn"]["v"][:, i, :prompt_len] = v_l[:, 0, :prompt_len]
        btables[i] = cache.block_table_row(i)
        first.append(torch.argmax(logits[0, prompt_len - 1]))
    tok_ref = torch.stack(first).to(torch.int32)[:, None]
    d_btables = torch.from_numpy(btables).to(device)
    active = torch.ones((batch,), dtype=torch.bool, device=device)
    tok_paged = tok_ref
    for i in range(steps):
        pos = prompt_len + i
        ref_logits, caches = model_lib.decode_step(
            params, cfg, tok_ref, caches=caches, cache_pos=pos)
        lengths = torch.full((batch,), pos, dtype=torch.int32, device=device)
        lg, k_pool, v_pool, _ = engine._decode(
            params, tok_paged, cache.k_pool, cache.v_pool, d_btables,
            lengths, active)
        cache.sync_pools(k_pool, v_pool)
        worst = max(worst, float(torch.max(torch.abs(
            lg[:, 0] - ref_logits[:, 0]))))
        tok_ref = torch.argmax(ref_logits[:, -1:], dim=-1).to(torch.int32)
        tok_paged = torch.argmax(lg[:, :1], dim=-1).to(torch.int32)
    return worst


@torch.no_grad()
def fused_vs_gather_probe(cfg, params, *, batch: int = 2, prompt_len: int = 5,
                          steps: int = 3, page_size: int = 4) -> float:
    """Max |fused − gather| decode logit difference at fp32.

    Runs aligned decode steps through two engines sharing one paged cache —
    one on the fused page-walk kernel, one on the gather oracle — feeding
    both the oracle's argmax token each step, and returns the worst
    absolute logit difference.  The fused path's online softmax
    re-associates the reduction, so the contract is ``<= FUSED_LOGIT_TOL``,
    not exactness; exact parity of the *sampled token streams* on seeded
    traces is asserted separately.
    """
    cfg = dataclasses.replace(cfg, compute_dtype="float32")
    device = _params_device(params)
    total = prompt_len + steps + 1
    kw = dict(max_batch=batch, page_size=page_size,
              max_seq_len=_bucket(total), device=device)
    fused = ServingEngine(cfg, params, attention="fused", **kw)
    gather = ServingEngine(cfg, params, attention="gather", **kw)
    rng = np.random.default_rng(1234)
    prompts = rng.integers(0, cfg.vocab_size,
                           (batch, prompt_len)).astype(np.int32)
    cache = fused.new_cache()
    btables = np.zeros((batch, cache.max_blocks), np.int32)
    worst = 0.0
    d_prompts = torch.from_numpy(prompts).to(device)
    for i in range(batch):
        _, k_l, v_l = gather._prefill(d_prompts[i: i + 1])
        cache.allocate(i, total)
        cache.write_prefill(i, k_l[:, 0, :prompt_len], v_l[:, 0, :prompt_len])
        btables[i] = cache.block_table_row(i)
    d_btables = torch.from_numpy(btables).to(device)
    active = torch.ones((batch,), dtype=torch.bool, device=device)
    tok = d_prompts[:, -1:].to(torch.int32)  # any aligned token works
    for i in range(steps):
        pos = prompt_len + i
        lengths = torch.full((batch,), pos, dtype=torch.int32, device=device)
        args = (d_btables, lengths, active)
        # both paths scatter the same K/V into the shared pools (in place)
        lg_f, _, _, _ = fused._decode(params, tok, cache.k_pool,
                                      cache.v_pool, *args)
        lg_g, k_pool, v_pool, _ = gather._decode(params, tok, cache.k_pool,
                                                 cache.v_pool, *args)
        cache.sync_pools(k_pool, v_pool)
        worst = max(worst, float(torch.max(torch.abs(lg_f - lg_g))))
        tok = torch.argmax(lg_g[:, :1], dim=-1).to(torch.int32)
    return worst


class ServingEngine:
    """Paged continuous/static batching over the backend/plan/grid stack.

    ``grid`` — an optional ``(units_x, units_y)`` PE-array grid: every
    backend the scope resolves is wrapped in a ``GridBackend`` (a
    ``GridPlan`` brings its own), the energy model prices the grid, packed
    stores pack per K band, and the weight-code cache holds each weight's
    shard blocks in place of its flat codes.
    """

    def __init__(self, cfg: ModelConfig, params, *, max_batch: int = 4,
                 page_size: int = 8, num_pages: int | None = None,
                 max_seq_len: int = 64, backend: str | None = None,
                 plan=None, bits: int = 4, grid: tuple[int, int] | None = None,
                 unit_n: int = 64, num_units: int = 64,
                 pricing_design: str | None = None, prompt_seed: int = 0,
                 packed: bool = False, attention: str = "fused",
                 batched_prefill: bool = True, device="cuda",
                 weight_cache: dict | None = None):
        if cfg.attention != "gqa" or cfg.ssm is not None or cfg.rwkv is not None \
                or cfg.family not in ("dense", "audio", "vlm", "moe") \
                or cfg.is_moe != (cfg.family == "moe"):
            raise ValueError(
                "ServingEngine supports the dense GQA transformer family "
                f"(got family={cfg.family!r}, attention={cfg.attention!r})")
        if backend is not None and plan is not None:
            raise ValueError("pass either backend= or plan=, not both")
        if cfg.is_moe and (cfg.moe.num_shared_experts or packed
                           or (grid is not None and mesh_lib.distributed())):
            raise ValueError("ServingEngine serves an MoE model's routed "
                             "experts from float weights, without a grid "
                             "across ranks (got shared experts "
                             f"{cfg.moe.num_shared_experts}, packed={packed}, "
                             f"grid={grid})")
        self.device = model_lib.require_device(device)
        if _params_device(params).type != self.device.type:
            raise ValueError(f"params live on {_params_device(params)}, "
                             f"engine device is {self.device}")
        self.cfg = cfg
        self.params = params
        self.max_batch = max_batch
        self.page_size = page_size
        self.max_seq_len = max_seq_len
        self.backend = backend
        self.plan = plan
        self.bits = bits
        self.grid = grid
        self.prompt_seed = prompt_seed
        blocks_per_req = -(-max_seq_len // page_size)
        # default pool: every slot can hold a worst-case request, +1 trash page
        self.num_pages = (1 + max_batch * blocks_per_req
                          if num_pages is None else num_pages)
        design = pricing_design or backend or "tubgemm"
        # EnergyModel (and any measurement) always reads the FLOAT leaves —
        # Eq.-1 pricing must not depend on the storage format.  Only
        # *execution* switches to the bit-packed store.
        self.energy = EnergyModel(cfg, params, design=design, bits=bits,
                                  unit_n=unit_n, num_units=num_units, grid=grid)
        self.packed = packed
        if packed:
            if backend is None and plan is None:
                raise ValueError("packed=True needs a backend= or plan= "
                                 "scope to fix each site's bit-width")
            self._exec_params = (
                backends_lib.pack_weights(cfg, params, plan, grid=grid)
                if plan is not None
                else backends_lib.pack_weights(cfg, params, bits=bits,
                                               grid=grid))
        else:
            self._exec_params = params
        if attention not in ("fused", "gather"):
            raise ValueError(f"attention must be 'fused' or 'gather', "
                             f"got {attention!r}")
        self.attention = attention
        self.batched_prefill = batched_prefill
        # Under a backend or plan scope each float weight is quantized once
        # per engine and width instead of at every dense call (codes and
        # scales are identical to the per-call path; parameters must not
        # change under the engine).  Packed stores skip the cache: their
        # codes are unpacked at every call, as in the reference.
        # Engines over the same params and bits may share one cache: pass
        # another engine's ``weight_cache``.
        self.weight_cache: dict = {} if weight_cache is None else weight_cache
        #: optional ``callable(site, int32 GEMM output)`` the backend scope of
        #: :meth:`run` reports every contracted site to (None = off)
        self.on_gemm_output = None
        #: the distributed grid mesh (one unit per rank), None on one device
        self.mesh = mesh_lib.grid_mesh(*grid) if grid else None
        #: an MoE model's expert-parallel mesh (the world on ``model``), None
        #: on one device or for a dense model
        self.ep_mesh = None
        #: an MoE model's counter on the device (see ``ServingReport``)
        self.expert_rows = None
        if cfg.is_moe:
            n = mesh_lib.world_size()
            if cfg.moe.num_experts % n:
                raise ValueError(f"{cfg.moe.num_experts} experts do not split "
                                 f"over {n} ranks")
            if n > 1:
                self.ep_mesh = mesh_lib.make_mesh((n,), ("model",),
                                                  self.device.type)
            self.expert_rows = torch.zeros(
                (2, cfg.num_layers, cfg.moe.num_experts // n, 2),
                dtype=torch.int64, device=self.device)
        #: prompt lengths of the prefill call about to run (its rows past
        #: them are padding); None: every row is a prompt's
        self._prefill_lengths: list | None = None
        #: the captured decode step, None until one is captured
        self._graph: _DecodeGraph | None = None
        #: the key of the last step run eagerly for want of a graph; the next
        #: step under the same key is captured
        self._graph_warm: tuple | None = None
        #: decode steps so far by how they ran (see ``ServingReport``)
        self.decode_counts = {"eager": 0, "replays": 0, "captures": 0}
        #: the paged pools of the last :meth:`run`, which the next takes over
        self._run_pools: tuple | None = None

    # -- model steps ----------------------------------------------------------

    def new_cache(self, pools=None) -> PagedKVCache:
        """A fresh paged cache of the engine's geometry (over ``pools``, an
        earlier cache's, zeroed, when given)."""
        cfg = self.cfg
        return PagedKVCache(
            num_layers=cfg.num_layers, num_kv_heads=cfg.num_kv_heads,
            head_dim=cfg.resolved_head_dim, num_pages=self.num_pages,
            page_size=self.page_size, max_seq_len=self.max_seq_len,
            device=self.device, pools=pools)

    @torch.no_grad()
    def _decode(self, params, tokens, k_pool, v_pool, block_tables,
                lengths, active):
        """One ragged decode step for the whole batch (:meth:`_decode_step`).

        On a CUDA device with no ``torch.distributed`` process group, the
        step runs from a CUDA graph.  The first step under a new
        :meth:`_graph_key` runs eagerly (it fills the weight-code cache,
        loads the kernel library and asks the occupancy calculator); the
        next is captured; every later one copies its inputs into the
        graph's static buffers and replays it.  A replay returns the graph's static logits and
        lengths, which the next replay overwrites, and hands the scope's
        ``on_output`` each site's int32 output buffer, in call order (a
        holder that keeps one past the step must copy it).  The kernels'
        ``LAUNCHES`` count their wrappers' calls, so a replay adds nothing
        to them.  Anywhere else every step runs eagerly.
        """
        inputs = (tokens, block_tables, lengths, active)
        execution = backends_lib.active_execution()
        graph = None
        if self._capturable(k_pool.device):
            key = self._graph_key(params, k_pool, v_pool, inputs, execution)
            graph = self._graph
            if graph is None or graph.key != key:
                graph = None
                if self._graph_warm == key:
                    with spans.span("engine.decode.capture"):
                        graph = self._capture(key, execution, params, k_pool,
                                              v_pool, inputs)
                else:
                    self._graph_warm = key
        if graph is None:
            self.decode_counts["eager"] += 1
            return self._decode_step(params, tokens, k_pool, v_pool,
                                     block_tables, lengths, active)
        with spans.span("engine.decode.replay"):
            return self._replay(graph, execution, k_pool, v_pool, inputs)

    @staticmethod
    def _capturable(device: torch.device) -> bool:
        """True iff a decode step on ``device`` may run from a CUDA graph:
        a CUDA device and no process group (under one the engine's grid
        mesh, or a grid plan's backends, reduce with collectives)."""
        return device.type == "cuda" and not mesh_lib.distributed()

    @staticmethod
    def _graph_key(params, k_pool, v_pool, inputs, execution) -> tuple:
        """What a captured step is valid under: the pools' storage and
        shape, every input's shape and dtype (so the batch and the block
        tables' width), the parameters, the activation scaling, and the
        scope's kind, backend, plan, grid and weight-code cache."""
        scope = None if execution is None else (
            type(execution), execution.backend,
            id(getattr(execution, "plan", None)),
            getattr(execution, "grid", None), id(execution.weight_cache))
        return (k_pool.device, k_pool.data_ptr(), v_pool.data_ptr(),
                tuple(k_pool.shape), k_pool.dtype,
                tuple((tuple(t.shape), t.dtype) for t in inputs),
                id(params), activation_scale_mode(), scope)

    def _capture(self, key, execution, params, k_pool, v_pool,
                 inputs) -> _DecodeGraph:
        """Capture :meth:`_decode_step` on copies of ``inputs`` as one CUDA
        graph with its own memory pool, and keep it.  The scope's
        ``on_output`` and ``calls`` are set aside meanwhile: the capture
        records each site's output buffer and record instead."""
        self._graph = None                 # the old graph's pool goes first
        static = tuple(t.clone() for t in inputs)
        sites: list = []
        calls: list = []
        saved = None
        if execution is not None:
            saved = execution.on_output, execution.calls
            execution.on_output = lambda site, out: sites.append((site, out))
            execution.calls = calls
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.device(k_pool.device), torch.cuda.graph(graph):
                logits, _, _, new_lengths = self._decode_step(
                    params, static[0], k_pool, v_pool, *static[1:])
        finally:
            if saved is not None:
                execution.on_output, execution.calls = saved
        cache = None if execution is None else execution.weight_cache
        held = (params, getattr(execution, "plan", None), cache,
                tuple(cache.values()) if cache else ())
        self._graph = _DecodeGraph(
            key=key, graph=graph, inputs=static, outputs=(logits, new_lengths),
            sites=sites, calls=calls, held=held)
        self.decode_counts["captures"] += 1
        return self._graph

    def _replay(self, graph: _DecodeGraph, execution, k_pool, v_pool, inputs):
        """One decode step from ``graph``: copy the inputs that are not its
        static buffers in, replay, then redo what the capture recorded on
        the host (``calls``, ``on_output``)."""
        for static, x in zip(graph.inputs, inputs):
            if x is not static:
                static.copy_(x)
        graph.graph.replay()
        if execution is not None:
            if execution.calls is not None:
                execution.calls.extend(graph.calls)
            if execution.on_output is not None:
                for site, out in graph.sites:
                    execution.on_output(site, out)
        self.decode_counts["replays"] += 1
        logits, new_lengths = graph.outputs
        return logits, k_pool, v_pool, new_lengths

    @torch.no_grad()
    def _decode_step(self, params, tokens, k_pool, v_pool, block_tables,
                     lengths, active):
        """One ragged decode step for the whole batch, run eagerly.

        tokens (B, 1) int32; pools (L, P, page, KVH, hd); block_tables
        (B, max_blocks) int32; lengths (B,) int32 — each slot's own position
        for the incoming token; active (B,) bool.  Mirrors
        ``blocks._transformer_block`` exactly (sites, scopes, op order) with
        the contiguous cache swapped for the paged scatter + page-walk path.
        The pools are updated **in place** and returned.
        """
        cfg = self.cfg
        x = model_lib.embed_in(params, cfg, tokens)          # (B, 1, D)
        x = torch.where(active[:, None, None], x, torch.zeros((), dtype=x.dtype,
                                                              device=x.device))
        positions = lengths[:, None].to(torch.int32)
        valid = lengths + 1

        for i in range(cfg.num_layers):
            lp = layer_slice(params["layers"], i)
            pk, pv = k_pool[i], v_pool[i]
            with site_scope("layers"):
                with spans.span("layer.attn"):
                    h = rmsnorm(lp["ln1"], x, cfg.rms_eps)
                    with site_scope("attn"):
                        q = dense(lp["attn"]["wq"], h, cfg, name="wq")
                        k = dense(lp["attn"]["wk"], h, cfg, name="wk")
                        v = dense(lp["attn"]["wv"], h, cfg, name="wv")
                        with spans.span("attn.kv_write"):
                            q = rope_lib.apply_rope(q, positions, cfg.rope_theta)
                            k = rope_lib.apply_rope(k, positions, cfg.rope_theta)
                            paged_lib.write_kv_token(pk, block_tables, lengths,
                                                     k[:, 0], self.page_size)
                            paged_lib.write_kv_token(pv, block_tables, lengths,
                                                     v[:, 0], self.page_size)
                        with spans.span("attn.attend"):
                            if self.attention == "fused":
                                out = fused_lib.fused_paged_decode_attention(
                                    q, pk, pv, block_tables, valid,
                                    num_heads=cfg.num_heads)
                            else:
                                out = paged_lib.paged_decode_attention(
                                    q, pk, pv, block_tables, valid,
                                    num_heads=cfg.num_heads)
                        out = attn_lib._out_proj(lp["attn"], out, cfg)
                    x = x + out
                with spans.span("layer.mlp"):
                    h2 = rmsnorm(lp["ln2"], x, cfg.rms_eps)
                    if cfg.is_moe:
                        with site_scope("moe"):
                            x = x + moe_lib.moe_serve(
                                lp["moe"], h2, cfg, moe_lib.Serving(
                                    active[:, None], self.expert_rows[0],
                                    self.ep_mesh, gather=False), i)
                    else:
                        with site_scope("mlp"):
                            x = x + mlp_fwd(lp["mlp"], h2, cfg)
        logits = model_lib.logits_out(params, cfg, x)
        # lengths advance on-device so the host never re-uploads them
        new_lengths = torch.where(active, lengths + 1, lengths)
        return logits, k_pool, v_pool, new_lengths

    @torch.no_grad()
    def _prefill(self, tokens):
        """(n, S) padded prompts -> (logits, stacked K, stacked V).  An MoE
        model's rows past ``_prefill_lengths`` (set by :meth:`run` for the
        call) reach no expert."""
        cfg = self.cfg
        caches = model_lib.init_caches(cfg, tokens.shape[0], tokens.shape[1],
                                       dtype=torch.float32,
                                       device=self.device)
        serving = None
        if cfg.is_moe:
            n, width = tokens.shape
            lengths = self._prefill_lengths or [width] * n
            live = (torch.arange(width, device=tokens.device)[None]
                    < torch.tensor(lengths, device=tokens.device)[:, None])
            serving = moe_lib.Serving(live, self.expert_rows[1], self.ep_mesh)
        logits, new = model_lib.prefill(self._exec_params, cfg, tokens,
                                        caches=caches, serving=serving)
        return logits, new["attn"]["k"], new["attn"]["v"]

    # -- host-side serving loop -----------------------------------------------

    def prompt_tokens(self, req: TrafficRequest) -> np.ndarray:
        """Deterministic synthetic prompt for a request (seeded per id)."""
        rng = np.random.default_rng([self.prompt_seed, req.req_id])
        return rng.integers(0, self.cfg.vocab_size,
                            req.prompt_len).astype(np.int32)

    @contextlib.contextmanager
    def _scope(self):
        """The backend or plan scope :meth:`run` serves in (none on the
        float path).  Nothing reads the sites it contracts, so its
        execution keeps no ``calls`` list."""
        if self.plan is None and self.backend is None:
            yield None
            return
        if self.plan is not None:
            scope = backends_lib.use_plan(
                self.plan, grid=self.grid, on_output=self.on_gemm_output,
                weight_cache=self.weight_cache)
        else:
            scope = backends_lib.use_backend(
                self.backend, bits=self.bits, grid=self.grid,
                on_output=self.on_gemm_output,
                weight_cache=self.weight_cache)
        with scope as execution:
            execution.calls = None
            yield execution

    def _check_same_tokens(self, ids: torch.Tensor, step: int,
                           mesh=None) -> None:
        """Raise unless every rank of ``mesh`` (default: the grid's) sampled
        ``ids`` (B,) at this decode step."""
        from repro_torch.launch import collectives as coll
        mesh = self.mesh if mesh is None else mesh
        ids = ids.contiguous()
        n = mesh.size
        every = torch.empty((n * ids.shape[0],), dtype=ids.dtype,
                            device=ids.device)
        coll.all_gather_into(every, ids)
        every = every.view(n, -1)
        differ = (every != ids[None]).any(dim=1)
        if bool(differ.any()):
            ranks = torch.nonzero(differ).flatten().tolist()
            raise RuntimeError(
                f"rank {mesh.rank}: decode step {step} sampled token ids "
                f"{ids.tolist()}, ranks {ranks} sampled others "
                f"({every[ranks].tolist()}): the ranks diverged")

    @torch.no_grad()
    def run(self, trace: tuple[TrafficRequest, ...],
            scheduler: str | _SchedulerBase = "continuous") -> ServingReport:
        """Serve ``trace`` to completion; returns the metrics report.

        Per step: (1) one decode step advances every running request by a
        token (finished ones are evicted at the boundary: pages freed, slot
        zeroed); (2) the scheduler admits arrivals into freed slots —
        admitted requests prefill now (their first token counts this step)
        and join decode from the next step.
        """
        if not trace:
            raise ValueError("empty traffic trace")
        if isinstance(scheduler, str):
            scheduler = make_scheduler(scheduler, self.max_batch)
        if scheduler.max_batch != self.max_batch:
            raise ValueError("scheduler.max_batch != engine max_batch")
        dev = self.device
        cache = self.new_cache(pools=self._run_pools)
        self._run_pools = (cache.k_pool, cache.v_pool)
        counts = dict(self.decode_counts)
        for req in trace:
            if req.total_len > cache.max_seq_len:
                raise ValueError(f"request {req.req_id} needs {req.total_len} "
                                 f"positions > max_seq_len {cache.max_seq_len}")
            if cache.pages_needed(req.total_len) > cache.allocator.capacity:
                raise ValueError(f"request {req.req_id} can never be admitted: "
                                 f"needs {cache.pages_needed(req.total_len)} "
                                 f"pages, pool holds {cache.allocator.capacity}")

        b = self.max_batch
        lengths = np.zeros(b, np.int64)     # host mirror for cache bookkeeping
        active = np.zeros(b, bool)
        slot_req: list[Request | None] = [None] * b
        # hot-path state lives device-resident: block tables and lengths are
        # updated in place at admission/eviction (and lengths advance inside
        # the step itself), so there is no per-step upload of the tables
        d_tokens = torch.zeros((b, 1), dtype=torch.int32, device=dev)
        d_lengths = torch.zeros((b,), dtype=torch.int32, device=dev)
        d_active = torch.zeros((b,), dtype=torch.bool, device=dev)
        d_btables = torch.zeros((b, cache.max_blocks), dtype=torch.int32,
                                device=dev)

        waiting = deque(Request(spec=r)
                        for r in sorted(trace, key=lambda r: (r.arrival_step,
                                                              r.req_id)))
        finished: list[Request] = []
        events: list[tuple[int, str, int]] = []
        req_tokens: dict[int, list[int]] = {r.req_id: [] for r in trace}
        tokens_total = 0
        energy_uj = 0.0
        decode_ticks = 0
        decoded_slots = 0
        prefill_calls = 0
        step = 0
        # perf_counter_ns at each step's start, kept while spans record: a
        # request's queue span runs from its arrival step's start
        step_t0: dict[int, int] = {}
        max_steps = (max(r.arrival_step for r in trace)
                     + 2 * sum(r.output_len + 1 for r in trace) + 16)

        def finish(req: Request, at: int, slot: int) -> None:
            req.state = RequestState.FINISHED
            req.finish_step = at
            cache.free_request(req.req_id)
            slot_req[slot] = None
            active[slot] = False
            lengths[slot] = 0
            d_tokens[slot, 0] = 0
            d_lengths[slot] = 0
            d_active[slot] = False
            d_btables[slot] = 0                     # back to the trash page
            finished.append(req)
            events.append((at, "evict", req.req_id))

        def prefill_admissions(reqs: list[Request]) -> dict:
            """req_id -> (last-logits row, K rows, V rows) for this step's
            admissions — one prefill call per ``_bucket(prompt_len)`` group
            (or per request when ``batched_prefill=False``).

            Causal attention makes each padded prompt's valid prefix
            independent of both the tail padding and the other prompts in
            the batch, so grouping changes nothing a request can see.
            """
            nonlocal prefill_calls
            groups: dict[object, list] = {}
            for req in reqs:
                key = (_bucket(req.spec.prompt_len) if self.batched_prefill
                       else ("solo", req.spec.req_id))
                groups.setdefault(key, []).append(req.spec)
            out = {}
            for specs in groups.values():
                if step_t0:
                    for spec in specs:
                        arrived = step_t0.get(spec.arrival_step)
                        if arrived is not None:  # recorded since its arrival
                            with spans.span("engine.queue", req=spec.req_id,
                                            start=arrived):
                                pass
                with spans.span("engine.prefill"):
                    width = _bucket(max(s.prompt_len for s in specs))
                    padded = np.zeros((len(specs), width), np.int32)
                    for i, spec in enumerate(specs):
                        padded[i, : spec.prompt_len] = self.prompt_tokens(spec)
                    self._prefill_lengths = [s.prompt_len for s in specs]
                    try:
                        logits, k_l, v_l = self._prefill(
                            torch.from_numpy(padded).to(dev))
                    finally:
                        self._prefill_lengths = None
                prefill_calls += 1
                for i, spec in enumerate(specs):
                    out[spec.req_id] = (logits[i, spec.prompt_len - 1],
                                        k_l[:, i, : spec.prompt_len],
                                        v_l[:, i, : spec.prompt_len])
            return out

        def admit(req: Request, at: int, last_logits, k_rows, v_rows) -> None:
            nonlocal tokens_total, energy_uj
            spec = req.spec
            with spans.span("engine.admit", req=spec.req_id):
                cache.allocate(spec.req_id, spec.total_len)
                cache.write_prefill(spec.req_id, k_rows, v_rows)
                first = int(torch.argmax(last_logits))
                slot = next(i for i in range(b) if slot_req[i] is None)
                slot_req[slot] = req
                lengths[slot] = spec.prompt_len
                active[slot] = True
                d_tokens[slot, 0] = first
                d_lengths[slot] = spec.prompt_len
                d_active[slot] = True
                d_btables[slot] = torch.from_numpy(
                    cache.block_table_row(spec.req_id)).to(dev)
            req.state = RequestState.RUNNING
            req.admitted_step = at
            req.slot = slot
            req.generated = 1
            req_tokens[spec.req_id].append(first)
            events.append((at, "admit", spec.req_id))
            tokens_total += 1
            # charged exactly once per admission, at the prompt's TRUE row
            # count (not the padded bucket, not the prefill group size); the
            # first token comes off the prefill's last logits, so no decode
            # tick is charged for it
            energy_uj += self.energy.prefill_energy_uj(spec.prompt_len)
            if req.generated >= spec.output_len:
                finish(req, at, slot)

        ranks = self.mesh if self.mesh is not None else self.ep_mesh
        if self.expert_rows is not None:
            self.expert_rows.zero_()
        mesh = self.mesh if self.mesh is not None else contextlib.nullcontext()
        with mesh, self._scope():
            while waiting or any(active):
                if step > max_steps:
                    raise RuntimeError("serving loop exceeded its step bound "
                                       "— scheduler stuck?")
                with spans.span("engine.step") as t0:
                    if t0 is not None:
                        step_t0[step] = t0
                    # 1) decode the running set (admitted before this step)
                    n_active = int(active.sum())
                    if n_active:
                        with spans.span("engine.decode"):
                            logits, k_pool, v_pool, d_lengths = self._decode(
                                self._exec_params, d_tokens, cache.k_pool,
                                cache.v_pool, d_btables, d_lengths, d_active)
                            cache.sync_pools(k_pool, v_pool)
                            nxt_dev = torch.argmax(logits[:, 0],
                                                   dim=-1).to(torch.int32)
                            d_tokens = nxt_dev[:, None].clone()
                        with spans.span("engine.decode.sync"):
                            if ranks is not None:
                                self._check_same_tokens(nxt_dev, step, ranks)
                            nxt = nxt_dev.cpu().numpy()
                        with spans.span("engine.decode.bookkeep"):
                            decode_ticks += 1
                            decoded_slots += n_active
                            energy_uj += self.energy.decode_energy_uj(n_active)
                            for slot in range(b):
                                req = slot_req[slot]
                                if req is None:
                                    continue
                                lengths[slot] += 1      # KV written for the input
                                cache.lengths[req.req_id] = int(lengths[slot])
                                req.generated += 1
                                req_tokens[req.req_id].append(int(nxt[slot]))
                                tokens_total += 1
                                if req.generated >= req.spec.output_len:
                                    finish(req, step, slot)
                    # 2) step boundary: admit arrivals (join decode next
                    # step); same-step admissions share one prefill call per
                    # bucket
                    with spans.span("engine.schedule"):
                        admitted = scheduler.admissions(step, list(waiting),
                                                        int(active.sum()), cache)
                    if admitted:
                        prefills = prefill_admissions(admitted)
                        for req in admitted:
                            waiting.remove(req)
                            admit(req, step, *prefills[req.spec.req_id])
                step += 1

        lat = np.array([r.latency for r in finished])
        qd = np.array([r.queue_delay for r in finished])
        return ServingReport(
            scheduler=scheduler.name,
            requests=len(finished),
            tokens=tokens_total,
            steps=step,
            throughput_tok_per_step=tokens_total / max(step, 1),
            latency_p50=float(np.percentile(lat, 50)),
            latency_p99=float(np.percentile(lat, 99)),
            queue_delay_mean=float(qd.mean()),
            occupancy=decoded_slots / max(decode_ticks * b, 1),
            energy_uj=energy_uj,
            energy_per_token_uj=energy_uj / max(tokens_total, 1),
            design=self.energy.design,
            bits=self.bits,
            max_batch=b,
            page_size=self.page_size,
            num_pages=self.num_pages,
            events=tuple(events),
            latencies=tuple(int(v) for v in lat),
            request_tokens={k: tuple(v) for k, v in req_tokens.items()},
            decode_steps=decode_ticks,
            prefill_calls=prefill_calls,
            decode_eager=self.decode_counts["eager"] - counts["eager"],
            decode_replays=self.decode_counts["replays"] - counts["replays"],
            decode_captures=self.decode_counts["captures"] - counts["captures"],
            expert_rows=(() if self.expert_rows is None
                         else self.expert_rows.tolist()),
        )
