"""The ``serve`` driver: one cell of served traffic through the port's engine.

A run has the cell's family module (``bench/families/``) build the weights
from the seed on the device and the port's engine
(``repro_torch.serving.engine.ServingEngine``) from the cell's engine
options, warms up the cell's prefill widths and decode batch, then serves
consecutive traces (``bench.traffic``) inside
``activation_scaling(act_scale)``, as many as fit ``--seconds`` at the
cell's nominal pace (:func:`trace_count`), and reports over them.

The engine counts time in scheduler steps; wall times come from this file.
:class:`Probe` stands between the engine and its scheduler and wraps two of
its step entries on the instance:

* ``scheduler.admissions(step, ...)`` is called once a step, after that
  step's decoded tokens reached the host (``.cpu()``): the end of the
  step's decode and the start of its admissions;
* ``engine._decode`` is entered at the start of a step that decodes;
* ``engine._prefill`` is entered once per prefill group of an admission.

A request admitted at step ``s`` has its first token on the host when step
``s + 1`` starts (each admission reads its token with ``int()``), and its
``k``-th further token when step ``s + k``'s decode ends.

The engine attributes relied on (PERF.md lists them): ``run(trace,
scheduler)`` returning a report with ``events`` (``(step, "admit" |
"evict", req_id)`` in order) and ``request_tokens``; ``_decode(params,
tokens, k_pool, v_pool, block_tables, lengths, active)``; ``_prefill(tokens)``;
``on_gemm_output``; ``prompt_seed``; ``weight_cache``.  One that is missing
stops the run with an error naming it.
"""

from __future__ import annotations

import dataclasses
import gc
import sys
import time

import numpy as np
import torch

from bench import manifest
from bench import traffic as traffic_lib

__all__ = ["Probe", "TraceRecord", "Window", "serve_window", "CheckPlan",
           "PLAN", "PROGRAM_ATTRS", "longest_positions", "run_cell"]

PROGRAM_ATTRS = ("run", "_decode", "_prefill", "on_gemm_output",
                 "prompt_seed", "weight_cache")
#: request ids of the warm-up trace (apart from every timed trace's)
WARMUP_FIRST_ID = 10 ** 9


@dataclasses.dataclass(frozen=True)
class CheckPlan:
    """What the check compares of a run: the prefill call of the n-th
    admission of trace 0 and its n-th decode step, n drawn from the seed
    in ``[lo, hi)``, and requests until ``sample_tokens`` served tokens."""
    prefill: tuple = (2, 8)
    decode: tuple = (12, 24)
    sample_tokens: int = 256


PLAN = CheckPlan()


def longest_positions(cell: dict) -> int:
    """The most positions a request of the cell's traffic holds: its prompt
    and every served token but the last, which is never fed back."""
    tr = cell["traffic"]
    return int(tr["prompt"][1]) + int(tr["output"][1]) - 1


def _bucket(n: int, floor: int = 4) -> int:
    b = floor
    while b < n:
        b *= 2
    return b


@dataclasses.dataclass
class TraceRecord:
    """What one served trace did, on the host's clock (perf_counter s)."""
    index: int
    requests: tuple
    t_call: float = 0.0
    t_return: float = 0.0
    start: dict = dataclasses.field(default_factory=dict)      # step -> t
    dec_end: dict = dataclasses.field(default_factory=dict)    # step -> t
    admitted: dict = dataclasses.field(default_factory=dict)   # step -> ids
    prefill: list = dataclasses.field(default_factory=list)    # (t0, t1)
    events: tuple = ()
    tokens: dict = dataclasses.field(default_factory=dict)     # id -> tokens

    @property
    def wall(self) -> float:
        return self.t_return - self.t_call

    def by_id(self) -> dict:
        return {r.req_id: r for r in self.requests}

    def admit_steps(self) -> dict:
        return {rid: s for s, kind, rid in self.events if kind == "admit"}

    def token_times(self) -> dict:
        """req id -> the host times its tokens arrived, first token first."""
        out = {}
        evict = {rid: s for s, kind, rid in self.events if kind == "evict"}
        for rid, s in self.admit_steps().items():
            n = len(self.tokens[rid])
            if evict.get(rid) != s + n - 1:
                raise RuntimeError(
                    f"request {rid}: admitted at step {s} with {n} tokens but "
                    f"evicted at step {evict.get(rid)}: the engine no longer "
                    f"emits one token a step after the prefill's")
            out[rid] = [self.start[s + 1]] + [self.dec_end[s + k]
                                              for k in range(1, n)]
        return out

    def decode_slots(self) -> dict:
        """step -> [(req id, position of the token fed)] of the slots a
        decode step advanced, in slot order (the engine gives an admitted
        request the lowest free slot and frees it at eviction)."""
        by_id = self.by_id()
        admits = self.admit_steps()
        # replay admissions and evictions in the engine's order
        out: dict = {}
        slots: list = []
        step_events: dict = {}
        for step, kind, rid in self.events:
            step_events.setdefault(step, []).append((kind, rid))
        last = max(list(self.dec_end) + list(step_events) + [0])
        for s in range(last + 1):
            if s in self.dec_end:
                rows = []
                for i, rid in enumerate(slots):
                    if rid is not None:
                        k = s - admits[rid]
                        rows.append((i, rid, by_id[rid].prompt_len + k - 1))
                out[s] = rows
            for kind, rid in step_events.get(s, ()):
                if kind == "evict":
                    slots[slots.index(rid)] = None
                else:
                    free = [i for i, r in enumerate(slots) if r is None]
                    if free:
                        slots[free[0]] = rid
                    else:
                        slots.append(rid)
        return out

    def prefill_groups(self) -> dict:
        """step -> [[prompt lengths of one prefill call] ...], grouped as the
        engine groups an admission (by prefill width, first seen first)."""
        by_id = self.by_id()
        out = {}
        for s, ids in self.admitted.items():
            groups: dict = {}
            for rid in ids:
                p = by_id[rid].prompt_len
                groups.setdefault(_bucket(p), []).append(p)
            out[s] = list(groups.items())
        return out


class Probe:
    """The benchmark's instruments on one engine (see the module doc)."""

    def __init__(self, engine, scheduler, capture: dict | None = None,
                 sites: tuple = ()):
        for attr in PROGRAM_ATTRS:
            if not hasattr(engine, attr):
                raise RuntimeError(f"the serving engine has no attribute "
                                   f"{attr!r}, which the benchmark reads")
        self.engine = engine
        self.inner = scheduler
        self.name = scheduler.name
        self.max_batch = scheduler.max_batch
        self.rec: TraceRecord | None = None
        self.capture_plan = capture or {}
        #: the reference's site names whose products the check compares
        self.sites = frozenset(sites)
        self.captured: dict = {}
        self._armed: dict | None = None
        self._decode_pending: float | None = None
        self._admission_steps = 0
        self._decode_steps = 0
        self._prefill_in_step = 0
        decode, prefill = engine._decode, engine._prefill
        engine._decode = lambda *a: self._decode(decode, *a)
        engine._prefill = lambda tokens: self._prefill(prefill, tokens)
        engine.on_gemm_output = self._on_gemm

    # -- the scheduler the engine is handed -----------------------------------

    def admissions(self, step, waiting, n_running, cache):
        t = time.perf_counter()
        rec = self.rec
        if self._decode_pending is not None:
            rec.start[step] = self._decode_pending
            rec.dec_end[step] = t
            self._decode_pending = None
        else:
            rec.start[step] = t
        picked = self.inner.admissions(step, waiting, n_running, cache)
        if picked:
            rec.admitted[step] = [r.spec.req_id for r in picked]
            self._admission_steps += 1
        self._prefill_in_step = 0
        self._step_first = picked[0].spec if picked else None
        return picked

    # -- wrapped step entries -------------------------------------------------

    def _decode(self, fn, params, tokens, k_pool, v_pool, tables, lengths,
                active):
        self._decode_pending = time.perf_counter()
        plan = self.capture_plan
        arm = self.rec.index == 0 and self._decode_steps == plan.get("decode")
        self._decode_steps += 1
        if arm:
            self._armed = {"rows": tokens.shape[0], "sites": {}, "seen": {}}
            self.captured["decode"] = dict(
                trace=self.rec.index, ordinal=plan["decode"],
                lengths=lengths.clone(), active=active.clone())
        try:
            return fn(params, tokens, k_pool, v_pool, tables, lengths, active)
        finally:
            if arm:
                self.captured["decode"]["sites"] = self._armed["sites"]
                self._armed = None

    def _prefill(self, fn, tokens):
        t0 = time.perf_counter()
        plan = self.capture_plan
        arm = (self.rec.index == 0 and self._prefill_in_step == 0
               and self._admission_steps - 1 == plan.get("prefill"))
        self._prefill_in_step += 1
        if arm:
            spec = self._step_first
            self._armed = {"rows": spec.prompt_len, "sites": {}, "seen": {}}
        try:
            return fn(tokens)
        finally:
            if arm:
                self.captured["prefill"] = dict(
                    trace=self.rec.index, req_id=spec.req_id,
                    sites=self._armed["sites"])
                self._armed = None
            self.rec.prefill.append((t0, time.perf_counter()))

    def _on_gemm(self, site: str, out: torch.Tensor) -> None:
        armed = self._armed
        if armed is None:
            return
        name = site.rpartition("/")[2]
        if name in self.sites:
            layer = armed["seen"].get(name, 0)      # layers run in order
            armed["seen"][name] = layer + 1
            if layer in self.capture_plan.get("layers", (0,)):
                armed["sites"][(layer, name)] = out[: armed["rows"]].clone()

    # -- one trace ------------------------------------------------------------

    def run_trace(self, index: int, requests: tuple) -> TraceRecord:
        self.rec = rec = TraceRecord(index=index, requests=requests)
        self._admission_steps = self._decode_steps = 0
        self._decode_pending = None
        rec.t_call = time.perf_counter()
        report = self.engine.run(requests, self)
        rec.t_return = time.perf_counter()
        rec.events = tuple(tuple(e) for e in report.events)
        rec.tokens = {int(k): list(v) for k, v in report.request_tokens.items()}
        if report.requests != len(requests):
            raise RuntimeError(f"trace {index}: {report.requests} of "
                               f"{len(requests)} requests finished")
        return rec


@dataclasses.dataclass
class Window:
    """The timed traces of a run and what they imply."""
    traces: list

    @property
    def wall(self) -> float:
        return sum(t.wall for t in self.traces)

    def requests(self) -> int:
        return sum(len(t.requests) for t in self.traces)

    def tokens(self) -> int:
        return sum(len(v) for t in self.traces for v in t.tokens.values())

    def ttft(self) -> list:
        out = []
        for t in self.traces:
            by_id = t.by_id()
            for rid, times in t.token_times().items():
                out.append(times[0] - t.start[by_id[rid].arrival_step])
        return out

    def itl(self) -> list:
        return [b - a for t in self.traces
                for times in t.token_times().values()
                for a, b in zip(times, times[1:])]

    def decode_only_steps(self) -> list:
        """Host walls of the steps that decoded and admitted nothing."""
        out = []
        for t in self.traces:
            for s in t.dec_end:
                if s in t.admitted:
                    continue
                end = t.start.get(s + 1, t.t_return)
                out.append(end - t.start[s])
        return out


def make_probe(cell: dict, engine, seed: int,
               plan: CheckPlan = PLAN) -> Probe:
    """The probe of an engine, set to capture the layer-0 products, at the
    sites of the cell's reference, of the prefill call and the decode step
    of trace 0 that ``plan`` and the seed pick."""
    from repro_torch.serving.scheduler import make_scheduler
    rng = np.random.default_rng([int(seed), 7])
    picks = {"prefill": int(rng.integers(*plan.prefill)),
             "decode": int(rng.integers(*plan.decode))}
    return Probe(engine, make_scheduler(cell["engine"]["scheduler"],
                                        cell["engine"]["max_batch"]), picks,
                 manifest.reference(cell).SITES)


def warm_up(cell: dict, probe: Probe) -> None:
    """Serve the warm-up trace: every prefill width and the decode step."""
    from repro_torch.models.common import activation_scaling
    with activation_scaling(cell["engine"]["act_scale"]):
        probe.run_trace(-1, traffic_lib.warmup_trace(cell["traffic"],
                                                     WARMUP_FIRST_ID))
    probe.captured.clear()


def trace_count(cell: dict, seconds: float) -> int:
    """Traces a window of ``seconds`` serves: the cell's nominal seconds a
    trace (``traffic.trace_seconds``, as measured when the cell was made)
    into ``seconds``, at least two.  A fixed count, and not "until the time
    is up", so that every run of a cell does the same work."""
    return max(2, round(seconds / float(cell["traffic"]["trace_seconds"])))


def serve_window(cell: dict, probe: Probe, traces: int, *,
                 profiled: int | None = None, profiler=None) -> Window:
    """Serve traces ``0 .. traces - 1``; trace ``profiled`` runs under
    ``profiler`` (a callable returning a started profiler context)."""
    from repro_torch.models.common import activation_scaling
    done = []
    with activation_scaling(cell["engine"]["act_scale"]):
        for i in range(traces):
            reqs = traffic_lib.generate(cell["traffic"], i)
            if profiler is not None and i == profiled:
                with profiler():
                    done.append(probe.run_trace(i, reqs))
            else:
                done.append(probe.run_trace(i, reqs))
    return Window(traces=done)


def sample_requests(window: Window, captured: dict, seed: int,
                    sample_tokens: int) -> list:
    """(trace, req id) pairs the check compares: those the captured calls
    served, the request with the most tokens (longest prompt on a tie),
    and others drawn from the seed until ``sample_tokens`` served tokens."""
    chosen: list = []

    def add(t, rid):
        if (t, rid) not in chosen:
            chosen.append((t, rid))

    if "prefill" in captured:
        add(captured["prefill"]["trace"], captured["prefill"]["req_id"])
    if "decode" in captured:
        d = captured["decode"]
        tr = window.traces[d["trace"]]
        for _, rid, _ in tr.decode_slots()[d["step"]]:
            add(d["trace"], rid)
    every = [(t.index, rid) for t in window.traces for rid in sorted(t.tokens)]
    lens = {(t.index, rid): (len(v), t.by_id()[rid].prompt_len)
            for t in window.traces for rid, v in t.tokens.items()}
    add(*max(every, key=lambda k: lens[k]))
    rng = np.random.default_rng([int(seed), 11])
    for j in rng.permutation(len(every)):
        if sum(lens[k][0] for k in chosen) >= sample_tokens:
            break
        add(*every[j])
    return chosen


def decode_step_of(window: Window, captured: dict) -> None:
    """Give the captured decode call its step number (the n-th decode of
    its trace)."""
    if "decode" in captured:
        d = captured["decode"]
        steps = sorted(window.traces[d["trace"]].dec_end)
        d["step"] = steps[d.pop("ordinal")]


def _dense():
    from bench.families import dense
    return dense


@dataclasses.dataclass
class RunView:
    """What a metric reader is handed (``bench/metrics/<name>.py``)."""
    setup_s: float
    window: Window
    sizes: dict
    bits: int
    device_kind: str
    trace: object = None          # devtrace.DeviceTrace of the traced trace
    traced: TraceRecord | None = None
    #: the cell's family module (``bench/families/``) and engine options
    family: object = dataclasses.field(default_factory=_dense)
    engine: dict = dataclasses.field(default_factory=dict)
    #: the cards the run holds, one rank each, and the reading rank's
    chips: int = 1
    rank: int = 0

    @property
    def untraced(self) -> Window:
        """The window's traces that ran without the profiler: what a
        per-layer metric on the host's clock reads."""
        return Window(traces=[t for t in self.window.traces
                              if t is not self.traced])


def run_cell(cell: dict, seed: int, seconds: float, trace: bool, *,
             t_start: float, metrics: list, device="cuda",
             on_window_closed=None, marks: tuple = (),
             plan: CheckPlan = PLAN, rank: int = 0, world: int = 1,
             phase=None) -> dict:
    """One run of a served cell; returns the result line's object.

    ``metrics``: the metric entries to report (``manifest.metrics_for``);
    ``on_window_closed()``: called once the window has closed, before
    anything else reads the run (the harness checks ``sys.modules`` there);
    ``marks``: ``(what, perf_counter)`` stamps of the caller's set-up;
    ``rank`` of ``world``: this process's card among the cell's (every
    rank serves the same traces in lockstep and judges its own window;
    ``run.py`` profiles and reads metrics on rank 0 alone); ``phase(what)``:
    called as each phase of the run starts.
    """
    from bench import check as check_lib
    from bench import devtrace
    phase = phase or (lambda what: None)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(device)
    family = manifest.family(cell)
    sizes = family.sizes_of(cell["configuration"], longest_positions(cell))
    t_build = time.perf_counter()
    phase("weights and engine")
    params, engine = family.build(cell, sizes, seed, dev, rank=rank,
                                  world=world)
    probe = make_probe(cell, engine, seed, plan)
    t_warm = time.perf_counter()
    phase("warm-up")
    warm_up(cell, probe)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    setup_s = time.perf_counter() - t_start
    last = t_start
    parts = []
    for what, t in marks:
        parts.append(f"{t - last:.2f} s {what}")
        last = t
    print(f"set-up: {', '.join(parts + [''])}"
          f"{t_build - last:.2f} s to the first weight, "
          f"{t_warm - t_build:.2f} s weights and engine, "
          f"{t_start + setup_s - t_warm:.2f} s warm-up (the kernel library's "
          f"build included on a checkout's first run)", file=sys.stderr)
    traced_out: list = []
    phase("window")
    window = serve_window(
        cell, probe, trace_count(cell, seconds), profiled=1 if trace else None,
        profiler=(lambda: devtrace.profiled(traced_out)) if trace else None)
    if on_window_closed is not None:
        on_window_closed()
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    kind = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    view = RunView(setup_s=setup_s, window=window, sizes=sizes,
                   bits=cell["engine"]["bits"], device_kind=kind,
                   family=family, engine=cell["engine"], chips=world,
                   rank=rank)
    if trace:
        dtrace, offset = traced_out[0]
        view.traced = window.traces[1]
        dtrace.spans = devtrace.host_spans(view.traced, offset)
        view.trace = dtrace
        if dtrace.ops:
            first = min(a for _, a, _ in dtrace.ops) - dtrace.t0
            last = max(b for _, _, b in dtrace.ops) - dtrace.t0
            print(f"trace: {len(dtrace.ops)} device operations from "
                  f"{first * 1e-6:.3f} ms to {last * 1e-6:.3f} ms of a "
                  f"{dtrace.window_s * 1e3:.3f} ms window", file=sys.stderr)
    values = {}
    for m in metrics:
        v = manifest.reader(m["name"]).read(view)
        if v is not None:
            values[m["name"]] = {"value": v, "unit": m["unit"]}
    captured = probe.captured
    decode_step_of(window, captured)
    chosen = sample_requests(window, captured, seed, plan.sample_tokens)
    # the engine's weight codes, caches and pools go before the reference
    engine.weight_cache.clear()
    del probe, engine
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    phase("check")
    correct, compared = check_lib.judge(cell, sizes, params, window, captured,
                                        chosen, prompt_seed=int(seed),
                                        rank=rank, world=world)
    for t in window.traces:
        print(f"trace {t.index}: {t.wall:.3f} s, {len(t.start)} steps, "
              f"{len(t.dec_end)} decodes, {len(t.admitted)} admissions",
              file=sys.stderr)
    print(f"run: set-up {setup_s:.1f} s, {len(window.traces)} traces "
          f"({window.requests()} requests) in {window.wall:.1f} s, check "
          f"{time.perf_counter() - t_check:.1f} s over {len(chosen)} requests",
          file=sys.stderr)
    attempted = window.requests()
    finished = sum(len(t.tokens) for t in window.traces)
    out = {"correct": bool(correct), "attempted": attempted,
           "failed": attempted - finished, "metrics": values,
           "device": {"platform": "gpu" if dev.type == "cuda" else dev.type,
                      "kind": kind, "count": world,
                      "memory_peak_bytes": int(peak)}}
    if trace:
        out["device"]["busy_s"] = view.trace.busy_s
        out["device"]["window_s"] = view.trace.window_s
        out["breakdown"] = {"device_ops": view.trace.top_ops(),
                            "idle_gaps": view.trace.idle_by_span()}
    out["check"] = compared
    return out
