"""The port's own spans in the traced trace, on the profiler's clock.

``repro_torch.runtime.spans`` records host spans inside the serving engine
and the dense sites.  This module runs the traced trace with them switched
on and puts them beside the device trace:

* :func:`profiled` does what ``devtrace.profiled`` does (CUDA activity
  only, the same device operations, the same window and offset) and, inside
  it, records the program's spans; it also keeps the profiler's host-side
  launch events (``cudaLaunchKernel``, ``cudaMemcpyAsync`` and the like),
  which each device operation names by its correlation id.  It appends a
  :class:`SpannedTrace`: the :class:`~bench.devtrace.DeviceTrace` with the
  program's spans moved onto the profiler's clock (``program``) and each
  operation's launch time (``launched``).
* :func:`install` puts :func:`profiled` in the place of
  ``devtrace.profiled``, which ``serve.run_cell`` calls for the traced
  trace only; the metric readers of the program's spans call it when they
  are loaded, which ``run.py`` does before any trace is served.  Untraced
  traces and ``--trace 0`` runs never switch the spans on.

A checkout whose port records no spans (no ``repro_torch.runtime.spans``)
gets an empty ``program``, and the readers return None.

A span reads the host clock only: the device's time comes from the
operations launched inside it.  ``engine.queue`` times a request's wait,
recorded when it ends; it names no gap and takes no launch.
"""

from __future__ import annotations

import contextlib
import dataclasses
import sys
import time

from bench import devtrace

__all__ = ["SpannedTrace", "profiled", "install", "innermost", "program_of",
           "decode_only_steps", "decode_mean_ms", "launched_under", "WAITS"]

#: program spans that time a wait (recorded after the fact, as roots)
WAITS = frozenset({"engine.queue"})


@dataclasses.dataclass
class SpannedTrace(devtrace.DeviceTrace):
    #: program spans on the profiler's clock: (name, t0, t1, parent, req)
    program: list = dataclasses.field(default_factory=list)
    #: each operation's launch on the host (profiler clock), None unmatched
    launched: list = dataclasses.field(default_factory=list)

    def idle_by_span(self, n: int = 32) -> list:
        """Idle device seconds in the window, each gap named by the innermost
        program span the host was in where it starts, else by the
        harness's innermost span there ("other" outside every span)."""
        gaps, prev = [], self.t0
        for a, b in self._intervals():
            if a > prev:
                gaps.append((prev, a))
            prev = max(prev, b)
        if self.t1 > prev:
            gaps.append((prev, self.t1))
        where = innermost(self.program, [a for a, _ in gaps])
        harness = sorted(self.spans, key=lambda s: s[1] - s[0])
        tot: dict = {}
        for (a, b), i in zip(gaps, where):
            if i >= 0:
                name = self.program[i][0]
            else:
                name = next((nm for s0, s1, nm in harness if s0 <= a < s1),
                            "other")
            tot[name] = tot.get(name, 0) + (b - a)
        return [[k, v * 1e-9] for k, v in
                sorted(tot.items(), key=lambda kv: -kv[1])[:n]]


def innermost(program: list, points: list) -> list:
    """For each host time in ``points``, the index in ``program`` of the
    innermost span (:data:`WAITS` left out) open at it, or -1.  The spans
    nest (one thread, entered and left in order)."""
    order = sorted((i for i, s in enumerate(program) if s[0] not in WAITS),
                   key=lambda i: (program[i][1], -program[i][2]))
    out = [-1] * len(points)
    stack: list = []
    j = 0
    for p in sorted((p for p, t in enumerate(points) if t is not None),
                    key=points.__getitem__):
        t = points[p]
        while j < len(order) and program[order[j]][1] <= t:
            while stack and program[stack[-1]][2] <= program[order[j]][1]:
                stack.pop()
            stack.append(order[j])
            j += 1
        while stack and program[stack[-1]][2] <= t:
            stack.pop()
        out[p] = stack[-1] if stack else -1
    return out


def _launches(events, cuda) -> dict:
    """correlation id -> start (ns) of every host-side event a device
    operation can name as its launch."""
    out = {}
    for e in events:
        if e.device_type() != cuda:
            cid = e.correlation_id()
            if cid:
                out[cid] = e.start_ns()
    return out


def _launch_of(e, launches: dict):
    for cid in (e.linked_correlation_id(), e.correlation_id()):
        if cid and cid in launches:
            return launches[cid]
    return None


def print_self_times(trace: SpannedTrace, own: dict) -> None:
    """On standard error, each program span's name with its count, its self
    time on the host (``own``: its duration less its children's, summed),
    largest first, and the operations launched with it innermost and their
    device time."""
    program = trace.program
    count: dict = {}
    for s in program:
        count[s[0]] = count.get(s[0], 0) + 1
    ops: dict = {}
    for (_, a, b), i in zip(trace.ops, innermost(program, trace.launched)):
        name = program[i][0] if i >= 0 else "(no program span)"
        n, t = ops.get(name, (0, 0))
        ops[name] = (n + 1, t + b - a)
    for name, ns in sorted(own.items(), key=lambda kv: -kv[1]):
        n, t = ops.get(name, (0, 0))
        print(f"program span {name}: {count[name]} spans, self {ns * 1e-6:.3f} "
              f"ms, {n} operations launched, {t * 1e-6:.3f} device ms",
              file=sys.stderr)
    n, t = ops.get("(no program span)", (0, 0))
    print(f"program span (none): {n} operations launched outside every "
          f"span, {t * 1e-6:.3f} device ms", file=sys.stderr)


@contextlib.contextmanager
def profiled(out: list):
    """``devtrace.profiled`` with the program's spans recorded in the block
    and the profiler's launch events kept; appends a :class:`SpannedTrace`
    and the perf_counter offset."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    try:
        from repro_torch.runtime import spans
        recording = spans.recording
    except ImportError:          # a port without spans
        spans, recording = None, contextlib.nullcontext
    torch.cuda.synchronize()
    prof = profile(activities=[ProfilerActivity.CUDA])
    prof.start()
    torch.cuda.synchronize()
    offset = time.time_ns() - time.perf_counter_ns()
    t0 = time.time_ns()
    try:
        with recording():
            yield
    finally:
        torch.cuda.synchronize()
        t1 = time.time_ns()
        prof.stop()
    records = spans.take() if spans is not None else []
    cuda = torch.autograd.DeviceType.CUDA
    events = prof.profiler.kineto_results.events()
    launches = _launches(events, cuda)
    ops, launched = [], []
    for e in events:
        if e.device_type() == cuda and e.duration_ns() > 0:
            ops.append((e.name(), e.start_ns(), e.start_ns() + e.duration_ns()))
            launched.append(_launch_of(e, launches))
    program = [(s.name, s.t0 + offset, s.t1 + offset, s.parent, s.req)
               for s in records]
    matched = sum(t is not None for t in launched)
    print(f"spans: {len(program)} program spans; {matched} of {len(ops)} "
          f"device operations matched to one of {len(launches)} host-side "
          f"runtime events", file=sys.stderr)
    trace = SpannedTrace(ops=ops, t0=t0, t1=t1, program=program,
                         launched=launched)
    if records:
        print_self_times(trace, spans.self_times(records))
    out.append((trace, offset))


def install() -> None:
    """Serve the traced trace through :func:`profiled`."""
    devtrace.profiled = profiled


# -- what the readers share ---------------------------------------------------

def program_of(run) -> list | None:
    """The traced trace's program spans, or None where there are none."""
    return getattr(run.trace, "program", None) or None


def decode_only_steps(program: list) -> list:
    """``(engine.step, engine.decode, engine.decode.sync)`` indices of the
    steps that decoded and ran no prefill."""
    kids: dict = {}
    for i, s in enumerate(program):
        if s[3] >= 0 and program[s[3]][0] == "engine.step":
            kids.setdefault(s[3], {}).setdefault(s[0], i)
    return [(step, k["engine.decode"], k["engine.decode.sync"])
            for step, k in sorted(kids.items())
            if "engine.decode" in k and "engine.decode.sync" in k
            and "engine.prefill" not in k]


def decode_mean_ms(run, which: int) -> float | None:
    """Mean host wall, ms, over the decode-only steps of the span at
    ``which`` in :func:`decode_only_steps`'s triples (1: ``engine.decode``,
    2: ``engine.decode.sync``); None where there are none."""
    program = program_of(run)
    steps = decode_only_steps(program) if program else []
    if not steps:
        return None
    return sum(program[k[which]][2] - program[k[which]][1]
               for k in steps) / len(steps) * 1e-6


def _under(program: list, names) -> list:
    """For each span, the index of its nearest ancestor-or-self whose name
    is in ``names``, or -1 (parents precede their children)."""
    out = [-1] * len(program)
    for i, s in enumerate(program):
        out[i] = i if s[0] in names else (out[s[3]] if s[3] >= 0 else -1)
    return out


def launched_under(run, names) -> list | None:
    """For each device operation of the traced trace, the index of the
    program span named in ``names`` in which it was launched (-1 for
    none); None where the trace holds no program spans or no launches."""
    tr, program = run.trace, program_of(run)
    launched = getattr(tr, "launched", ())
    if program is None or all(t is None for t in launched):
        return None
    under = _under(program, frozenset(names))
    return [under[i] if i >= 0 else -1
            for i in innermost(program, launched)]
