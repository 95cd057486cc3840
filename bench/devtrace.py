"""The device trace of one served trace, from ``torch.profiler``.

The profiler records CUDA activity only (kernels, copies, sets), so the
host's Python runs at its untraced pace.  Device intervals and the
harness's own host spans share one clock: the profiler's timestamps are
nanoseconds of the system clock, and the harness's ``perf_counter`` stamps
are moved onto it by one offset taken when the trace starts.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time

__all__ = ["DeviceTrace", "profiled", "host_spans"]


@dataclasses.dataclass
class DeviceTrace:
    ops: list            # (name, start_ns, end_ns) of every device operation
    t0: int              # the traced window, system-clock ns
    t1: int
    spans: list = dataclasses.field(default_factory=list)  # (t0, t1, name)

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) * 1e-9

    def _intervals(self) -> list:
        """Merged device-busy intervals inside the window."""
        iv = sorted((max(a, self.t0), min(b, self.t1)) for _, a, b in self.ops
                    if b > self.t0 and a < self.t1)
        merged: list = []
        for a, b in iv:
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return merged

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self._intervals()) * 1e-9

    def kernel_seconds(self, patterns) -> float:
        """Device seconds of the operations whose name holds every piece of
        one of ``patterns`` (each a tuple of name pieces)."""
        return sum(b - a for name, a, b in self.ops
                   if any(all(p in name for p in pat) for pat in patterns)) * 1e-9

    def top_ops(self, n: int = 10) -> list:
        tot: dict = {}
        for name, a, b in self.ops:
            key = short_name(name)
            tot[key] = tot.get(key, 0) + (b - a)
        return [[k, v * 1e-9] for k, v in
                sorted(tot.items(), key=lambda kv: -kv[1])[:n]]

    def idle_by_span(self, n: int = 10) -> list:
        """Idle device seconds in the window, named by the innermost host
        span in which each gap starts ("other" outside every span)."""
        gaps, prev = [], self.t0
        for a, b in self._intervals():
            if a > prev:
                gaps.append((prev, a))
            prev = max(prev, b)
        if self.t1 > prev:
            gaps.append((prev, self.t1))
        spans = sorted(self.spans, key=lambda s: s[1] - s[0])
        tot: dict = {}
        for a, b in gaps:
            name = next((nm for s0, s1, nm in spans if s0 <= a < s1), "other")
            tot[name] = tot.get(name, 0) + (b - a)
        return [[k, v * 1e-9] for k, v in
                sorted(tot.items(), key=lambda kv: -kv[1])[:n]]


def short_name(name: str) -> str:
    """A kernel's name without its return type, namespaces it was declared
    in anonymously and its argument list, cut to 120 characters."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    depth = 0
    for i, ch in enumerate(name):
        depth += ch == "<"
        depth -= ch == ">"
        if ch == "(" and depth == 0 and i:
            name = name[:i]
            break
    return name[:120]


@contextlib.contextmanager
def profiled(out: list):
    """Profile CUDA activity in the block; appends a :class:`DeviceTrace`
    (its window the block, its spans empty) and the perf_counter offset."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    prof = profile(activities=[ProfilerActivity.CUDA])
    prof.start()
    torch.cuda.synchronize()
    offset = time.time_ns() - time.perf_counter_ns()
    t0 = time.time_ns()
    try:
        yield
    finally:
        torch.cuda.synchronize()
        t1 = time.time_ns()
        prof.stop()
    cuda = torch.autograd.DeviceType.CUDA
    ops = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
           for e in prof.profiler.kineto_results.events()
           if e.device_type() == cuda and e.duration_ns() > 0]
    out.append((DeviceTrace(ops=ops, t0=t0, t1=t1), offset))


def host_spans(rec, offset_ns: int) -> list:
    """The harness's spans of one served trace on the profiler's clock:
    ``trace set-up`` (from the call to the first step), ``decode``
    (a step's decode until its tokens are on the host), ``admission`` (the
    admissions until the next step), ``prefill`` (each prefill call's
    launches, inside an admission)."""
    def ns(t: float) -> int:
        return int(t * 1e9) + offset_ns

    spans = []
    steps = sorted(rec.start)
    if steps:
        spans.append((ns(rec.t_call), ns(rec.start[steps[0]]), "trace set-up"))
    for j, s in enumerate(steps):
        end = rec.start[steps[j + 1]] if j + 1 < len(steps) else rec.t_return
        if s in rec.dec_end:
            spans.append((ns(rec.start[s]), ns(rec.dec_end[s]), "decode"))
            spans.append((ns(rec.dec_end[s]), ns(end), "admission"))
        else:
            spans.append((ns(rec.start[s]), ns(end), "admission"))
    for a, b in rec.prefill:
        spans.append((ns(a), ns(b), "prefill"))
    return spans
