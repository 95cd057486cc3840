"""Host spans of the port, kept in memory.

Off by default.  Inside ``with recording():`` every ``with span(name):``
block records one :class:`Span` — its name, its start and end on
``time.perf_counter_ns()``, the index of the span it opened in (-1 for
none) and a request id (-1 for none) — and :func:`take` returns the records
and clears them::

    with spans.recording():
        engine.run(trace)
    records = spans.take()

A span reads the host clock only: it never synchronizes the device, so it
times what the host did (issuing kernels, waiting in ``.cpu()``), not what
the card did.  Off, :func:`span` tests one flag and returns one shared
do-nothing context.  On, a span appends to five flat lists (no object the
garbage collector tracks) until :func:`take`.  The serving engine runs on
one thread, so one set of lists and one stack of open spans serve the
whole process.
"""

from __future__ import annotations

import contextlib
import time
from typing import NamedTuple

__all__ = ["Span", "span", "recording", "take", "self_times"]


class Span(NamedTuple):
    name: str
    t0: int          # perf_counter_ns at entry
    t1: int          # perf_counter_ns at exit
    parent: int      # index of the enclosing span in the same take(), or -1
    req: int         # request id, or -1


_on = False
# the records, one entry each, in order of entry
_names: list = []
_t0: list = []
_t1: list = []
_parent: list = []
_req: list = []
_open: list = []         # indices of the spans entered and not yet left


class _Off:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, exc_type, exc, tb):
        return False


class _Close:
    """What :func:`span` hands out while recording: the span was opened by
    the call; leaving the block stamps its end."""
    __slots__ = ()

    def __enter__(self):
        return _t0[_open[-1]]

    def __exit__(self, exc_type, exc, tb):
        _t1[_open.pop()] = time.perf_counter_ns()
        return False


_OFF = _Off()
_CLOSE = _Close()


def span(name: str, req: int = -1, start: int = 0):
    """A context that records the span ``name`` while recording is on; use
    it only as ``with span(...):`` (the call opens the span).

    ``start`` — a ``perf_counter_ns`` stamp taken earlier, for a wait the
    caller learns of only when it ends (a request's time in the queue); such
    a span began before the spans open now, so it is recorded as a root.
    Entering it returns the span's start, or None while recording is off.
    """
    if not _on:
        return _OFF
    _open.append(len(_names))
    _names.append(name)
    _req.append(req)
    _t1.append(0)
    if start:
        _parent.append(-1)
        _t0.append(start)
    else:
        _parent.append(_open[-2] if len(_open) > 1 else -1)
        _t0.append(time.perf_counter_ns())
    return _CLOSE


@contextlib.contextmanager
def recording():
    """Record spans in the block (cleared on entry; read them with
    :func:`take`)."""
    global _on
    prev, _on = _on, True
    if not prev:
        take()
    try:
        yield
    finally:
        _on = prev


def take() -> list[Span]:
    """The spans recorded since the last :func:`take` (or since recording
    was switched on), in order of entry; clears them."""
    out = [Span(*r) for r in zip(_names, _t0, _t1, _parent, _req)]
    for column in (_names, _t0, _t1, _parent, _req):
        column.clear()
    return out


def self_times(records: list[Span]) -> dict[str, int]:
    """Nanoseconds of each name's spans not covered by their children,
    summed by name (a root given a past ``start`` counts whole)."""
    out: dict[str, int] = {}
    for s in records:
        out[s.name] = out.get(s.name, 0) + (s.t1 - s.t0)
    for s in records:
        if s.parent >= 0:
            p = records[s.parent].name
            out[p] -= s.t1 - s.t0
    return out
