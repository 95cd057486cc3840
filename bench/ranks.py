"""One process a card: the launcher of a cell that holds several cards.

``bench/run.py`` (and ``bench/control.py``) runs a cell of ``chips > 1`` as
``chips`` processes of itself, rank ``r`` on card ``r``, each given
``--rank r --world n --init tcp://127.0.0.1:<port>``: one NCCL group
(``gloo`` on the CPU) over a loopback store.  Every rank builds its share
of the weights, warms up and serves the same traces in lockstep.  A rank
announces each phase on standard error (``phase: <what>``); the launcher
passes every rank's standard error on, each line prefixed with its rank,
and hands back what each rank printed on standard output.

The launcher watches the ranks.  If one exits with another code than 0, or
the run passes its wall limit (the workload file's ``limit_s``, else
:data:`LIMIT_S`, counted from the launcher's start), it kills every rank
and what each started (a session of its own; a rank also dies with the
launcher) and returns non-zero, naming the rank and its last phase.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import queue
import signal
import socket
import subprocess
import sys
import threading
import time

__all__ = ["LIMIT_S", "PHASES", "launch", "merged", "result_line",
           "add_options", "join"]

#: the wall limit of a run of several ranks, where the workload file gives
#: none: under the 360 s a run has, with room to stop every rank
LIMIT_S = 330.0
#: the phases a rank announces, in order
PHASES = ("start", "process group", "weights and engine", "warm-up",
          "window", "check", "done")
PREFIX = "phase: "


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def add_options(ap: argparse.ArgumentParser) -> None:
    """The options the launcher gives a rank (``--device`` apart), hidden
    from ``--help``."""
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--world", type=int, default=1, help=argparse.SUPPRESS)
    ap.add_argument("--init", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--t0", type=float, default=None, help=argparse.SUPPRESS)


def join(args):
    """In a rank: have the kernel kill it when the launcher dies
    (``prctl(PR_SET_PDEATHSIG, SIGKILL)``), join the process group, and
    return the rank's device."""
    from repro_torch.launch import mesh as mesh_lib
    ctypes.CDLL(None, use_errno=True).prctl(1, signal.SIGKILL)
    return mesh_lib.init_distributed(args.device, init_method=args.init,
                                     rank_=args.rank, world=args.world)


class _Rank:
    """One rank's process and what it has said."""

    def __init__(self, index: int, cmd: list):
        self.index = index
        self.phase = "start"
        self.stdout: list = []
        self.proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            start_new_session=True)

    def kill(self) -> None:
        if self.proc.poll() is None:
            try:
                os.killpg(self.proc.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass


def _pump_err(rank: _Rank, lock: threading.Lock) -> None:
    for line in rank.proc.stderr:
        if line.startswith(PREFIX):
            rank.phase = line[len(PREFIX):].strip()
        with lock:
            sys.stderr.write(f"[rank {rank.index}] {line}")
            sys.stderr.flush()


def _pump_out(rank: _Rank) -> None:
    rank.stdout.extend(rank.proc.stdout)


def _wait(rank: _Rank, done: queue.Queue) -> None:
    done.put((rank.index, rank.proc.wait()))


def _phases(ranks, skip: int = -1) -> str:
    return ", ".join(f"rank {r.index} in phase {r.phase!r}" for r in ranks
                     if r.index != skip)


def launch(script, args: list, world: int, *, device: str = "cuda",
           limit_s: float = LIMIT_S, t_start: float | None = None
           ) -> tuple[int, list | None, str]:
    """Run ``python3 <script> <args>`` as ``world`` ranks on ``device``
    (``cuda``: rank ``r`` on card ``r``; ``cpu``: ``gloo``).

    ``t_start``: the launcher's start (``perf_counter``), from which the
    limit and rank 0's set-up are counted.  Returns ``(exit code, each
    rank's standard output or None, why it failed)``.
    """
    t_start = time.perf_counter() if t_start is None else t_start
    deadline = t_start + limit_s
    wall_start = time.time() - (time.perf_counter() - t_start)
    init = f"tcp://127.0.0.1:{_free_port()}"
    ranks: list = []
    threads: list = []
    done: queue.Queue = queue.Queue()
    lock = threading.Lock()
    failed = None
    try:
        for r in range(world):
            ranks.append(_Rank(r, [
                sys.executable, str(script), *args, "--rank", str(r),
                "--world", str(world), "--init", init, "--device", device,
                "--t0", repr(wall_start)]))
        for rank in ranks:
            for fn, extra in ((_pump_err, (lock,)), (_pump_out, ()),
                              (_wait, (done,))):
                t = threading.Thread(target=fn, args=(rank, *extra),
                                     daemon=True)
                t.start()
                threads.append(t)
        left = world
        while left:
            try:
                index, code = done.get(
                    timeout=max(0.0, deadline - time.perf_counter()))
            except queue.Empty:
                order = [PHASES.index(r.phase) if r.phase in PHASES else -1
                         for r in ranks]
                behind = [r for r, o in zip(ranks, order) if o == min(order)]
                failed = (1, f"the run passed its limit of {limit_s:g} s; "
                             f"{_phases(behind)} lagged furthest (of "
                             f"{_phases(ranks)})")
                break
            left -= 1
            if code != 0:
                rank = ranks[index]
                failed = (code if code > 0 else 1,
                          f"rank {index} of {world} exited with code {code} "
                          f"in phase {rank.phase!r} (then "
                          f"{_phases(ranks, skip=index)})")
                break
    finally:
        for rank in ranks:
            rank.kill()
        for rank in ranks:
            rank.proc.wait()
        for t in threads:
            t.join(timeout=10)
    if failed is not None:
        return failed[0], None, failed[1] + "; every rank stopped"
    return 0, ["".join(r.stdout) for r in ranks], ""


def merged(lines: list) -> dict:
    """Rank 0's object of ``lines`` (one a rank), ``correct`` only where
    every rank's check passed and each compared number the worst (largest)
    that any rank read: every number passes at or under its limit."""
    out = dict(lines[0])
    out["correct"] = all(o["correct"] for o in lines)
    # the last key, as before
    out["check"] = {name: dict(c, value=max(o["check"][name]["value"]
                                            for o in lines))
                    for name, c in out.pop("check").items()}
    return out


def result_line(outputs: list) -> str:
    """The result line of a run of several ranks (each rank's last line of
    ``outputs``): :func:`merged`, with ``device.count`` the number of
    ranks and ``memory_peak_bytes`` the largest of every rank's."""
    last = [json.loads(o.strip().splitlines()[-1]) for o in outputs]
    peaks = [last[0]["device"]["memory_peak_bytes"]]
    peaks += [o["memory_peak_bytes"] for o in last[1:]]
    print("ranks: " + ", ".join(
        f"rank {r} peak {p} bytes, correct {o['correct']}"
        for r, (p, o) in enumerate(zip(peaks, last))), file=sys.stderr)
    out = merged(last)
    out["device"]["count"] = len(outputs)
    out["device"]["memory_peak_bytes"] = max(peaks)
    return json.dumps(out)
