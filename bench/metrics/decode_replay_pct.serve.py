"""decode_replay_pct.serve: the share of the traced trace's decode steps
(its ``engine.decode`` spans, ``serving/engine.py:ServingEngine.run``)
inside which the port replayed a captured CUDA graph (an
``engine.decode.replay`` span, ``ServingEngine._decode``), in percent.

Read from the program's own spans in the traced trace.  0 where the port
records its decode steps but replays none; None where it records no spans
or no decode step.
"""

from bench import spantrace

spantrace.install()


def read(run):
    program = spantrace.program_of(run)
    decodes = [i for i, s in enumerate(program or ())
               if s[0] == "engine.decode"]
    if not decodes:
        return None
    replayed = set()
    for s in program:
        if s[0] != "engine.decode.replay":
            continue
        i = s[3]                    # the nearest engine.decode above it
        while i >= 0 and program[i][0] != "engine.decode":
            i = program[i][3]
        replayed.add(i)
    return 100.0 * sum(i in replayed for i in decodes) / len(decodes)
