"""tokens_per_s: every token the window's traces generated (first tokens
included) over the wall time of those traces."""


def read(run):
    w = run.window
    return w.tokens() / w.wall
