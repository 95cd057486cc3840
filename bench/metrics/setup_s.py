"""setup_s: seconds from the start of the process to the first timed trace:
imports, the kernel library (built on a checkout's first run, loaded after),
the weights drawn from the seed, the engine and its energy model, the
warm-up trace."""


def read(run):
    return run.setup_s
