"""Seconds from the process's start to the end of the warm-up query:
imports, CUDA, the kernels built or loaded, the graph drawn, the plan,
one query."""

LAYER, UNIT, SOURCE, MOVES = "end to end", "s", "host_clock", "setup_s"


def read(run):
    return run.setup_s
