"""Seconds a B-BENU query takes: the window over the queries completed
in it (the last one finished past the deadline, so no work is dropped)."""

LAYER, UNIT, SOURCE, MOVES = "end to end", "s", "host_clock", "query_s"


def read(run):
    return run.window_s / len(run.queries)
