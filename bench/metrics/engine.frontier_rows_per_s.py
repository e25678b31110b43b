"""Frontier rows the engine produced per second of the window spent
outside graph placement: the valid rows after every ENU level of the
accepted chunks, summed over the window's queries."""

LAYER, UNIT, SOURCE, MOVES = "frontier engine", "rows/s", \
    "program_counter", "query_s"


def read(run):
    rows = sum(int(sum(q.extras.get("level_sizes", ()))) for q in run.queries)
    placing = sum(q.extras.get("prepare_s", 0.0) for q in run.queries)
    busy = run.window_s - placing
    if rows == 0 or busy <= 0:
        return None
    return rows / busy
