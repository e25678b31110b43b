"""Share of the flags ENU scans that are valid candidates: every level
of every chunk of the traced queries, whatever its outcome (the
program's ENU counters in ``extras["trace"]``)."""

LAYER, UNIT, SOURCE, MOVES = "frontier engine", "%", "program_counter", \
    "query_s"


def read(run):
    flags = valid = 0
    for q in run.traced:
        if "trace" not in q.extras:
            continue
        for levels in q.extras["trace"]["counters"]["enu"].values():
            flags += sum(levels["flags"])
            valid += sum(levels["valid"])
    return 100.0 * valid / flags if flags else None
