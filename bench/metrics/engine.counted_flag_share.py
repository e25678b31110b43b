"""Share of the flags ENU scans that count-only levels scanned: levels
whose children only RES's count reads, so the engine sums their valid
candidates and builds no child frontier (the program's ENU counters in
``extras["trace"]``, every level of every chunk of the traced queries).
Nothing where the program does not count such flags."""

LAYER, UNIT, SOURCE, MOVES = "frontier engine", "%", "program_counter", \
    "query_s"


def read(run):
    flags = counted = 0
    for q in run.traced:
        if "trace" not in q.extras:
            continue
        for levels in q.extras["trace"]["counters"]["enu"].values():
            if "counted" in levels:
                flags += sum(levels["flags"])
                counted += sum(levels["counted"])
    return 100.0 * counted / flags if flags else None
