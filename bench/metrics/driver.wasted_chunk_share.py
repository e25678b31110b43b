"""Share of the chunks the driver ran whose result it threw away: a
chunk that overflowed a frontier capacity and was split or retried."""

LAYER, UNIT, SOURCE, MOVES = "driver", "%", "program_counter", "query_s"


def read(run):
    ran = sum(q.chunks_run for q in run.queries)
    if ran == 0:
        return None
    wasted = sum(q.chunks_split + q.chunks_retried for q in run.queries)
    return 100.0 * wasted / ran
