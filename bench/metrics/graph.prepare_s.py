"""Seconds a query spends placing the graph (the backend's ``prepare``:
padded rows to the card, or host shards and the row cache), as the
program times it."""

LAYER, UNIT, SOURCE, MOVES = "graph placement", "s", "program_span", \
    "query_s"


def read(run):
    got = [q.extras["prepare_s"] for q in run.queries
           if "prepare_s" in q.extras]
    return sum(got) / len(got) if got else None
