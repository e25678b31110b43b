"""Seconds a traced query spends in the driver's own host work: its
``exec.query`` span less its children (placement and the chunks), the
mean over the traced queries. It takes in the tracer's own bookkeeping
that runs there (opening the chunk spans, booking each chunk's counters,
counting the starts), which a profiler's ranges make dearer."""

LAYER, UNIT, SOURCE, MOVES = "driver", "s", "program_span", "query_s"


def read(run):
    got = []
    for q in run.traced:
        if "trace" not in q.extras:
            continue
        spans = q.extras["trace"]["spans"]
        for i, s in enumerate(spans):
            if s["name"] == "exec.query":
                kids = sum(c["end_ns"] - c["start_ns"] for c in spans
                           if c["parent"] == i)
                got.append((s["end_ns"] - s["start_ns"] - kids) / 1e9)
    return sum(got) / len(got) if got else None
