"""Share of the chunks' device time the driver threw away: the device ms
of the chunks it split or retried over every chunk's, in the traced
queries (the program's ``exec.chunk`` spans, booked by outcome in
``extras["trace"]``). A chunk's device ms is the stream's time from a
CUDA event recorded before its upload to one recorded after its last op
is enqueued: it takes in any stretch the card waits on the host issuing
the chunk's ops, so it is stream time, not busy time."""

LAYER, UNIT, SOURCE, MOVES = "driver", "%", "program_span", "query_s"


def read(run):
    got = [q.extras["trace"]["counters"]["device_ms"] for q in run.traced
           if "trace" in q.extras]
    total = sum(sum(ms.values()) for ms in got)
    if total <= 0:
        return None
    return 100.0 * sum(ms["split"] + ms["retried"] for ms in got) / total
