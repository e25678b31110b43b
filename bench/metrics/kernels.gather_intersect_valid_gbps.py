"""GB/s of valid entries the fused gather-intersect kernel reads: 4 bytes
for each valid candidate entry and each valid entry of the adjacency
rows it gathers, in the traced queries (the program's kernel counters in
``extras["trace"]``), over the device seconds of the kernels named
``gather_intersect`` in the same queries' device trace. A rate, not a
share of a peak."""

LAYER, UNIT, SOURCE, MOVES = "kernels", "GB/s", "program_counter", \
    "query_s"


def read(run):
    if run.trace is None:
        return None
    seconds = sum(s for name, s in run.trace["kernel_s"].items()
                  if "gather_intersect" in name)
    entries = [q.extras["trace"]["counters"]["kernels"]["gather_intersect"]
               for q in run.traced if "gather_intersect" in
               q.extras.get("trace", {}).get("counters", {})
               .get("kernels", {})]
    if not entries or seconds <= 0:
        return None
    valid = sum(k["cand_valid"] + k["adj_valid"] for k in entries)
    return 4.0 * valid / seconds / 1e9
