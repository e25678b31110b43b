"""The allocator's peak over the window (reset after the warm-up query):
whether the graph and its frontiers fit the card."""

LAYER, UNIT, SOURCE, MOVES = "end to end", "GiB", "host_clock", \
    "peak_device_gib"


def read(run):
    if run.device.type != "cuda":
        return None
    return run.peak_bytes / 2**30
