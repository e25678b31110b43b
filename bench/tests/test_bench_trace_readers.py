"""The readers of the program's own spans and counters
(``extras["trace"]`` of the traced queries) on a hand-made run: the
value the trace gives, and nothing where the program wrote no trace."""

import pytest

from bench.harness import Query, Run, load_reader
from conftest import ROOT

MS = {"accepted": 30.0, "split": 10.0, "retried": 20.0}


def span(name, t0, t1, parent):
    return {"name": name, "start_ns": t0, "end_ns": t1, "parent": parent,
            "query": 0, "attrs": {}}


def trace(ms=MS):
    """One query: 10 s in all, 1 s placing the graph, two chunks of 3 s
    and 4 s (a chunk's children do not count against the query)."""
    spans = [span("exec.query", 0, 10 * 10**9, -1),
             span("exec.prepare", 0, 10**9, 0),
             span("exec.chunk", 2 * 10**9, 5 * 10**9, 0),
             span("exec.chunk.enqueue", 2 * 10**9, 4 * 10**9, 2),
             span("exec.chunk", 5 * 10**9, 9 * 10**9, 0)]
    enu = {"accepted": {"flags": [100, 1000], "valid": [10, 30]},
           "split": {"flags": [100, 0], "valid": [60, 0]}}
    kernels = {"gather_intersect": {"cand_valid": 2 * 10**9,
                                    "adj_valid": 3 * 10**9}}
    return {"spans": spans, "counters": {"device_ms": dict(ms), "enu": enu,
                                         "kernels": kernels}}


def run(traced, kernel_s=None):
    r = Run(cell="c", config={}, traffic={}, seed=1, device=None)
    r.traced = [Query(count=1, seconds=1.0, chunks_run=2, chunks_split=1,
                      chunks_retried=0, extras=e) for e in traced]
    if kernel_s is not None:
        r.trace = {"busy_s": 1.0, "window_s": 2.0, "kernel_s": kernel_s,
                   "device_ops": [], "idle_gaps": []}
    return r


KERNEL_S = {"gather_intersect_kernel": 0.5, "sorted_intersect_kernel": 9.0,
            "other": 1.0}
WANT = {"driver.discarded_device_share": 50.0,
        "driver.self_s": 2.0,
        "engine.enu_valid_share": 100.0 * 100 / 1200,
        # 4 B x 2 queries x 5e9 valid entries over 2 x 0.5 s of the kernel
        "kernels.gather_intersect_valid_gbps": 4.0 * 2 * 5e9 / 1.0 / 1e9}


@pytest.mark.parametrize("name", sorted(WANT))
def test_reads_the_trace(name):
    reader = load_reader(ROOT, name)
    kernel_s = {k: 2 * v for k, v in KERNEL_S.items()}
    got = reader.read(run([{"trace": trace()}, {"trace": trace()}],
                          kernel_s))
    assert got == pytest.approx(WANT[name])


@pytest.mark.parametrize("name", sorted(WANT))
def test_none_without_a_trace(name):
    """A program that writes no trace (the parent of the tracing, or a
    run with tracing off) gives nothing, and does not raise."""
    reader = load_reader(ROOT, name)
    assert reader.read(run([{"level_sizes": [1, 2]}, {}], KERNEL_S)) is None
    assert reader.read(run([], KERNEL_S)) is None
    assert reader.read(run([])) is None


def test_no_device_time_reads_nothing():
    r = load_reader(ROOT, "kernels.gather_intersect_valid_gbps")
    assert r.read(run([{"trace": trace()}], {"other": 1.0})) is None
    assert r.read(run([{"trace": trace()}])) is None
    d = load_reader(ROOT, "driver.discarded_device_share")
    assert d.read(run([{"trace": trace(dict.fromkeys(MS, 0.0))}])) is None
