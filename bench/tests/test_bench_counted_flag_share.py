"""``engine.counted_flag_share`` on hand-made runs: the share of ENU's
flags that count-only levels scanned, over every outcome and traced
query, and nothing where the program counts no such flags (a program
older than its count-only levels, or a run with tracing off)."""

import pytest

from bench.harness import Query, Run, load_reader
from conftest import ROOT


def enu(counted=True):
    """Three levels a chunk; the last ran count-only."""
    out = {"accepted": {"flags": [100, 1000, 4000], "valid": [10, 30, 2],
                        "counted": [0, 0, 4000]},
           "split": {"flags": [100, 900, 0], "valid": [60, 20, 0],
                     "counted": [0, 0, 0]}}
    if not counted:
        for levels in out.values():
            del levels["counted"]
    return {"trace": {"spans": [], "counters": {
        "device_ms": {}, "enu": out, "kernels": {}}}}


def run(extras):
    r = Run(cell="c", config={}, traffic={}, seed=1, device=None)
    r.traced = [Query(count=1, seconds=1.0, chunks_run=2, chunks_split=1,
                      chunks_retried=0, extras=e) for e in extras]
    return r


@pytest.fixture
def reader():
    return load_reader(ROOT, "engine.counted_flag_share")


def test_reads_the_counted_flags(reader):
    assert reader.read(run([enu(), enu()])) == \
        pytest.approx(100.0 * 4000 / 6100)


def test_none_without_the_counter(reader):
    assert reader.read(run([enu(counted=False)] * 2)) is None
    assert reader.read(run([{"level_sizes": [1, 2]}, {}])) is None
    assert reader.read(run([])) is None


def test_zero_where_no_level_ran_count_only(reader):
    extras = enu()
    extras["trace"]["counters"]["enu"]["accepted"]["counted"] = [0, 0, 0]
    assert reader.read(run([extras])) == 0.0
