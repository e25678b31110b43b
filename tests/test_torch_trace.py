"""The enumeration path's tracing (core/trace.py): off, it leaves no trace
and opens no profiler range; on, the results are bit-equal, the spans
nest, and every counter equals a plain recount.

    PYTHONPATH=src python -m pytest -q tests/test_torch_trace.py
"""

import dataclasses
import functools
import json
from collections import Counter

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.core import engine_torch, executor, trace
from repro_torch.core.executor import make_executor, plan_enu_count
from repro_torch.core.pattern import get_pattern
from repro_torch.core.plangen import generate_best_plan
from repro_torch.graph.generate import erdos_renyi
from repro_torch.kernels import ops as kops
from repro_torch.launch import enumerate as enum_cli

BACKENDS = ["torch", "torch-gpu"]
CHUNK = ("exec.chunk.upload", "exec.chunk.enqueue", "exec.chunk.readback")
ENGINE = {f"engine.{op}" for op in ("INI", "DBQ", "INT", "TRC", "ENU",
                                    "RES")}


@pytest.fixture(scope="module")
def graph():
    return erdos_renyi(80, 400, seed=3)


def query(engine, graph, pattern="q1", device="cpu", **cfg):
    """One query at caps small enough that chunks split and retry."""
    plan = generate_best_plan(get_pattern(pattern), graph.stats())
    cfg = {"batch": 16, "caps": [16] * plan_enu_count(plan),
           "max_retries": 10, **cfg}
    kw = {} if engine == "ref" else {"device": device}
    return make_executor(engine, **kw).run(plan, graph, **cfg)


def traced(*args, **kw):
    with trace.recording() as rec:
        st = query(*args, **kw)
    assert rec.queries == [st.extras["trace"]]
    return st


class CountingRange:
    opened = 0

    def __init__(self, name):
        CountingRange.opened += 1

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return None


@pytest.mark.parametrize("engine", BACKENDS)
def test_off_path_leaves_no_trace(engine, graph, monkeypatch):
    monkeypatch.setattr(trace, "_RecordFunctionFast", CountingRange)
    CountingRange.opened = 0
    assert not trace.on()
    st = query(engine, graph)
    assert st.chunks_split > 0 and st.chunks_retried > 0
    assert "trace" not in st.extras
    assert CountingRange.opened == 0
    with trace.recording():
        query(engine, graph)
    assert CountingRange.opened > 0


@pytest.mark.parametrize("engine", BACKENDS)
def test_results_bit_equal_on_and_off(engine, graph):
    off = query(engine, graph, collect_matches=True)
    on = traced(engine, graph, collect_matches=True)
    assert (on.count, on.chunks_run, on.chunks_split, on.chunks_retried) \
        == (off.count, off.chunks_run, off.chunks_split, off.chunks_retried)
    np.testing.assert_array_equal(on.matches, off.matches)
    np.testing.assert_array_equal(on.extras["level_sizes"],
                                  off.extras["level_sizes"])
    assert set(on.extras) - set(off.extras) == {"trace"}


@pytest.mark.parametrize("engine", BACKENDS)
def test_span_tree(engine, graph):
    st = traced(engine, graph)
    spans = st.extras["trace"]["spans"]
    names = [s["name"] for s in spans]
    assert names[0] == "exec.query" and spans[0]["parent"] == -1
    assert spans[0]["attrs"] == {"engine": engine, "pattern": "q1",
                                 "batch": 16, "starts": graph.n}
    assert len({s["query"] for s in spans}) == 1
    assert set(names) <= {"exec.query", "exec.prepare", "exec.prepare.pad",
                          "exec.prepare.copy", "exec.chunk", *CHUNK,
                          *ENGINE}
    want_parent = {"exec.prepare": "exec.query", "exec.chunk": "exec.query",
                   "exec.prepare.pad": "exec.prepare",
                   "exec.prepare.copy": "exec.prepare",
                   **{c: "exec.chunk" for c in CHUNK},
                   **{e: "exec.chunk.enqueue" for e in ENGINE}}
    for i, s in enumerate(spans[1:], 1):
        p = spans[s["parent"]]
        assert 0 <= s["parent"] < i
        assert p["name"] == want_parent[s["name"]], s
        assert p["start_ns"] <= s["start_ns"] <= s["end_ns"] <= p["end_ns"]
    chunks = [s for s in spans if s["name"] == "exec.chunk"]
    assert [c["attrs"]["seq"] for c in chunks] == list(range(st.chunks_run))
    outcomes = Counter(c["attrs"]["outcome"] for c in chunks)
    assert outcomes == {"accepted": st.chunks_run - st.chunks_split
                        - st.chunks_retried, "split": st.chunks_split,
                        "retried": st.chunks_retried}
    device_ms = st.extras["trace"]["counters"]["device_ms"]
    for outcome in outcomes:
        got = sum(c["attrs"]["device_ms"] for c in chunks
                  if c["attrs"]["outcome"] == outcome)
        assert device_ms[outcome] == pytest.approx(got)
        assert got > 0


@pytest.mark.parametrize("engine", BACKENDS)
def test_enu_counters_equal_a_recount(engine, graph, monkeypatch):
    seen = []
    expand = engine_torch._expand

    def recount(env, valid, cand, target, cap, live, sentinel, **kw):
        total = int(((cand != sentinel) & valid[:, None]).sum())
        seen.append((cand.numel(), total, cap))
        return expand(env, valid, cand, target, cap, live, sentinel, **kw)

    monkeypatch.setattr(engine_torch, "_expand", recount)
    st = traced(engine, graph)
    assert len(seen) > 0
    enu = st.extras["trace"]["counters"]["enu"]
    assert set(enu) == {"accepted", "split", "retried"}
    n_enu = len(enu["accepted"]["flags"])
    want = np.zeros((n_enu, 2), np.int64)
    for i, (flags, total, cap) in enumerate(seen):
        want[i % n_enu] += (flags, total)
    got = sum(np.array([enu[o][k] for k in trace.ENU_KEYS]).T
              for o in enu)
    np.testing.assert_array_equal(got, want)
    # an accepted chunk overflows no level: every candidate is kept
    np.testing.assert_array_equal(enu["accepted"]["valid"],
                                  st.extras["level_sizes"])


@pytest.mark.parametrize("engine", BACKENDS)
def test_kernel_counters_equal_a_recount(engine, graph, monkeypatch):
    want = Counter()
    deg = torch.from_numpy(np.append(graph.deg, 0))
    fused = kops.fused_gather_intersect

    def gather_intersect(cand, ids, rows, sentinel, impl="auto"):
        d = deg[ids.clamp(0, sentinel).long()]
        want.update({"cand_valid": int((cand != sentinel).sum()),
                     "adj_valid": int(d.sum())})
        return fused(cand, ids, rows, sentinel, impl=impl)

    monkeypatch.setattr(kops, "fused_gather_intersect", gather_intersect)
    for pattern in ("q1", "triangle"):
        want.clear()
        st = traced(engine, graph, pattern=pattern)
        kernels = st.extras["trace"]["counters"]["kernels"]
        if engine == "torch-gpu":
            assert kernels == {"gather_intersect": dict(want)}
            assert want["cand_valid"] > 0 and want["adj_valid"] > 0
        else:
            assert kernels == {} and not want


def counted_levels(st):
    """Each ENU level's flags scanned and count-only flags, summed over
    the chunks' outcomes."""
    enu = st.extras["trace"]["counters"]["enu"]
    return (sum(np.array(enu[o]["flags"]) for o in enu),
            sum(np.array(enu[o][trace.COUNTED]) for o in enu))


def outcome(st):
    return (st.count, st.chunks_run, st.chunks_split, st.chunks_retried,
            list(st.extras["level_sizes"]))


@pytest.mark.parametrize("engine", BACKENDS)
def test_count_only_last_level(engine, graph, monkeypatch):
    """The square's last ENU feeds only RES's count, so it runs
    count-only: its flags are counted and no other level's are. Collected
    matches, a ``post_expand`` hook and a VCBC plan each keep every level
    compacting. Count, chunks, splits and level sizes equal the
    compacting path's in each case (a VCBC plan's count the plain
    plan's)."""
    counting = traced(engine, graph)
    flags, counted = counted_levels(counting)
    assert counted[-1] == flags[-1] > 0 and not counted[:-1].any()

    collecting = traced(engine, graph, collect_matches=True)
    assert not counted_levels(collecting)[1].any()
    assert outcome(collecting) == outcome(counting)

    hooked = []

    def identity(env, valid):
        hooked.append(valid.shape[0])
        return env, valid

    with monkeypatch.context() as m:
        m.setattr(executor, "build_enumerator", functools.partial(
            engine_torch.build_enumerator, post_expand=identity))
        hooking = traced(engine, graph)
    assert hooked and not counted_levels(hooking)[1].any()
    assert outcome(hooking) == outcome(counting)

    square = generate_best_plan(get_pattern("q1"), graph.stats())
    live = engine_torch._liveness(square)
    only = engine_torch.count_only_enus
    assert only(square, live) == {len(square.instrs) - 2}
    assert only(dataclasses.replace(square, vcbc=True), live) == set()
    assert only(square, live, collect_matches=True) == set()
    assert only(square, live, post_expand=identity) == set()
    plan = generate_best_plan(get_pattern("q1"), graph.stats(), vcbc=True)
    with trace.recording():
        vcbc = make_executor(engine, device="cpu").run(
            plan, graph, batch=16, caps=[16] * plan_enu_count(plan),
            max_retries=10)
    assert not counted_levels(vcbc)[1].any()
    assert vcbc.count == counting.count


def test_span_clock_is_the_profilers(graph):
    """Under a profiler (tracing on without a recording), each span's
    start lies within 1 ms of its range's start on the profiler's host
    timeline."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert trace.on()
        st = query("torch-gpu", graph, pattern="triangle")
    spans = st.extras["trace"]["spans"]
    t0 = prof.profiler.kineto_results.trace_start_ns()
    events = {}
    for e in prof.events():
        if e.name.startswith(("exec.", "engine.")):
            events.setdefault(e.name, []).append(
                t0 + e.time_range.start * 1000)
    assert set(events) == {s["name"] for s in spans}
    for name, starts in events.items():
        mine = sorted(s["start_ns"] for s in spans if s["name"] == name)
        assert len(mine) == len(starts), name
        gap = np.abs(np.array(mine) - np.sort(np.array(starts)))
        assert gap.max() < 1e6, (name, gap.max())


@pytest.fixture
def world_of_one(tmp_path):
    """A gloo process group of one rank in this process."""
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                            rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


@pytest.fixture
def queued(monkeypatch):
    """The device counters queued on a recorder, by kind."""
    seen = Counter()
    for kind in ("enu_level", "kernel"):
        def count(self, *a, _kind=kind, _f=getattr(trace.Recorder, kind)):
            seen[_kind] += 1
            return _f(self, *a)
        monkeypatch.setattr(trace.Recorder, kind, count)
    return seen


def no_device_counters(export, queued):
    """A backend that does not read the device counters back queues
    none: no device work for them, and no ENU or kernel counts."""
    c = export["counters"]
    return c["enu"] == {} and c["kernels"] == {} and not queued


@pytest.mark.parametrize("engine", ["ref", "oocache", "dist"])
def test_other_backends_traced(engine, graph, request, queued):
    """The driver's spans on every backend; the counts unchanged."""
    if engine == "dist":
        request.getfixturevalue("world_of_one")
    off = query(engine, graph, pattern="triangle")
    on = traced(engine, graph, pattern="triangle")
    assert on.count == off.count and on.chunks_run == off.chunks_run
    names = Counter(s["name"] for s in on.extras["trace"]["spans"])
    assert names["exec.query"] == names["exec.prepare"] == 1
    assert names["exec.chunk"] == on.chunks_run
    assert no_device_counters(on.extras["trace"], queued)


def test_sbenu_torch_traced(queued):
    """S-BENU's steps on the vectorized engine: the driver's spans, the
    deltas unchanged, no device counters queued."""
    from repro_torch.core.pattern import get_pattern as pattern_of
    from repro_torch.core.estimate import GraphStats
    from repro_torch.core.sbenu import (generate_best_sbenu_plans,
                                        run_timestep)
    from repro_torch.graph.dynamic import SnapshotStore
    from repro_torch.graph.generate import edge_stream
    g0, batches = edge_stream(n=24, m_init=110, steps=2, batch=24, seed=17,
                              delete_frac=0.4)
    p = pattern_of("q2'")
    plans = generate_best_sbenu_plans(p, GraphStats(24, 110,
                                                    delta_edges=24))
    stores = [SnapshotStore(g0), SnapshotStore(g0)]
    for batch in batches:
        want = run_timestep(p, plans, stores[0], batch,
                            engine="sbenu-torch", device="cpu", chunk=4)
        with trace.recording() as rec:
            got = run_timestep(p, plans, stores[1], batch,
                               engine="sbenu-torch", device="cpu", chunk=4)
        assert got[:2] == want[:2]
        assert got[2].matches_plus == want[2].matches_plus
        [q] = rec.queries
        names = Counter(s["name"] for s in q["spans"])
        assert names["exec.query"] == names["exec.prepare"] == 1
        assert names["exec.chunk"] >= 1
        assert no_device_counters(q, queued)


def test_recording_keeps_each_query(graph, tmp_path):
    with trace.recording() as rec:
        a = query("torch", graph, pattern="triangle")
        b = query("torch", graph, pattern="triangle")
    assert rec.queries == [a.extras["trace"], b.extras["trace"]]
    ids = [q["spans"][0]["query"] for q in rec.queries]
    assert ids[0] != ids[1]
    assert not trace.on() and trace.current() is None
    doc = json.loads(json.dumps(trace.to_chrome(rec.spans,
                                                tmp_path / "t.json")))
    assert doc == json.loads((tmp_path / "t.json").read_text())
    ev = doc["traceEvents"]
    assert len(ev) == len(rec.spans)
    assert {e["tid"] for e in ev} == set(ids)
    assert all(e["ph"] == "X" and e["dur"] >= 0 for e in ev)
    self_s = trace.self_times(rec.spans)
    whole = sum((q["spans"][0]["end_ns"] - q["spans"][0]["start_ns"]) / 1e9
                for q in rec.queries)
    assert sum(self_s.values()) == pytest.approx(whole)


def test_cli_trace(tmp_path, capsys):
    path = tmp_path / "spans.json"
    enum_cli.main(["--pattern", "triangle", "--n", "120", "--edges", "500",
                   "--engine", "torch-gpu", "--device", "cpu",
                   "--batch-per-shard", "32", "--trace", str(path)])
    out = capsys.readouterr().out
    names = {e["name"] for e in json.loads(path.read_text())["traceEvents"]}
    assert {"exec.query", "exec.chunk", "engine.ENU"} <= names
    assert f"-> {path}" in out
    assert "self exec.query" in out and "self engine.ENU" in out


@pytest.mark.cuda
def test_trace_on_card():
    """On the card: each chunk's device ms from its CUDA events, the
    fused kernel's counters from the device, results as with tracing
    off."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    g = erdos_renyi(2000, 16000, seed=5)
    off = query("torch-gpu", g, device="cuda", batch=256, caps=None)
    on = traced("torch-gpu", g, device="cuda", batch=256, caps=None)
    assert (on.count, on.chunks_run) == (off.count, off.chunks_run)
    chunks = [s for s in on.extras["trace"]["spans"]
              if s["name"] == "exec.chunk"]
    for c in chunks:
        wall_ms = (c["end_ns"] - c["start_ns"]) / 1e6
        assert 0 < c["attrs"]["device_ms"] <= wall_ms
    k = on.extras["trace"]["counters"]["kernels"]["gather_intersect"]
    assert 0 < k["adj_valid"] and 0 < k["cand_valid"]
