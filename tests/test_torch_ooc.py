"""The port's out-of-core fetch path against the JAX package, on CPU.

HostRowStore, DeviceRowCache (``device="cpu"``: plain tensors, no stream,
no pinned memory) and the ``oocache`` engine run beside their JAX
counterparts on the same seeds. Exact agreement is the bar (tolerance 0:
rows, counts, match sets and cache counters are integers): the cache's
array-based LRU bookkeeping must reproduce the reference's slots,
evictions and every counter, not only the rows it serves.
"""

import dataclasses
import sys

import numpy as np
import pytest
import torch

from repro.core.executor import make_executor as jax_make_executor
from repro.core.pattern import get_pattern as jax_get_pattern
from repro.core.plangen import generate_best_plan as jax_best_plan
from repro.core.ref_engine import enumerate_matches_brute
from repro.core.symmetry import symmetry_breaking_constraints
from repro.distributed.rowcache import DeviceRowCache as JaxRowCache
from repro.graph.generate import erdos_renyi as jax_er
from repro.graph.generate import powerlaw as jax_pl
from repro.graph.hoststore import HostRowStore as JaxHostRowStore
from repro.graph.storage import DiGraph as JaxDiGraph

from repro_torch.convert import plan_from_fields
from repro_torch.core.engine_ooc import OocEngine, split_segments
from repro_torch.core.executor import make_executor, plan_enu_count
from repro_torch.core.pattern import get_pattern
from repro_torch.core.plangen import generate_best_plan
from repro_torch.distributed.rowcache import DeviceRowCache
from repro_torch.graph.generate import erdos_renyi, powerlaw
from repro_torch.graph.hoststore import HostRowStore
from repro_torch.graph.storage import DiGraph

# the matrix of tests/test_conformance.py: (n, m, seed) per graph
PATTERNS = ["triangle", "square", "clique4", "house", "path5", "cycle5"]
GRAPH_ARGS = {"er": (jax_er, erdos_renyi, (64, 256), 11),
              "pl": (jax_pl, powerlaw, (64, 4), 12)}
_GRAPHS = {}


def graphs(gname):
    """(reference Graph, port Graph) built from the same seed."""
    if gname not in _GRAPHS:
        jf, tf, args, seed = GRAPH_ARGS[gname]
        _GRAPHS[gname] = (jf(*args, seed=seed), tf(*args, seed=seed))
    return _GRAPHS[gname]


_BRUTE = {}


def brute_set(pname, jg):
    key = (pname, id(jg))
    if key not in _BRUTE:
        p = jax_get_pattern(pname)
        _BRUTE[key] = {tuple(int(x) for x in m) for m in
                       enumerate_matches_brute(
                           p, jg, symmetry_breaking_constraints(p))}
    return _BRUTE[key]


def bounded(n):
    """The JAX gate's sizing: slab 12%, hot 4% of the rows."""
    return max(1, int(n * 0.12)), max(1, int(n * 0.04))


# --------------------------------------------------------------------------
# HostRowStore: a plain copy of the reference's
# --------------------------------------------------------------------------


@pytest.mark.parametrize("rps", [4, 17, 65, 4096])
@pytest.mark.parametrize("gname", sorted(GRAPH_ARGS))
def test_host_store_gather_equals_reference(gname, rps):
    jg, tg = graphs(gname)
    js = JaxHostRowStore.from_graph(jg, rows_per_shard=rps)
    ts = HostRowStore.from_graph(tg, rows_per_shard=rps)
    assert (ts.n, ts.d, ts.rows_per_shard, len(ts.shards), ts.nbytes) == \
        (js.n, js.d, js.rows_per_shard, len(js.shards), js.nbytes)
    np.testing.assert_array_equal(ts.to_rows(), js.to_rows())
    ids = np.random.default_rng(rps).integers(-2, jg.n + 3, size=200)
    np.testing.assert_array_equal(ts.gather(ids), js.gather(ids))
    # ascending ids take the run-by-run copy; ``out`` receives the rows
    for order in (np.sort(ids), ids):
        out = np.empty((order.size, ts.d), np.int32)
        assert ts.gather(order, out=out) is out
        np.testing.assert_array_equal(out, js.gather(order))


def test_host_store_set_rows_equals_reference():
    jg, tg = graphs("er")
    js = JaxHostRowStore.from_graph(jg, rows_per_shard=10)
    ts = HostRowStore.from_graph(tg, rows_per_shard=10)
    rng = np.random.default_rng(3)
    ids = rng.permutation(jg.n)[:12]
    rows = np.sort(rng.integers(0, jg.n + 1, size=(12, js.d)), axis=1)
    js.set_rows(ids, rows.astype(np.int32))
    ts.set_rows(ids, rows.astype(np.int32))
    np.testing.assert_array_equal(ts.to_rows(), js.to_rows())
    for store in (ts, js):
        with pytest.raises(ValueError):
            store.set_rows(np.array([jg.n]), rows[:1])   # sentinel row


@pytest.mark.parametrize("direction", ["out", "in"])
def test_host_store_from_digraph_equals_reference(direction):
    edges = [(0, 1), (0, 2), (3, 0), (4, 5), (5, 0), (2, 4)]
    js = JaxHostRowStore.from_digraph(JaxDiGraph.from_edges(6, edges),
                                      direction, rows_per_shard=3)
    ts = HostRowStore.from_digraph(DiGraph.from_edges(6, edges), direction,
                                   rows_per_shard=3)
    assert len(ts.shards) == len(js.shards)
    np.testing.assert_array_equal(ts.to_rows(), js.to_rows())


# --------------------------------------------------------------------------
# DeviceRowCache on the CPU == the JAX cache, call by call
# --------------------------------------------------------------------------


@pytest.mark.parametrize("cap,hot,stage", [(0, 0, None), (5, 8, 2),
                                           (64, 0, 16)])
def test_cache_call_sequence_equals_reference(cap, hot, stage):
    """One random sequence of prefetch / lookup / invalidate calls: the
    served rows, ``stats.as_dict()``, the staged block count and the LRU
    state (resident ids in eviction order, their slots, the free list)
    equal the JAX cache's after every call."""
    jg, tg = jax_pl(200, 4, seed=3), powerlaw(200, 4, seed=3)
    jc = JaxRowCache(JaxHostRowStore.from_graph(jg, rows_per_shard=16), cap,
                     hot=hot, stage_rows=stage)
    tc = DeviceRowCache(HostRowStore.from_graph(tg, rows_per_shard=16), cap,
                        hot=hot, stage_rows=stage, device="cpu")
    assert tc.device_rows == jc.device_rows
    assert tc.device_bytes == jc.device_bytes
    rng = np.random.default_rng(cap * 31 + hot)
    for step in range(24):
        r = rng.random()
        ids = rng.integers(-3, jg.n + 4, size=64)
        if r < 0.3:
            jc.prefetch(ids)
            tc.prefetch(ids)
        elif r < 0.4:
            jc.invalidate(ids[:5])
            tc.invalidate(ids[:5])
        else:
            want = np.asarray(jc.lookup(ids, level=step % 3))
            got = tc.lookup(ids, level=step % 3)
            assert got.dtype == torch.int32 and got.device.type == "cpu"
            np.testing.assert_array_equal(got.numpy(), want)
        assert tc.stats.as_dict() == jc.stats.as_dict(), step
        assert len(tc._staged) == len(jc._staged)
        resident = np.flatnonzero(tc._slot_of >= 0)
        order = resident[np.argsort(tc._stamp[resident])]
        assert order.tolist() == list(jc._slot_of), step
        assert tc._slot_of[order].tolist() == list(jc._slot_of.values())
        assert tc._free == jc._free
    if cap:
        assert tc.stats.evictions > 0 and tc.stats.prefetch_used > 0


def test_cache_prefetch_then_lookup_serves_staged_rows():
    jg, tg = graphs("er")
    jc = JaxRowCache(JaxHostRowStore.from_graph(jg), 32, stage_rows=16)
    tc = DeviceRowCache(HostRowStore.from_graph(tg), 32, stage_rows=16,
                        device="cpu")
    for c in (jc, tc):
        c.prefetch(np.arange(10))
    got = tc.lookup(np.arange(10)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jc.lookup(np.arange(10))))
    assert tc.stats.cold_rows == 0 and tc.stats.prefetch_used == 10
    for lo in (10, 14, 18):           # a third block folds the oldest in
        for c in (jc, tc):
            c.prefetch(np.arange(lo, lo + 4))
    assert len(tc._staged) == len(jc._staged) == 2
    assert tc.stats.as_dict() == jc.stats.as_dict()


# --------------------------------------------------------------------------
# oocache: counts == JAX oocache == brute, bounded device residency
# --------------------------------------------------------------------------


@pytest.mark.parametrize("pname", PATTERNS)
@pytest.mark.parametrize("gname", sorted(GRAPH_ARGS))
def test_oocache_equals_jax_and_brute_bounded_cache(pname, gname):
    jg, tg = graphs(gname)
    jplan = jax_best_plan(jax_get_pattern(pname), jg.stats())
    plan = generate_best_plan(get_pattern(pname), tg.stats())
    cap, hot = bounded(jg.n)
    # explicit caps for both (the reference's defaults split path5 and
    # cycle5 into dozens of chunks, each compiled anew by jax)
    caps = [65536] * plan_enu_count(plan)
    jx = jax_make_executor("oocache", cache_rows=cap, hot=hot).run(
        jplan, jg, batch=32, caps=caps)
    st = make_executor("oocache", cache_rows=cap, hot=hot,
                       device="cpu").run(plan, tg, batch=32, caps=caps)
    assert st.count == jx.count == len(brute_set(pname, jg))
    assert st.extras["device_resident_rows"] < 0.25 * (tg.n + 1)
    assert st.extras["cache"]["cold_rows"] > 0
    # same chunks, same frontiers: the same rows cross the same way
    assert st.extras["cache"] == jx.extras["cache"]
    for k in ("cache_capacity_rows", "cache_hot_rows", "device_resident_rows",
              "device_resident_bytes", "host_store_bytes",
              "host_store_shards"):
        assert st.extras[k] == jx.extras[k], k
    # level sizes equal the resident engine's (sums over accepted chunks:
    # the same at its default caps, however often those split)
    ref = make_executor("torch", device="cpu").run(plan, tg, batch=32)
    np.testing.assert_array_equal(st.extras["level_sizes"],
                                  ref.extras["level_sizes"])


@pytest.mark.parametrize("pname,gname", [("triangle", "pl"),
                                         ("clique4", "er"),
                                         ("house", "pl"),
                                         ("square", "er")])
def test_ooc_engine_per_chunk_equals_jax(pname, gname):
    """OocEngine.run_chunk on the same ids and caps: count, overflow and
    match rows equal the JAX engine's chunk by chunk, overflowing chunks
    included, with both caches' counters equal after every chunk."""
    from repro.core.engine_ooc import OocEngine as JaxOocEngine
    from repro.core.engine_ooc import split_segments as jax_split_segments
    from repro.core.executor import build_universe_chunks
    jg, tg = graphs(gname)
    jplan = jax_best_plan(jax_get_pattern(pname), jg.stats())
    plan = plan_from_fields(dataclasses.asdict(jplan))
    assert [(h is None, len(b), lv, e) for h, b, lv, e in
            split_segments(plan)] == \
        [(h is None, len(b), lv, e) for h, b, lv, e in
         jax_split_segments(jplan)]
    cap, hot = bounded(jg.n)
    jc = JaxRowCache(JaxHostRowStore.from_graph(jg), cap, hot=hot)
    tc = DeviceRowCache(HostRowStore.from_graph(tg), cap, hot=hot,
                        device="cpu")
    je = JaxOocEngine(jplan, jc, collect_matches=True)
    te = OocEngine(plan, tc, collect_matches=True)
    uni = build_universe_chunks(jg.n, 16)[1] if te.has_universe else None
    n_enu = plan_enu_count(plan)
    rng = np.random.default_rng(7)
    for caps in ((16,) * n_enu, (512,) * n_enu):
        for _ in range(3):
            ids = rng.permutation(jg.n)[:24].astype(np.int32)
            valid = rng.random(24) < 0.8
            ids = np.where(valid, ids, jg.n).astype(np.int32)
            jr = je.run_chunk(ids, valid, uni, caps)
            tr = te.run_chunk(ids, valid, uni, caps)
            assert (tr.count, tr.overflow) == (int(jr[0]), int(jr[1]))
            if jr[2] is None:
                assert tr.matches is None
            else:
                np.testing.assert_array_equal(tr.matches, jr[2])
            assert tc.stats.as_dict() == jc.stats.as_dict()


def test_oocache_forced_overflow_splits_and_stays_exact():
    jg, tg = graphs("pl")
    plan = generate_best_plan(get_pattern("house"), tg.stats())
    cap, hot = bounded(tg.n)
    st = make_executor("oocache", cache_rows=cap, hot=hot,
                       device="cpu").run(
        plan, tg, batch=16, caps=[8] * plan_enu_count(plan),
        max_retries=12, collect_matches=True)
    got = {tuple(int(x) for x in r) for r in st.matches}
    assert st.chunks_split > 0
    assert got == brute_set("house", jg) and len(st.matches) == len(got)


def test_oocache_zero_capacity_still_exact():
    jg, tg = graphs("er")
    plan = generate_best_plan(get_pattern("triangle"), tg.stats())
    st = make_executor("oocache", cache_rows=0, hot=0, prefetch=False,
                       device="cpu").run(plan, tg, batch=32)
    assert st.count == len(brute_set("triangle", jg))
    c = st.extras["cache"]
    assert c["hit_rate"] < 1.0 and c["cold_rows"] > 0
    assert c["prefetch_rows"] == 0 and c["evictions"] == 0


def test_oocache_universe_plan_square():
    """The square's wedge order consumes V(G): the segments thread the
    universe chunk like the resident engine."""
    jg, tg = graphs("er")
    plan = generate_best_plan(get_pattern("square"), tg.stats())
    assert any(v[0] == "VG" for i in plan.instrs for v in i.operands)
    cap, hot = bounded(tg.n)
    st = make_executor("oocache", cache_rows=cap, hot=hot,
                       device="cpu").run(plan, tg, batch=32,
                                         universe_chunk=16)
    assert st.count == len(brute_set("square", jg))


def test_oocache_prefetch_used_and_accounting():
    jg, tg = graphs("er")
    plan = generate_best_plan(get_pattern("path5"), tg.stats())
    cap, hot = bounded(tg.n)
    st = make_executor("oocache", cache_rows=cap, hot=hot,
                       device="cpu").run(plan, tg, batch=8)
    c = st.extras["cache"]
    assert c["prefetch_used"] > 0
    assert c["bytes_moved"] == c["bytes_demand"] + c["bytes_prefetch"]
    assert sum(q for q, _, _ in c["per_level"].values()) == c["queries"]
    assert sum(k for _, k, _ in c["per_level"].values()) == c["cold_rows"]
    assert st.extras["lookup_host_s"] > 0 and st.extras["prepare_s"] > 0


# --------------------------------------------------------------------------
# _expand(extra_cols=...) == the reference's
# --------------------------------------------------------------------------


@pytest.mark.parametrize("cap", [5, 40])
@pytest.mark.parametrize("compaction", ["cumsum", "sort"])
def test_expand_extra_cols_equals_reference(cap, compaction):
    import jax.numpy as jnp
    from repro.core.engine_jax import _expand as jax_expand
    from repro_torch.core.engine_torch import _expand
    rng = np.random.default_rng(cap)
    n, B, D = 50, 6, 8
    cand = np.where(rng.random((B, D)) < 0.4, n,
                    rng.integers(0, n, (B, D))).astype(np.int32)
    signs = np.where(cand != n, rng.choice([-1, 1], (B, D)), 0
                     ).astype(np.int32)
    valid = rng.random(B) < 0.8
    col = rng.integers(0, n, B).astype(np.int32)
    live = frozenset({("f", 0)})
    jenv, jv, jov = jax_expand(
        {("f", 0): jnp.asarray(col)}, jnp.asarray(valid),
        jnp.asarray(cand), ("f", 1), cap, live, n, compaction=compaction,
        extra_cols={("op", -1): jnp.asarray(signs)})
    tenv, tv, tov = _expand(
        {("f", 0): torch.from_numpy(col)}, torch.from_numpy(valid),
        torch.from_numpy(cand), ("f", 1), cap, live, n,
        compaction=compaction,
        extra_cols={("op", -1): torch.from_numpy(signs)})
    assert int(tov) == int(jov)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert set(tenv) == set(jenv)
    for k in jenv:
        np.testing.assert_array_equal(tenv[k].numpy(), np.asarray(jenv[k]))


# --------------------------------------------------------------------------
# CLI: the same ``matches :`` line as the reference's oocache run
# --------------------------------------------------------------------------


def test_cli_oocache_matches_line_equals_reference(monkeypatch, capsys):
    from repro.launch import enumerate as jax_cli
    from repro_torch.launch import enumerate as cli
    args = ["--pattern", "house", "--n", "200", "--edges", "800",
            "--batch-per-shard", "64", "--engine", "oocache", "--hot", "8",
            "--cache-frac", "0.1"]

    def lines():
        out = capsys.readouterr().out
        return [ln for ln in out.splitlines()
                if ln.startswith(("matches", "row queries", "cold rows",
                                  "device resident"))]

    monkeypatch.setattr(sys, "argv", ["enumerate", *args])
    jax_cli.main()
    want = lines()
    cli.main([*args, "--device", "cpu"])
    assert len(want) == 4 and lines() == want
