"""The port's reference interpreter and join baseline against the JAX
package's, on CPU.

Both packages get the same graphs (same generator, same seed) and plans;
exact agreement is the bar (tolerance 0): counters, query counts, match
sets, code lists, per-task work and every JoinStats field are integers.
"""

import dataclasses

import numpy as np
import pytest

from repro.core.baseline_join import enumerate_join as jax_enumerate_join
from repro.core.executor import make_executor as jax_make_executor
from repro.core.pattern import get_pattern as jax_get_pattern
from repro.core.plangen import generate_best_plan as jax_best_plan
from repro.core.ref_engine import GraphDB as JaxGraphDB
from repro.core.ref_engine import RefEngine as JaxRefEngine
from repro.core.ref_engine import \
    count_isomorphic_subgraphs as jax_count_isomorphic
from repro.core.ref_engine import enumerate_matches_brute as jax_brute
from repro.core.ref_engine import make_tasks as jax_make_tasks
from repro.graph.generate import erdos_renyi as jax_er

from repro_torch.core.baseline_join import enumerate_join
from repro_torch.core.executor import make_executor
from repro_torch.core.pattern import get_pattern
from repro_torch.core.plangen import generate_best_plan
from repro_torch.core.ref_engine import (GraphDB, RefEngine,
                                         count_isomorphic_subgraphs,
                                         enumerate_matches_brute,
                                         make_tasks)
from repro_torch.core.vcbc import count_code
from repro_torch.graph.generate import erdos_renyi

from test_torch_conformance import GRAPH_ARGS, PATTERNS, graphs

COUNTERS = ("dbq", "int_", "trc", "trc_hits", "enu", "matches",
            "per_task_work")


def plans_of(pname, gname, **kw):
    jg, tg = graphs(gname)
    return (jax_best_plan(jax_get_pattern(pname), jg.stats(), **kw),
            generate_best_plan(get_pattern(pname), tg.stats(), **kw))


@pytest.mark.parametrize("pname", PATTERNS)
@pytest.mark.parametrize("gname", sorted(GRAPH_ARGS))
def test_ref_backend_equals_reference(pname, gname):
    """make_executor('ref'): count, every finalize extra (counters,
    per-task work, remote/total queries) and the collected match array,
    with the θ task split off and on."""
    jg, tg = graphs(gname)
    jplan, plan = plans_of(pname, gname)
    for theta in (None, 3):
        cfg = dict(batch=16, theta=theta, collect_matches=True)
        want = jax_make_executor("ref").run(jplan, jg, **cfg)
        got = make_executor("ref").run(plan, tg, **cfg)
        assert got.count == want.count, theta
        assert got.extras == want.extras, theta
        assert (got.chunks_run, got.chunks_split) == \
            (want.chunks_run, want.chunks_split)
        np.testing.assert_array_equal(got.matches, want.matches)
    torch_count = make_executor("torch", device="cpu").run(
        plan, tg, batch=32).count
    assert got.count == torch_count


@pytest.mark.parametrize("pname", PATTERNS)
def test_ref_engine_lru_cache_counters(pname):
    """RefEngine over a GraphDB without a cache, with LRU capacity 0, a
    small one and one that holds every row: counters and the
    remote/total query counts equal the reference's."""
    jg, tg = graphs("pl")
    jplan, plan = plans_of(pname, "pl")
    for cap in (None, 0, 8, tg.n):
        jdb, tdb = JaxGraphDB(jg, cap), GraphDB(tg, cap)
        jeng = JaxRefEngine(jplan, jax_get_pattern(pname), jg, db=jdb)
        teng = RefEngine(plan, get_pattern(pname), tg, db=tdb)
        jc, tc = jeng.run(theta=4), teng.run(theta=4)
        for k in COUNTERS:
            assert getattr(tc, k) == getattr(jc, k), (cap, k)
        assert (tdb.remote_queries, tdb.total_queries) == \
            (jdb.remote_queries, jdb.total_queries), cap
        assert tdb.hit_rate == jdb.hit_rate
    assert (tc.computation_cost, tc.communication_cost) == \
        (jc.computation_cost, jc.communication_cost)
    # the plan-free task builder too (one task a vertex, split by θ)
    assert [(t.start, t.c2_slice) for t in make_tasks(plan, tg, theta=4)] \
        == [(t.start, t.c2_slice) for t in jax_make_tasks(jplan, jg, 4)]


@pytest.mark.parametrize("pname,codes,matches",
                         [("clique4", 541, 28), ("house", 15370, 44117)])
def test_ref_on_vcbc_plan_counts_codes(pname, codes, matches):
    """On a VCBC plan ``ref`` returns the number of codes, as the
    reference does; the codes expand to exactly ``torch``'s count."""
    jg, tg = jax_er(120, 900, seed=3), erdos_renyi(120, 900, seed=3)
    jplan = jax_best_plan(jax_get_pattern(pname), jg.stats(), vcbc=True)
    plan = generate_best_plan(get_pattern(pname), tg.stats(), vcbc=True)
    assert plan.vcbc
    want = jax_make_executor("ref").run(jplan, jg, batch=32)
    got = make_executor("ref").run(plan, tg, batch=32)
    assert got.count == want.count == codes
    assert got.extras == want.extras
    P = get_pattern(pname)
    jeng = JaxRefEngine(jplan, jax_get_pattern(pname), jg, collect="codes")
    teng = RefEngine(plan, P, tg, collect="codes")
    jeng.run()
    teng.run()
    assert teng.codes == jeng.codes
    assert sum(count_code(plan, P, c) for c in teng.codes) == matches
    assert make_executor("torch", device="cpu").run(
        plan, tg, batch=32).count == matches


@pytest.mark.parametrize("pname", PATTERNS)
@pytest.mark.parametrize("gname", sorted(GRAPH_ARGS))
def test_enumerate_join_equals_reference(pname, gname):
    """The join on device='cpu': every JoinStats field equals the
    reference's (bytes_shuffled at 8 bytes an int64 entry, steps,
    max_intermediate_rows), and its matches equal torch's count."""
    jg, tg = graphs(gname)
    want = jax_enumerate_join(jax_get_pattern(pname), jg)
    got = enumerate_join(get_pattern(pname), tg, device="cpu")
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    _, plan = plans_of(pname, gname)
    assert got.matches == make_executor("torch", device="cpu").run(
        plan, tg, batch=32).count


def test_brute_force_oracles_equal_reference():
    jg, tg = jax_er(14, 30, seed=2), erdos_renyi(14, 30, seed=2)
    for pname in ("triangle", "square", "house"):
        assert enumerate_matches_brute(get_pattern(pname), tg) == \
            jax_brute(jax_get_pattern(pname), jg)
        assert count_isomorphic_subgraphs(get_pattern(pname), tg) == \
            jax_count_isomorphic(jax_get_pattern(pname), jg)


def test_join_needs_a_device_or_a_card(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        enumerate_join(get_pattern("triangle"), erdos_renyi(10, 20, seed=1))
