"""The port's frontier engine and driver against the JAX package, on CPU.

Exact agreement is the bar (tolerance 0: counts, frontier sizes and match
sets are integers). The port runs with ``device="cpu"``, where every
intersection resolves to a plain PyTorch version; the CUDA kernels are
held to those plain versions in tests/test_torch_kernels.py and on the
card by chip_smoke.py.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.core.engine_jax import DeviceGraph as JaxDeviceGraph
from repro.core.engine_jax import build_enumerator as jax_build_enumerator
from repro.core.executor import make_executor as jax_make_executor
from repro.core.pattern import get_pattern as jax_get_pattern
from repro.core.plangen import generate_best_plan as jax_best_plan
from repro.core.ref_engine import enumerate_matches_brute
from repro.core.symmetry import symmetry_breaking_constraints
from repro.graph.generate import erdos_renyi as jax_er
from repro.graph.generate import powerlaw as jax_pl

from repro_torch.convert import device_graph_from_numpy, plan_from_fields
from repro_torch.core.engine_torch import (_liveness, build_enumerator,
                                           count_only_enus)
from repro_torch.core.executor import (ExecutorConfig, TorchBackend,
                                       TorchGpuBackend, drive, make_executor,
                                       plan_enu_count)
from repro_torch.core.pattern import get_pattern
from repro_torch.core.plangen import generate_best_plan
from repro_torch.graph.generate import erdos_renyi, powerlaw

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

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


@pytest.mark.parametrize("pname", PATTERNS)
@pytest.mark.parametrize("gname", sorted(GRAPH_ARGS))
def test_torch_backends_equal_jax_and_brute(pname, gname):
    jg, tg = graphs(gname)
    jplan = jax_best_plan(jax_get_pattern(pname), jg.stats())
    plan = generate_best_plan(get_pattern(pname), tg.stats())
    jx = jax_make_executor("jax").run(jplan, jg, batch=32)
    want = len(brute_set(pname, jg))
    for engine in ("torch", "torch-gpu"):
        st = make_executor(engine, device="cpu").run(plan, tg, batch=32)
        assert st.count == jx.count == want, (engine, pname, gname)
        np.testing.assert_array_equal(st.extras["level_sizes"],
                                      jx.extras["level_sizes"])
        assert st.extras["fused_fetch"] is (engine == "torch-gpu")


def _chunk_inputs(n, batch, seed):
    rng = np.random.default_rng(seed)
    ids = rng.permutation(n)[:batch].astype(np.int32)
    valid = rng.random(batch) < 0.8
    return np.where(valid, ids, n).astype(np.int32), valid


@pytest.mark.parametrize("pname,gname", [("triangle", "pl"),
                                         ("clique4", "er"),
                                         ("house", "pl"),
                                         ("square", "er"),
                                         ("cycle5", "pl")])
@pytest.mark.parametrize("fused", [False, True])
def test_per_chunk_results_equal_engine_jax(pname, gname, fused):
    """Same ids, caps, plan and rows (carried across by convert.py):
    count, overflow, per-level sizes and the match rows agree chunk by
    chunk, including chunks that overflow their capacities."""
    import jax.numpy as jnp
    from repro.core.executor import build_universe_chunks
    jg, _ = graphs(gname)
    jplan = jax_best_plan(jax_get_pattern(pname), jg.stats())
    jdg = JaxDeviceGraph.from_graph(jg)
    plan = plan_from_fields(dataclasses.asdict(jplan))
    dg = device_graph_from_numpy(np.array(jdg.rows), jdg.n, "cpu")
    n_enu = plan_enu_count(plan)
    uni = build_universe_chunks(jg.n, 16)[1]
    for caps in ((16,) * n_enu, (512,) * n_enu):
        jrun = jax_build_enumerator(
            jplan, jdg.n, caps, jdg.local_fetch(), collect_matches=True,
            fused_rows=jdg.rows if fused else None,
            gather_intersect_impl="ref")
        trun = build_enumerator(
            plan, dg.n, caps, dg.local_fetch(), collect_matches=True,
            fused_rows=dg.rows if fused else None)
        for seed in range(3):
            ids, valid = _chunk_inputs(jg.n, 24, seed)
            jargs = [jnp.asarray(ids), jnp.asarray(valid)]
            targs = [torch.from_numpy(ids), torch.from_numpy(valid)]
            if any(v[0] == "VG" for i in plan.instrs for v in i.operands):
                jargs.append(jnp.asarray(uni))
                targs.append(torch.from_numpy(uni))
            jr, tr = jrun(*jargs), trun(*targs)
            assert int(tr.count) == int(jr.count)
            assert int(tr.overflow) == int(jr.overflow)
            assert [int(s) for s in tr.level_sizes] == \
                [int(s) for s in jr.level_sizes]
            jv = np.asarray(jr.matches_valid)
            np.testing.assert_array_equal(tr.matches_valid.numpy(), jv)
            np.testing.assert_array_equal(tr.matches.numpy()[jv],
                                          np.asarray(jr.matches)[jv])


@pytest.mark.parametrize("pname,gname", [("triangle", "pl"),
                                         ("clique4", "er"),
                                         ("house", "pl"),
                                         ("square", "er"),
                                         ("cycle5", "pl")])
@pytest.mark.parametrize("fused", [False, True])
def test_per_chunk_counts_equal_engine_jax(pname, gname, fused):
    """Counting only (the plan's last ENU runs count-only and builds no
    child frontier): count, overflow and per-level sizes agree with the
    JAX engine chunk by chunk, at caps that overflow in some chunks,
    and at caps that only the count-only level can overflow (1 there):
    it does wherever a chunk has two matches or more."""
    import jax.numpy as jnp
    from repro.core.executor import build_universe_chunks
    jg, _ = graphs(gname)
    jplan = jax_best_plan(jax_get_pattern(pname), jg.stats())
    jdg = JaxDeviceGraph.from_graph(jg)
    plan = plan_from_fields(dataclasses.asdict(jplan))
    dg = device_graph_from_numpy(np.array(jdg.rows), jdg.n, "cpu")
    n_enu = plan_enu_count(plan)
    last_enu = max(i for i, ins in enumerate(plan.instrs)
                   if ins.op == "ENU")
    assert count_only_enus(plan, _liveness(plan)) == {last_enu}
    uni = build_universe_chunks(jg.n, 16)[1]
    last = []
    for caps in ((16,) * n_enu, (512,) * n_enu,
                 (1 << 14,) * (n_enu - 1) + (1,)):
        jrun = jax_build_enumerator(
            jplan, jdg.n, caps, jdg.local_fetch(),
            fused_rows=jdg.rows if fused else None,
            gather_intersect_impl="ref")
        trun = build_enumerator(
            plan, dg.n, caps, dg.local_fetch(),
            fused_rows=dg.rows if fused else None)
        for seed in range(3):
            ids, valid = _chunk_inputs(jg.n, 24, seed)
            jargs = [jnp.asarray(ids), jnp.asarray(valid)]
            targs = [torch.from_numpy(ids), torch.from_numpy(valid)]
            if any(v[0] == "VG" for i in plan.instrs for v in i.operands):
                jargs.append(jnp.asarray(uni))
                targs.append(torch.from_numpy(uni))
            jr, tr = jrun(*jargs), trun(*targs)
            assert int(tr.count) == int(jr.count)
            assert int(tr.overflow) == int(jr.overflow)
            assert [int(s) for s in tr.level_sizes] == \
                [int(s) for s in jr.level_sizes]
            assert tr.matches is None
            if caps[-1] == 1:
                # no earlier level overflows: all overflow is the last's
                assert all(int(s) < c for s, c in
                           zip(tr.level_sizes, caps[:-1]))
                last.append((int(tr.count), int(tr.overflow)))
    # clique4 on the er graph has no match in these chunks
    assert any(ov for _, ov in last) or not any(c for c, _ in last)


@pytest.mark.parametrize("engine", ["torch", "torch-gpu"])
def test_match_set_exact_under_forced_overflow(engine):
    jg, tg = graphs("pl")
    plan = generate_best_plan(get_pattern("house"), tg.stats())
    caps = [8] * plan_enu_count(plan)
    st = make_executor(engine, device="cpu").run(
        plan, tg, batch=16, caps=caps, max_retries=12, collect_matches=True)
    got = {tuple(int(x) for x in r) for r in st.matches}
    assert st.chunks_split > 0
    assert got == brute_set("house", jg) and len(st.matches) == len(got)


@pytest.mark.parametrize("compaction", ["cumsum", "sort"])
def test_square_universe_chunk_plan(compaction):
    """The square's wedge order consumes V(G) on the er graph: the driver
    threads 16-wide universe chunks (as tests/test_ooc.py sets it up)."""
    jg, tg = graphs("er")
    plan = generate_best_plan(get_pattern("square"), tg.stats())
    assert any(v[0] == "VG" for i in plan.instrs for v in i.operands)
    st = drive(TorchGpuBackend(device="cpu", compaction=compaction), plan,
               tg, ExecutorConfig(batch=32, universe_chunk=16))
    assert st.count == len(brute_set("square", jg))


@pytest.mark.parametrize("pname", ["triangle", "chordal-square", "house"])
def test_vcbc_counts_exact(pname):
    """The VCBC plans of tests/test_engines.py (pl graph, seed 2)."""
    jg, tg = jax_pl(50, 4, seed=2), powerlaw(50, 4, seed=2)
    plan = generate_best_plan(get_pattern(pname), tg.stats(), vcbc=True)
    st = make_executor("torch", device="cpu").run(plan, tg, batch=32)
    assert st.count == len(brute_set(pname, jg))


def test_fused_fetch_env_toggle():
    """The backend alone decides the fetch path: ``torch`` never fuses,
    ``torch-gpu`` always does, and both give the brute-force count."""
    jg, tg = graphs("pl")
    plan = generate_best_plan(get_pattern("triangle"), tg.stats())
    want = len(brute_set("triangle", jg))
    for cls, fused in ((TorchBackend, False), (TorchGpuBackend, True)):
        be = cls(device="cpu")
        st = drive(be, plan, tg, ExecutorConfig(batch=16))
        assert st.count == want
        assert be.fused is fused and st.extras["fused_fetch"] is fused


def test_cli_matches_line_equals_reference():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    args = ["--pattern", "triangle", "--n", "120", "--edges", "480",
            "--batch-per-shard", "64"]

    def matches_line(cmd):
        out = subprocess.run([sys.executable, "-m", *cmd, *args], env=env,
                             capture_output=True, text=True, timeout=120,
                             check=True).stdout
        return [ln for ln in out.splitlines() if ln.startswith("matches")]

    want = matches_line(["repro.launch.enumerate", "--engine", "jax"])
    got = matches_line(["repro_torch.launch.enumerate", "--engine",
                        "torch-gpu", "--device", "cpu"])
    assert len(want) == 1 and got == want
