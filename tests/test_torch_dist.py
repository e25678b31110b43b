"""The port's multi-device engines (``dist``, ``sbenu-dist``) against the
JAX package's, on CPU.

The port runs one process per shard over torch.distributed; here the ranks
are gloo process groups on the CPU. The fast tests run a world of one
rank in this process against the reference on its one-device mesh; the
``slow`` ones run 4 gloo ranks (spawned) against the reference on 4
forced host devices, each side in a subprocess with a time limit, so a
rank that waits on a collective no other rank reaches fails the test
instead of hanging it. Exact agreement is the bar (tolerance 0): counts,
per-shard counts and level sizes, cold rows, drops, splits and ΔR⁺/ΔR⁻
sets are integers. The JAX package is imported inside the functions that
use it, so the spawned ranks import only the port.
"""

import importlib
import json
import os
import pkgutil
import signal
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch
import torch.distributed as dist

import repro_torch
from repro_torch.convert import row_shards_from_numpy
from repro_torch.core.engine_dist import check_group_device
from repro_torch.core.engine_sbenu_torch import (build_sbenu_enumerator,
                                                 plan_level_count)
from repro_torch.core.engine_torch import (DeviceGraph, build_enumerator,
                                           default_caps)
from repro_torch.core.executor import make_executor
from repro_torch.distributed.rowstore import (build_row_shards,
                                              make_distributed_fetch)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTS = os.path.join(ROOT, "tests")

# the graph of tests/test_distributed.py's exactness test
GRAPH = dict(n=120, m=4, seed=4)
BATCH_PER_SHARD = 16
# (pattern, hot, rebalance, req_cap): every pattern hot + rebalanced and
# plain, the triangle also with each feature alone, and the house with a
# request budget that drops (every rank must then escalate together)
STATIC_CASES = [(p, hot, reb, None)
                for p in ("triangle", "chordal-square", "house")
                for hot, reb in ((16, True), (0, False))] + \
    [("triangle", 16, False, None), ("triangle", 0, True, None),
     ("house", 16, True, 8)]
STREAM = dict(n=60, m_init=300, steps=3, batch=40, seed=17, delete_frac=0.4)
STREAM_CASES = [("q1'", 8, True), ("q2'", 8, True), ("q2'", 0, False)]
CHUNK = 8


def _summary(st) -> dict:
    """What both packages must agree on, as plain JSON-able data."""
    return dict(count=int(st.count),
                per_shard_counts=np.asarray(
                    st.extras["per_shard_counts"]).tolist(),
                per_shard_level_sizes=np.asarray(
                    st.extras["per_shard_level_sizes"]).tolist(),
                cold=int(st.extras["cold_rows_fetched"]),
                drops=int(st.drops_seen), split=int(st.chunks_split),
                retried=int(st.chunks_retried))


def _stream_summary(st) -> dict:
    out = _summary(st)
    out.update(plus=sorted(map(list, st.extras["delta_plus"])),
               minus=sorted(map(list, st.extras["delta_minus"])))
    return out


def _cases(pkg: str, **device) -> dict:
    """Every static and streaming case on package ``pkg`` (``repro`` or
    ``repro_torch``; ``device`` goes to the port's backends), over the
    world the caller set up: the mesh of every device for the JAX
    package, the initialised process group for the port."""
    def mod(name):
        return importlib.import_module(f"{pkg}.{name}")
    ex = mod("core.executor")
    get_pattern = mod("core.pattern").get_pattern
    generate = mod("graph.generate")
    dyn = mod("graph.dynamic")
    sbenu = mod("core.sbenu")
    out = {}
    g = generate.powerlaw(GRAPH["n"], GRAPH["m"], seed=GRAPH["seed"])
    for pname, hot, reb, req_cap in STATIC_CASES:
        plan = mod("core.plangen").generate_best_plan(get_pattern(pname),
                                                      g.stats())
        e = ex.make_executor("dist", hot=hot, rebalance=reb,
                             req_cap=req_cap, **device)
        st = e.run(plan, g, batch=BATCH_PER_SHARD * _world(pkg))
        out[f"{pname} hot={hot} rebalance={reb} req_cap={req_cap}"] = \
            _summary(st)
    g0, batches = generate.edge_stream(**STREAM)
    d, dd = dyn.stream_width_floors(g0, batches)
    stats = mod("core.estimate").GraphStats(STREAM["n"], STREAM["m_init"],
                                            delta_edges=STREAM["batch"])
    for pname, hot, reb in STREAM_CASES:
        plans = sbenu.generate_best_sbenu_plans(get_pattern(pname), stats)
        store = dyn.SnapshotStore(g0)
        be = ex.SBenuDistBackend(d_min=d, delta_d_min=dd, hot=hot,
                                 rebalance=reb, **device)
        for step, batch in enumerate(batches, 1):
            store.begin_step(batch)
            st = ex.drive(be, plans, store, ex.ExecutorConfig(
                batch=CHUNK, collect_matches=True))
            store.end_step()
            out[f"{pname} hot={hot} rebalance={reb} step {step}"] = \
                _stream_summary(st)
    return out


def _world(pkg: str) -> int:
    if pkg == "repro":
        import jax
        return len(jax.devices())
    return dist.get_world_size()


def _torch_rank_cases(out_path: str) -> None:
    """One rank of the spawned gloo world: run every case; rank 0 writes
    the results."""
    res = _cases("repro_torch", device="cpu")
    if dist.get_rank() == 0:
        with open(out_path, "w") as fh:
            json.dump(res, fh)


@pytest.fixture
def world_of_one(tmp_path):
    """A gloo process group of one rank in this process (file store under
    ``tmp_path``), destroyed after the test."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                            rank=0, world_size=1)
    try:
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()


def _one_device_mesh():
    import jax
    from jax.sharding import Mesh
    return Mesh(np.array(jax.devices()[:1]), ("shard",))


# --------------------------------------------------------------------------
# Fast: a world of one rank in this process
# --------------------------------------------------------------------------


@pytest.mark.parametrize("pname", ["triangle", "chordal-square", "house"])
@pytest.mark.parametrize("hot,rebalance", [(16, True), (0, False)])
def test_dist_world_of_one_equals_reference(world_of_one, pname, hot,
                                            rebalance):
    from repro.core.executor import make_executor as jax_make_executor
    from repro.core.pattern import get_pattern as jax_get_pattern
    from repro.core.plangen import generate_best_plan as jax_best_plan
    from repro.graph.generate import powerlaw as jax_powerlaw
    from repro_torch.core.pattern import get_pattern
    from repro_torch.core.plangen import generate_best_plan
    from repro_torch.graph.generate import powerlaw
    jg = jax_powerlaw(GRAPH["n"], GRAPH["m"], seed=GRAPH["seed"])
    tg = powerlaw(GRAPH["n"], GRAPH["m"], seed=GRAPH["seed"])
    jplan = jax_best_plan(jax_get_pattern(pname), jg.stats())
    plan = generate_best_plan(get_pattern(pname), tg.stats())
    want = jax_make_executor("dist", mesh=_one_device_mesh(), hot=hot,
                             rebalance=rebalance).run(
        jplan, jg, batch=BATCH_PER_SHARD)
    got = make_executor("dist", hot=hot, rebalance=rebalance,
                        device="cpu").run(plan, tg, batch=BATCH_PER_SHARD)
    assert _summary(got) == _summary(want)
    if pname == "house":
        # the default budget drops requests: escalate_requests is covered
        assert got.drops_seen > 0 and got.extras["req_cap"] > 64


@pytest.mark.parametrize("pname,hot,rebalance", STREAM_CASES)
def test_sbenu_dist_world_of_one_equals_reference(world_of_one, pname, hot,
                                                  rebalance):
    from repro.core.estimate import GraphStats as JaxGraphStats
    from repro.core.executor import ExecutorConfig as JaxConfig
    from repro.core.executor import SBenuDistBackend as JaxBackend
    from repro.core.executor import drive as jax_drive
    from repro.core.pattern import get_pattern as jax_get_pattern
    from repro.core.sbenu import generate_best_sbenu_plans as jax_plans
    from repro.graph.dynamic import SnapshotStore as JaxStore
    from repro.graph.dynamic import stream_width_floors as jax_floors
    from repro.graph.generate import edge_stream as jax_edge_stream
    from repro_torch.core.estimate import GraphStats
    from repro_torch.core.executor import (ExecutorConfig, SBenuDistBackend,
                                           drive)
    from repro_torch.core.pattern import get_pattern
    from repro_torch.core.sbenu import generate_best_sbenu_plans
    from repro_torch.graph.dynamic import SnapshotStore, stream_width_floors
    from repro_torch.graph.generate import edge_stream
    (jg0, jbatches), (g0, batches) = jax_edge_stream(**STREAM), \
        edge_stream(**STREAM)
    stats = (STREAM["n"], STREAM["m_init"])
    jplans = jax_plans(jax_get_pattern(pname),
                       JaxGraphStats(*stats, delta_edges=STREAM["batch"]))
    plans = generate_best_sbenu_plans(
        get_pattern(pname), GraphStats(*stats, delta_edges=STREAM["batch"]))
    d, dd = stream_width_floors(g0, batches)
    assert (d, dd) == jax_floors(jg0, jbatches)
    jst, tst = JaxStore(jg0), SnapshotStore(g0)
    jbe = JaxBackend(mesh=_one_device_mesh(), d_min=d, delta_d_min=dd,
                     hot=hot, rebalance=rebalance)
    tbe = SBenuDistBackend(d_min=d, delta_d_min=dd, hot=hot,
                           rebalance=rebalance, device="cpu")
    for jb, tb in zip(jbatches, batches):
        jst.begin_step(jb)
        tst.begin_step(tb)
        want = jax_drive(jbe, jplans, jst,
                         JaxConfig(batch=CHUNK, collect_matches=True))
        got = drive(tbe, plans, tst,
                    ExecutorConfig(batch=CHUNK, collect_matches=True))
        jst.end_step()
        tst.end_step()
        assert _stream_summary(got) == _stream_summary(want)
        assert got.extras["counters"].matches_plus == \
            want.extras["counters"].matches_plus
    assert tbe.dstore.rebuilds == 1


@pytest.mark.parametrize("hot", [0, 8, 100])       # zero / partial / all
def test_rowstore_fetch_equals_reference(world_of_one, hot):
    """The fetch unit against the reference's under shard_map on one
    device, on the reference's own store carried across: rows, cold rows
    and drops, with a request budget small enough to drop."""
    import dataclasses
    import jax
    from jax.sharding import PartitionSpec as P
    from repro.compat import shard_map
    from repro.distributed.rowstore import build_row_shards as jax_shards
    from repro.distributed.rowstore import \
        make_distributed_fetch as jax_fetch
    from repro.graph.generate import erdos_renyi as jax_er
    from repro_torch.graph.generate import erdos_renyi
    jg = jax_er(100, 300, seed=0)
    shards_np, hot_np, jspec = jax_shards(jg, 1, hot=hot)
    shard, hot_rows, spec = row_shards_from_numpy(
        shards_np, hot_np, dataclasses.asdict(jspec), 0, "cpu")
    # the port builds the same rank blocks from its own graph
    mine, mine_hot, mine_spec = build_row_shards(
        erdos_renyi(100, 300, seed=0), 1, 0, hot=hot, device="cpu")
    assert mine_spec == spec
    assert torch.equal(mine, shard) and torch.equal(mine_hot, hot_rows)
    lo = jg.n - min(hot, jg.n)
    rng = np.random.default_rng(1)
    ids = np.concatenate([[0, 1, lo - 1, lo, lo + 1, jg.n - 1, jg.n, jg.n],
                          rng.integers(0, jg.n + 1, 56)])
    ids = np.clip(ids, 0, jg.n).astype(np.int32)
    for req_cap in (8, 64):
        f = jax_fetch(jspec, "s", req_cap=req_cap)

        def local(shards, hot_rows_, ids_):
            rows, cold, drops = f(ids_[0], shards[0], hot_rows_)
            return rows[None], cold[None], drops[None]

        mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]), ("s",))
        run = jax.jit(shard_map(
            local, mesh=mesh,
            in_specs=(P("s", None, None), P(None, None), P("s", None)),
            out_specs=(P("s", None, None), P("s"), P("s")),
            check_vma=False))
        jrows, jcold, jdrops = run(shards_np, hot_np, ids[None])
        rows, cold, drops = make_distributed_fetch(
            spec, world_of_one, req_cap)(torch.from_numpy(ids), shard,
                                         hot_rows)
        np.testing.assert_array_equal(rows.numpy(), np.asarray(jrows)[0])
        assert (int(cold), int(drops)) == \
            (int(np.asarray(jcold)[0]), int(np.asarray(jdrops)[0]))
        if req_cap == 8 and hot < 100:
            assert int(drops) > 0


def test_row_shards_of_every_rank_equal_reference():
    """build_row_shards builds only its rank's block: for each rank of 4
    it equals that rank's slice of the reference's [S, rps, D] store."""
    from repro.distributed.rowstore import build_row_shards as jax_shards
    from repro.graph.generate import powerlaw as jax_powerlaw
    from repro_torch.graph.generate import powerlaw
    jg = jax_powerlaw(GRAPH["n"], GRAPH["m"], seed=GRAPH["seed"])
    tg = powerlaw(GRAPH["n"], GRAPH["m"], seed=GRAPH["seed"])
    shards_np, hot_np, jspec = jax_shards(jg, 4, hot=16)
    for rank in range(4):
        shard, hot_rows, spec = build_row_shards(tg, 4, rank, hot=16,
                                                 device="cpu")
        np.testing.assert_array_equal(shard.numpy(), shards_np[rank])
        np.testing.assert_array_equal(hot_rows.numpy(), hot_np)
        assert (spec.n, spec.d, spec.rows_per_shard, spec.hot) == \
            (jspec.n, jspec.d, jspec.rows_per_shard, jspec.hot)


@pytest.mark.parametrize("hot", [0, 8])
def test_sharded_snapshot_blocks_equal_reference(world_of_one, hot):
    """The rank's six blocks and replicas of the sharded snapshot store,
    step by step over a stream, equal the reference's on its one-device
    mesh, carried across by snapshot_shard_from_numpy."""
    import dataclasses
    from repro.graph.dynamic import ShardedDeviceSnapshotStore as JaxStore
    from repro.graph.dynamic import SnapshotStore as JaxSnapshotStore
    from repro.graph.generate import edge_stream as jax_edge_stream
    from repro_torch.convert import snapshot_shard_from_numpy
    from repro_torch.core.engine_sbenu_dist import BLOCK_ORDER
    from repro_torch.graph.dynamic import (ShardedDeviceSnapshotStore,
                                           SnapshotStore,
                                           stream_width_floors)
    from repro_torch.graph.generate import edge_stream
    (jg0, jbatches), (g0, batches) = jax_edge_stream(**STREAM), \
        edge_stream(**STREAM)
    d, dd = stream_width_floors(g0, batches)
    jst, tst = JaxSnapshotStore(jg0), SnapshotStore(g0)
    jm = JaxStore.for_store(jst, _one_device_mesh(), d_min=d,
                            delta_d_min=dd, hot=hot)
    tm = ShardedDeviceSnapshotStore.for_store(tst, world_of_one, d_min=d,
                                              delta_d_min=dd, hot=hot,
                                              device="cpu")
    for jb, tb in zip(jbatches, batches):
        jst.begin_step(jb)
        tst.begin_step(tb)
        jblocks, jhot, jspec = jm.step_sharded()
        want, want_hot, spec = snapshot_shard_from_numpy(
            {k: np.asarray(v) for k, v in jblocks.items()},
            {k: np.asarray(v) for k, v in jhot.items()},
            dataclasses.asdict(jspec), 0, "cpu")
        blocks, hot_blocks, tspec = tm.step_sharded()
        assert tspec == spec
        for k in BLOCK_ORDER:
            assert torch.equal(blocks[k], want[k]), k
            assert torch.equal(hot_blocks[k], want_hot[k]), k
        jst.end_step()
        tst.end_step()
    assert tm.rebuilds == 1


def _reverse(env, valid):
    return {k: v.flip(0) for k, v in env.items()}, valid.flip(0)


@pytest.mark.parametrize("hook", [lambda env, valid: (env, valid), _reverse],
                         ids=["identity", "reverse"])
def test_post_expand_hook_keeps_counts_and_matches(hook):
    """Both engines call post_expand after every expansion; a hook that
    leaves the frontier as it is, or reverses its order, changes neither
    the counts nor the match sets."""
    from repro_torch.core.estimate import GraphStats
    from repro_torch.core.pattern import get_pattern
    from repro_torch.core.plangen import generate_best_plan
    from repro_torch.core.sbenu import generate_best_sbenu_plans
    from repro_torch.graph.dynamic import SnapshotStore
    from repro_torch.graph.generate import edge_stream, powerlaw
    g = powerlaw(GRAPH["n"], GRAPH["m"], seed=GRAPH["seed"])
    plan = generate_best_plan(get_pattern("house"), g.stats())
    dg = DeviceGraph.from_graph(g, torch.device("cpu"))
    caps = default_caps(plan, g.n, dg.d)
    starts = torch.arange(g.n, dtype=torch.int32)
    valid = torch.ones(g.n, dtype=torch.bool)

    def static(post):
        r = build_enumerator(plan, g.n, caps, dg.local_fetch(),
                             collect_matches=True, post_expand=post)(
            starts, valid)
        assert int(r.overflow) == 0
        return int(r.count), {tuple(m) for m in
                              r.matches[r.matches_valid].tolist()}

    assert static(hook) == static(None)
    assert static(None)[0] > 0

    g0, batches = edge_stream(**STREAM)
    store = SnapshotStore(g0)
    store.begin_step(batches[0])
    snap = store.device_snapshot()
    ids = torch.tensor(store.start_vertices(), dtype=torch.int32)
    ok = torch.ones(ids.shape[0], dtype=torch.bool)
    stats = GraphStats(STREAM["n"], STREAM["m_init"],
                       delta_edges=STREAM["batch"])

    def stream(post):
        out = []
        for p in generate_best_sbenu_plans(get_pattern("q2'"), stats):
            r = build_sbenu_enumerator(
                p, g0.n, [4096] * plan_level_count(p), collect_matches=True,
                post_expand=post)(snap, ids, ok)
            assert int(r.overflow) == 0
            rows = torch.cat([r.matches, r.match_ops[:, None]], 1)
            out.append((int(r.count_plus), int(r.count_minus),
                        {tuple(m) for m in rows[r.matches_valid].tolist()}))
        return out

    assert stream(hook) == stream(None)
    assert sum(c + m for c, m, _ in stream(None)) > 0


def test_engines_refuse_without_a_group_or_with_a_foreign_device(
        tmp_path, monkeypatch):
    """No initialised process group: dist and sbenu-dist raise (no world
    of one behind the caller's back); NCCL with CPU tensors or gloo with
    CUDA tensors raises; no device and no card raises at once."""
    from repro_torch.core.pattern import get_pattern
    from repro_torch.core.plangen import generate_best_plan
    from repro_torch.graph.dynamic import SnapshotStore
    from repro_torch.graph.generate import edge_stream, erdos_renyi
    assert not dist.is_initialized()
    g = erdos_renyi(30, 60, seed=1)
    plan = generate_best_plan(get_pattern("triangle"), g.stats())
    with pytest.raises(RuntimeError, match="no torch.distributed"):
        make_executor("dist", device="cpu").run(plan, g, batch=8)
    g0, batches = edge_stream(**STREAM)
    store = SnapshotStore(g0)
    store.begin_step(batches[0])
    with pytest.raises(RuntimeError, match="no torch.distributed"):
        make_executor("sbenu-dist", device="cpu").run([], store, batch=8)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                            rank=0, world_size=1)
    try:
        with pytest.raises(ValueError, match="cannot carry cuda"):
            check_group_device(dist.group.WORLD, torch.device("cuda", 0))
        monkeypatch.setattr(dist, "get_backend", lambda group=None: "nccl")
        with pytest.raises(ValueError, match="cannot carry cpu"):
            make_executor("dist", device="cpu").run(plan, g, batch=8)
    finally:
        dist.destroy_process_group()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for engine in ("dist", "sbenu-dist"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_executor(engine)


NEW_MODULES = ("core.ref_engine", "core.baseline_join", "core.engine_dist",
               "core.engine_sbenu_dist", "distributed.rowstore")


def test_new_modules_import_neither_jax_nor_repro():
    """The package-boundary scans of tests/test_torch_plan.py walk every
    module and chip_smoke.py; this pins that the walk reaches the slice's
    modules and that importing them alone loads no jax and nothing of
    repro."""
    mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                  "repro_torch.")]
    for mod in NEW_MODULES:
        assert f"repro_torch.{mod}" in mods, mod
    code = (
        "import importlib, sys\n"
        f"for m in {[f'repro_torch.{m}' for m in NEW_MODULES]!r}:\n"
        "    importlib.import_module(m)\n"
        "import repro_torch.launch.enumerate\n"
        "bad = [m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'repro' or m.startswith('repro.')]\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


# --------------------------------------------------------------------------
# Slow: 4 gloo ranks against 4 forced host devices; the CLIs
# --------------------------------------------------------------------------


def _start(code: str, env_extra: dict) -> subprocess.Popen:
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(ROOT, "src"), TESTS]), **env_extra)
    return subprocess.Popen([sys.executable, "-c", textwrap.dedent(code)],
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            start_new_session=True)


def _finish(proc: subprocess.Popen, timeout: float) -> str:
    """Wait for ``proc``; on timeout kill its whole session (the spawned
    ranks too) and fail."""
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        pytest.fail(f"timed out after {timeout} s")
    assert proc.returncode == 0, err[-3000:]
    return out


@pytest.mark.slow
def test_four_ranks_equal_reference_on_four_devices(tmp_path):
    out_path = str(tmp_path / "torch.json")
    jax_proc = _start("""
        import json, test_torch_dist as t
        assert t._world("repro") == 4
        print(json.dumps(t._cases("repro")))
    """, {"XLA_FLAGS": "--xla_force_host_platform_device_count=4"})
    torch_proc = _start(f"""
        import test_torch_dist as t
        from repro_torch.launch.enumerate import run_on_ranks
        run_on_ranks(4, "cpu", t._torch_rank_cases, {out_path!r})
    """, {})
    want = json.loads(_finish(jax_proc, 400).strip().splitlines()[-1])
    _finish(torch_proc, 400)
    with open(out_path) as fh:
        got = json.load(fh)
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key] == want[key], key
        assert len(got[key]["per_shard_counts"]) == 4
    # the cases reach the paths they are there for
    assert got["house hot=16 rebalance=True req_cap=8"]["drops"] > 0
    assert any(v["plus"] for k, v in got.items() if "step" in k)


@pytest.mark.slow
def test_cli_matches_line_equals_reference():
    flags = ["--pattern", "house", "--n", "300", "--edges", "1200",
             "--hot", "16", "--rebalance", "--batch-per-shard", "32"]

    runs = {"jax": ("repro", "--engine", "dist", "--devices", "2"),
            "dist": ("repro_torch", "--engine", "dist", "--devices", "2",
                     "--device", "cpu"),
            "ref": ("repro_torch", "--engine", "ref")}
    procs = {k: _start(f"""
        import sys
        from {pkg}.launch.enumerate import main
        sys.argv[1:] = {flags + list(extra)!r}
        main()
    """, {}) for k, (pkg, *extra) in runs.items()}
    lines = {}
    for k, proc in procs.items():
        out = _finish(proc, 300).splitlines()
        lines[k] = [ln for ln in out
                    if ln.startswith(("matches ", "per-shard "))]
    # rank 0 prints, alone: one matches line a run
    assert lines["dist"] == lines["jax"] and len(lines["jax"]) == 2
    assert lines["ref"] == lines["jax"][:1]
