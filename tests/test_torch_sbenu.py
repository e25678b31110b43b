"""The port's streaming S-BENU against the JAX package, on CPU.

Graphs and update streams come from the same seed in both packages; the
port runs with ``device="cpu"`` (every INT resolves to the binary-search
probe, the reference's non-TPU default, so both engines build the same
frontiers). Exact agreement is the bar (tolerance 0): ΔR⁺/ΔR⁻ match sets,
counters, per-chunk level sizes and snapshot blocks are integers.
"""

import dataclasses
import os
import pkgutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.core.estimate import GraphStats as JaxGraphStats
from repro.core.pattern import get_pattern as jax_get_pattern
from repro.core.sbenu import generate_best_sbenu_plans as jax_sbenu_plans
from repro.core.sbenu import run_timestep as jax_run_timestep
from repro.graph.dynamic import DeviceSnapshotStore as JaxSnapshotMirror
from repro.graph.dynamic import SnapshotStore as JaxSnapshotStore
from repro.graph.dynamic import stream_width_floors as jax_width_floors
from repro.graph.generate import edge_stream as jax_edge_stream
from repro.graph.generate import random_digraph as jax_random_digraph

import repro_torch
from repro_torch.convert import device_snapshot_from_numpy, plan_from_fields
from repro_torch.core.engine_sbenu_torch import (build_sbenu_multi_enumerator,
                                                 plan_level_count)
from repro_torch.core.estimate import GraphStats
from repro_torch.core.executor import (ExecutorConfig, SBenuTorchBackend,
                                       drive, make_executor)
from repro_torch.core.pattern import get_pattern
from repro_torch.core.sbenu import (generate_best_sbenu_plans, run_timestep,
                                    snapshot_diff_oracle)
from repro_torch.graph.dynamic import (SNAPSHOT_BLOCKS, DeviceSnapshotStore,
                                       SnapshotStore, derive_rows,
                                       stream_width_floors)
from repro_torch.graph.generate import edge_stream, random_digraph

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SBENU_PATTERNS = ["dtoy", "q1'", "q2'", "q3'", "q5'"]
# the stream of test_sbenu_jax_stream_conformance
STREAM = dict(n=24, m_init=110, steps=3, batch=24, seed=17, delete_frac=0.4)


def streams():
    """(reference stream, port stream) from the same seed."""
    return jax_edge_stream(**STREAM), edge_stream(**STREAM)


def plans_of(pname):
    stats = (STREAM["n"], STREAM["m_init"])
    jplans = jax_sbenu_plans(jax_get_pattern(pname),
                             JaxGraphStats(*stats, delta_edges=24))
    plans = generate_best_sbenu_plans(get_pattern(pname),
                                      GraphStats(*stats, delta_edges=24))
    return jplans, plans


# --------------------------------------------------------------------------
# Graphs, streams and plans: copies of the reference's
# --------------------------------------------------------------------------


def test_digraph_and_edge_stream_equal_reference():
    (jg0, jbatches), (g0, batches) = streams()
    assert batches == jbatches
    assert list(g0.edges()) == list(jg0.edges())
    for di in ("out", "in"):
        np.testing.assert_array_equal(g0.padded_adjacency(di),
                                      jg0.padded_adjacency(di))
    assert list(random_digraph(50, 200, seed=3).edges()) == \
        list(jax_random_digraph(50, 200, seed=3).edges())
    assert stream_width_floors(g0, batches) == \
        jax_width_floors(jg0, jbatches)


@pytest.mark.parametrize("pname", SBENU_PATTERNS)
def test_sbenu_plans_equal_reference(pname):
    jplans, plans = plans_of(pname)
    assert len(plans) == len(jplans)
    for jp, tp in zip(jplans, plans):
        jd, td = dataclasses.asdict(jp), dataclasses.asdict(tp)
        assert td == jd
        carried = plan_from_fields(jd)
        assert carried == tp
        assert [(i.op, i.adj_type, i.adj_dir, i.adj_op) for i in
                carried.instrs] == \
            [(i.op, i.adj_type, i.adj_dir, i.adj_op) for i in jp.instrs]
        assert carried.delta_edge == jp.delta_edge


# --------------------------------------------------------------------------
# Snapshot store: blocks equal the reference's across a stream
# --------------------------------------------------------------------------


@pytest.mark.parametrize("pinned", [False, True])
@pytest.mark.parametrize("storage", ["device", "host"])
def test_snapshot_store_blocks_equal_reference(storage, pinned):
    (jg0, jbatches), (g0, batches) = streams()
    d, dd = stream_width_floors(g0, batches) if pinned else (0, 0)
    jst, tst = JaxSnapshotStore(jg0), SnapshotStore(g0)
    jm = JaxSnapshotMirror(jst, d_min=d, delta_d_min=dd, storage=storage)
    tm = DeviceSnapshotStore(tst, d_min=d, delta_d_min=dd, storage=storage,
                             device="cpu")
    for jb, tb in zip(jbatches, batches):
        jst.begin_step(jb)
        tst.begin_step(tb)
        if storage == "host":
            for di in ("out", "in"):
                for which in ("prev", "cur"):
                    ids = np.arange(-1, tst.n + 2)
                    np.testing.assert_array_equal(
                        tm.row_source(di, which).gather(ids),
                        jm.row_source(di, which).gather(ids))
        js, ts = jm.step_snapshot(), tm.step_snapshot()
        hs = tst.device_snapshot(d_min=d, delta_d_min=dd)
        jhs = jst.device_snapshot(d_min=d, delta_d_min=dd)
        for k in SNAPSHOT_BLOCKS:
            got = getattr(ts, k)
            got = got.numpy() if torch.is_tensor(got) else got
            np.testing.assert_array_equal(got, np.asarray(getattr(js, k)),
                                          err_msg=k)
            np.testing.assert_array_equal(getattr(hs, k), getattr(jhs, k),
                                          err_msg=k)
        if storage == "device":
            for di in ("out", "in"):
                stacked = getattr(ts, f"stacked_{di}")
                assert stacked.shape[0] == 2 * (tst.n + 1)
                assert getattr(ts, f"prev_{di}").data_ptr() == \
                    stacked.data_ptr()
        jst.end_step()
        tst.end_step()
    assert tm.rebuilds == jm.rebuilds
    assert tm.rebuilds == 1 or not pinned


def test_derive_rows_equals_derive_host():
    (_, _), (g0, batches) = streams()
    st = SnapshotStore(g0)
    host = DeviceSnapshotStore(st, storage="host", device="cpu")
    st.begin_step(batches[0])
    for di, delta in (("out", st.delta_out), ("in", st.delta_in)):
        host._ensure_prev_fits()
        tids, merged = host._derive_host(host._prev[di], delta)
        vals, signs, _ = host._delta_buffers(delta)
        got = derive_rows(torch.from_numpy(host._prev[di].to_rows()),
                          torch.from_numpy(tids), torch.from_numpy(vals),
                          torch.from_numpy(signs), st.n)
        np.testing.assert_array_equal(got.numpy(), merged)
    st.end_step()


# --------------------------------------------------------------------------
# sbenu-torch == sbenu-jax == interpreter == brute snapshot diff
# --------------------------------------------------------------------------


@pytest.mark.parametrize("pname", SBENU_PATTERNS)
def test_sbenu_torch_stream_equals_jax_interpreter_and_oracle(pname):
    """ΔR_t^+ / ΔR_t^- agree exactly across the JAX package's vectorized
    engine, the port's vectorized engine in both snapshot storages, the
    port's interpreter and the brute-force snapshot diff, on a randomized
    stream with insertions and deletions."""
    from repro.core.executor import SBenuJaxBackend
    (jg0, jbatches), (g0, batches) = streams()
    jplans, plans = plans_of(pname)
    p = get_pattern(pname)
    jstore = JaxSnapshotStore(jg0)
    stores = {k: SnapshotStore(g0) for k in ("device", "host", "ref")}
    jbackend = SBenuJaxBackend()
    backends = {k: SBenuTorchBackend(snapshot_storage=k, device="cpu")
                for k in ("device", "host")}
    for jb, tb in zip(jbatches, batches):
        want_p, want_m = snapshot_diff_oracle(p, stores["ref"], tb)
        assert any(op == "-" for op, _, _ in tb)     # deletions exercised
        jp, jm, jc = jax_run_timestep(jax_get_pattern(pname), jplans, jstore,
                                      jb, backend=jbackend, chunk=16)
        assert jp == want_p and jm == want_m
        for k, be in backends.items():
            tp, tm, tc = run_timestep(p, plans, stores[k], tb, backend=be,
                                      chunk=16)
            assert (tp, tm) == (want_p, want_m), k
            assert (tc.matches_plus, tc.matches_minus) == \
                (jc.matches_plus, jc.matches_minus)
        rp, rm, _ = run_timestep(p, plans, stores["ref"], tb, engine="ref")
        assert (rp, rm) == (want_p, want_m)


@pytest.mark.parametrize("pname", SBENU_PATTERNS)
def test_per_chunk_level_sizes_equal_jax_multi_enumerator(pname):
    """The same snapshot (carried across by device_snapshot_from_numpy),
    start chunks and caps: counts, overflow, per-level sizes and the
    collected match rows equal build_sbenu_multi_enumerator's, chunk by
    chunk, overflowing chunks included."""
    import jax
    import jax.numpy as jnp
    from repro.core.engine_sbenu_jax import (
        build_sbenu_multi_enumerator as jax_multi, device_put_snapshot)
    (jg0, jbatches), _ = streams()
    jplans, _ = plans_of(pname)
    plans = [plan_from_fields(dataclasses.asdict(p)) for p in jplans]
    jst = JaxSnapshotStore(jg0)
    jst.begin_step(jbatches[0])
    jsnap = device_put_snapshot(jst.device_snapshot())
    n = jst.n
    snap = device_snapshot_from_numpy(
        {k: np.asarray(getattr(jsnap, k)) for k in SNAPSHOT_BLOCKS}, n, "cpu")
    starts = np.asarray(jst.start_vertices(), np.int32)
    for cap in (4, 256):
        caps_list = [[cap] * plan_level_count(p) for p in plans]
        jrun = jax.jit(jax_multi(jplans, n, caps_list, collect_matches=True))
        trun = build_sbenu_multi_enumerator(plans, n, caps_list,
                                            collect_matches=True)
        for s0 in range(0, len(starts), 8):
            ids = np.full(8, n, np.int32)
            chunk = starts[s0:s0 + 8]
            ids[:len(chunk)] = chunk
            valid = np.arange(8) < len(chunk)
            jr = jrun(jsnap, jnp.asarray(ids), jnp.asarray(valid))
            tr = trun(snap, torch.from_numpy(ids), torch.from_numpy(valid))
            for f in ("count_plus", "count_minus", "overflow"):
                assert int(getattr(tr, f)) == int(getattr(jr, f)), f
            assert [int(s) for s in tr.level_sizes] == \
                [int(s) for s in jr.level_sizes]
            jv = np.asarray(jr.matches_valid)
            np.testing.assert_array_equal(tr.matches_valid.numpy(), jv)
            np.testing.assert_array_equal(tr.matches.numpy()[jv],
                                          np.asarray(jr.matches)[jv])
            np.testing.assert_array_equal(tr.match_ops.numpy()[jv],
                                          np.asarray(jr.match_ops)[jv])
    jst.end_step()


def test_sbenu_torch_forced_overflow_stays_exact():
    """Tiny capacities force the driver to re-split delta chunks (the
    case of test_sbenu_jax_forced_overflow_stays_exact); the match sets
    stay exact and the splits are the JAX backend's."""
    from repro.core.executor import ExecutorConfig as JaxConfig
    from repro.core.executor import SBenuJaxBackend
    from repro.core.executor import drive as jax_drive
    args = dict(n=40, m_init=250, steps=1, batch=40, seed=5)
    jg0, jbatches = jax_edge_stream(**args)
    g0, batches = edge_stream(**args)
    p = get_pattern("q1'")
    plans = generate_best_sbenu_plans(p, GraphStats(40, 250, delta_edges=40))
    jplans = jax_sbenu_plans(jax_get_pattern("q1'"),
                             JaxGraphStats(40, 250, delta_edges=40))
    store, jstore = SnapshotStore(g0), JaxSnapshotStore(jg0)
    want_p, want_m = snapshot_diff_oracle(p, store, batches[0])
    store.begin_step(batches[0])
    jstore.begin_step(jbatches[0])
    cfg = dict(batch=32, caps=[4, 4, 4], max_retries=12,
               collect_matches=True)
    st = drive(SBenuTorchBackend(device="cpu"), plans, store,
               ExecutorConfig(**cfg))
    jx = jax_drive(SBenuJaxBackend(), jplans, jstore, JaxConfig(**cfg))
    store.end_step()
    jstore.end_step()
    assert st.extras["delta_plus"] == want_p
    assert st.extras["delta_minus"] == want_m
    assert st.chunks_split > 0
    assert (st.chunks_run, st.chunks_split, st.chunks_retried) == \
        (jx.chunks_run, jx.chunks_split, jx.chunks_retried)


# --------------------------------------------------------------------------
# CLI, entry points, package boundary
# --------------------------------------------------------------------------


def _delta_lines(text):
    """The per-step ``dR+ / dR-`` counts and the totals line."""
    out = []
    for ln in text.splitlines():
        if ln.startswith("step "):
            f = ln.split()
            out.append((f[0], f[1], f[2], f[3], f[4], f[5]))
        elif ln.startswith("total dR+"):
            out.append(ln)
    return out


def test_cli_sbenu_lines_equal_reference(monkeypatch, capsys):
    from repro.launch import enumerate as jax_cli
    from repro_torch.launch import enumerate as cli
    args = ["--pattern", "q2'", "--n", "300", "--edges", "1500",
            "--steps", "2", "--update-batch", "60", "--batch-per-shard",
            "32"]
    monkeypatch.setattr(sys, "argv",
                        ["enumerate", *args, "--engine", "sbenu-jax"])
    jax_cli.main()
    want = _delta_lines(capsys.readouterr().out)
    assert len(want) == 3
    for engine in ("sbenu-torch", "sbenu"):
        cli.main([*args, "--engine", engine, "--device", "cpu"])
        out = capsys.readouterr().out
        assert _delta_lines(out) == want, engine
    assert "rebuilds 1" not in out               # the interpreter has none


def test_new_entry_points_raise_without_a_card(monkeypatch):
    from repro_torch.launch.enumerate import main
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for engine in ("oocache", "sbenu-torch"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_executor(engine)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--engine", "sbenu-torch", "--pattern", "q1'", "--n", "20",
              "--edges", "40"])
    assert make_executor("sbenu-torch",
                         device="cpu").backend.device.type == "cpu"


NEW_MODULES = ("graph.hoststore", "graph.dynamic", "distributed.rowcache",
               "core.engine_ooc", "core.sbenu", "core.engine_sbenu_torch")


def test_new_modules_import_neither_jax_nor_repro():
    """The package-boundary scan of tests/test_torch_plan.py walks every
    module; this pins that the walk reaches the slice's modules and that
    importing them alone loads no jax and nothing of repro."""
    mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                  "repro_torch.")]
    for mod in NEW_MODULES:
        assert f"repro_torch.{mod}" in mods, mod
    code = (
        "import importlib, sys\n"
        f"for m in {[f'repro_torch.{m}' for m in NEW_MODULES]!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'repro' or m.startswith('repro.')]\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
