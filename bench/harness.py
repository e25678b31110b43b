"""Run one cell of ``BENCHMARK.json`` once and print its result line.

A cell names a configuration (``bench/configs/<config>.json``: the data
graph and the engine) and a traffic mix
(``bench/traffic/<traffic>.json``: the pattern and the start batch); each
metric it reports is read by ``bench/metrics/<metric>.py``. All are
found by name, so a cell, a configuration or a metric is added by adding
files and entries.

One run: set-up (CUDA, the two intersect kernels built or loaded, the
graph drawn from the seed, the plan, one warm-up query), then a closed
loop of one client for ``--seconds``: B-BENU queries back to back, each
one ``Executor(backend).run(plan, graph, batch=...)`` over every start
vertex; the query in flight at the deadline is finished and counted.
With ``--trace 1`` the cell's per-layer metrics are read, the program's
counters over the window and the device's share over
``spans.TRACED_QUERIES`` more queries that run under ``torch.profiler``
once the window has closed; with ``--trace 0`` its end-to-end ones.
Once the peak memory is read, the program's state is freed and the
plain reference (``bench/reference/counts.py``) counts the copies again:
every query, the warm-up and the traced ones too, must have returned
that count.
"""

from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np

SPEC = Path(__file__).resolve().parents[1] / "BENCHMARK.json"
#: top-level module names that may not be loaded in a run's process: the
#: JAX package the program was ported from, and JAX itself
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclass
class Query:
    """One query of the window, as the driver returned it."""

    count: int
    seconds: float
    chunks_run: int
    chunks_split: int
    chunks_retried: int
    extras: Dict[str, Any]


@dataclass
class Run:
    """Everything a metric reader may read."""

    cell: str
    config: dict
    traffic: dict
    seed: int
    device: Any
    n: int = 0
    setup_s: float = 0.0
    window_s: float = 0.0
    queries: List[Query] = field(default_factory=list)
    traced: List[Query] = field(default_factory=list)  # after the window
    peak_bytes: int = 0
    plan: Any = None
    row_width: Optional[int] = None   # the program's padded row, int32s
    card: str = ""
    trace: Optional[dict] = None      # spans.Tracer.summarize's output


def bench_file(root: Path, kind: str, name: str,
               suffix: str = ".json") -> Path:
    """``<root>/bench/<kind>/<name><suffix>``; raises when it is
    missing."""
    path = Path(root) / "bench" / kind / f"{name}{suffix}"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} {name!r}: {path} is missing")
    return path


def load_json(root: Path, kind: str, name: str) -> dict:
    return json.loads(bench_file(root, kind, name).read_text())


def load_reader(root: Path, name: str):
    """``bench/metrics/<name>.py`` as a module (``read(run)``, ``UNIT``,
    ``LAYER``, ``SOURCE``, ``MOVES``)."""
    path = bench_file(root, "metrics", name, ".py")
    spec = importlib.util.spec_from_file_location(
        f"bench_metric_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_spec(spec: dict, cell: str) -> dict:
    for w in spec["workloads"]:
        if w["name"] == cell:
            return w
    raise KeyError(f"no cell {cell!r} in the benchmark; have "
                   f"{[w['name'] for w in spec['workloads']]}")


def metrics_of(spec: dict, cell: str, trace: bool) -> List[dict]:
    """The cell's end-to-end metrics, or with ``trace`` its per-layer
    ones."""
    group = spec["per_layer"] if trace else spec["end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]


def make_graph(config: dict, seed: int, device):
    """The benchmark's CSR, drawn on ``device``, and the program's
    ``Graph`` over the same arrays."""
    from bench.graphgen import make_graph as draw
    from repro_torch.graph.storage import Graph
    csr = draw(config, seed, device)
    adj = np.split(csr.col, csr.indptr[1:-1])
    return csr, Graph(csr.n, adj)


def run_query(executor, plan, graph, traffic: dict, device) -> Query:
    import torch
    t0 = time.perf_counter()
    st = executor.run(plan, graph, batch=int(traffic["batch"]))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return Query(count=int(st.count), seconds=time.perf_counter() - t0,
                 chunks_run=st.chunks_run, chunks_split=st.chunks_split,
                 chunks_retried=st.chunks_retried, extras=dict(st.extras))


def row_width(backend) -> Optional[int]:
    """The padded adjacency width the program placed (int32s a row)."""
    dg = getattr(backend, "dg", None)
    return None if dg is None else int(dg.d)


def run(cell: str, seed: int, seconds: float, trace: bool, device,
        spec_path: Path = SPEC, t_start: Optional[float] = None
        ) -> Dict[str, Any]:
    """One run of ``cell``; returns the result line's object. ``device``
    is the card, or the CPU in a test (the plain versions run there)."""
    import torch
    from bench import spans
    from bench.reference.counts import count as reference_count
    from repro_torch.core.executor import make_executor
    from repro_torch.core.pattern import get_pattern
    from repro_torch.core.plangen import generate_best_plan

    t_start = time.perf_counter() if t_start is None else t_start
    root = Path(spec_path).resolve().parent
    spec = json.loads(Path(spec_path).read_text())
    w = cell_spec(spec, cell)
    config = load_json(root, "configs", w["config"])
    traffic = load_json(root, "traffic", w["traffic"])
    device = torch.device(device)
    r = Run(cell=cell, config=config, traffic=traffic, seed=seed,
            device=device)
    readers = {m["name"]: load_reader(root, m["name"])
               for m in metrics_of(spec, cell, trace)}

    # ---- set-up
    marks = {"imports": time.perf_counter()}
    if device.type == "cuda":
        torch.cuda.init()
        from repro_torch.kernels import build
        build.build(config["kernels"])
        r.card = torch.cuda.get_device_name(device)
    marks["cuda and kernels"] = time.perf_counter()
    csr, graph = make_graph(config, seed, device)
    r.n = csr.n
    marks["graph"] = time.perf_counter()
    r.plan = generate_best_plan(get_pattern(traffic["pattern"]),
                                graph.stats())
    executor = make_executor(config["engine"], device=device)
    marks["plan"] = time.perf_counter()
    warm = run_query(executor, r.plan, graph, traffic, device)
    r.row_width = row_width(executor.backend)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    r.setup_s = time.perf_counter() - t_start
    marks["warm-up query"] = t_start + r.setup_s
    prev, parts = t_start, []
    for name, t in marks.items():
        parts.append(f"{name} {t - prev:.3f}")
        prev = t
    print(f"{cell} set-up s: " + ", ".join(parts), file=sys.stderr)

    # ---- the window: one client, queries back to back
    t0 = time.perf_counter()
    while True:
        r.queries.append(run_query(executor, r.plan, graph, traffic, device))
        if time.perf_counter() - t0 >= seconds:
            break
    r.window_s = time.perf_counter() - t0
    if device.type == "cuda":
        r.peak_bytes = int(torch.cuda.max_memory_allocated(device))
    if trace:
        tracer = spans.Tracer(executor, device)
        with tracer:
            for _ in range(spans.TRACED_QUERIES):
                r.traced.append(run_query(executor, r.plan, graph, traffic,
                                          device))
        t_read = time.perf_counter()
        r.trace = tracer.summarize()
        print(f"{cell} trace: {len(r.traced)} queries in "
              f"{tracer.window_s:.3f} s, read in "
              f"{time.perf_counter() - t_read:.3f} s", file=sys.stderr)
        del tracer
    describe(r, warm)

    # ---- the check, after the program's state is freed
    del executor, graph
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    want = reference_count(traffic["pattern"], csr, device=device)
    got = [q.count for q in r.queries + r.traced]
    correct, checks = judge(got, warm.count, want)
    failed = sum(c != want for c in got)

    metrics = {}
    for name, reader in readers.items():
        value = reader.read(r)
        if value is not None:
            metrics[name] = {"value": value, "unit": reader.UNIT}
    out = {"correct": bool(correct), "attempted": len(got),
           "failed": int(failed), "metrics": metrics,
           "device": device_info(device, r)}
    if r.trace is not None:
        out["breakdown"] = {"device_ops": r.trace["device_ops"],
                            "idle_gaps": r.trace["idle_gaps"]}
    out["checks"] = checks
    return out


def judge(counts: List[int], warm: int, want: int):
    """``(correct, checks)``: every count, the warm-up query's too, equals
    the reference's; each check is a number beside its limit."""
    checks = {"count_gap": {"value": max(abs(c - want) for c in counts),
                            "limit": 0},
              "warmup_count_gap": {"value": abs(warm - want), "limit": 0}}
    return (all(c["value"] <= c["limit"] for c in checks.values()),
            checks)


def catalog(spec_path: Path = SPEC) -> Dict[str, dict]:
    """Every cell with the files it runs from: its configuration, its
    traffic and the readers of its metrics (raises where one is
    missing)."""
    root = Path(spec_path).resolve().parent
    spec = json.loads(Path(spec_path).read_text())
    out = {}
    for w in spec["workloads"]:
        out[w["name"]] = {
            "config": bench_file(root, "configs", w["config"]),
            "traffic": bench_file(root, "traffic", w["traffic"]),
            "metrics": {m["name"]: bench_file(root, "metrics", m["name"],
                                              ".py")
                        for trace in (False, True)
                        for m in metrics_of(spec, w["name"], trace)}}
    return out


def describe(r: Run, warm: Query) -> None:
    """What the window's queries did, on standard error."""
    q = r.queries[-1]
    levels = [int(x) for x in q.extras.get("level_sizes", ())]
    print(f"{r.cell} seed {r.seed}: setup {r.setup_s:.3f} s (warm-up query "
          f"{warm.seconds:.3f} s), window {r.window_s:.3f} s, "
          f"{len(r.queries)} queries of {_spread(r.queries)} s; a query: count "
          f"{q.count}, chunks run/split/retried {q.chunks_run}/"
          f"{q.chunks_split}/{q.chunks_retried}, levels {levels}, prepare "
          f"{q.extras.get('prepare_s', 0.0):.3f} s, row width "
          f"{r.row_width}", file=sys.stderr)


def _spread(queries: List[Query]) -> str:
    """A query's seconds: all of them when few, else min / median / max."""
    secs = sorted(q.seconds for q in queries)
    if len(secs) <= 12:
        return str([round(x, 3) for x in secs])
    return (f"min {secs[0]:.3f} / median {secs[len(secs) // 2]:.3f} / "
            f"max {secs[-1]:.3f}")


def device_info(device, r: Run) -> Dict[str, Any]:
    if device.type != "cuda":
        info = {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": 0}
    else:
        info = {"platform": "gpu", "kind": r.card, "count": 1,
                "memory_peak_bytes": r.peak_bytes}
    if r.trace is not None:
        info["busy_s"] = r.trace["busy_s"]
        info["window_s"] = r.trace["window_s"]
    return info


def loaded_forbidden() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def main(argv=None, t_start: Optional[float] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    import torch
    spec = json.loads(SPEC.read_text())
    chips = int(cell_spec(spec, args.workload)["chips"])
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < chips:
        print(f"needs {chips} CUDA device(s); found {found}",
              file=sys.stderr)
        return 2
    out = run(args.workload, args.seed, args.seconds, bool(args.trace),
              "cuda", t_start=t_start)
    bad = loaded_forbidden()
    if bad:
        print(f"the run loaded {bad}: the benchmark measures the port, and "
              "nothing of JAX or the JAX package may load", file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0
