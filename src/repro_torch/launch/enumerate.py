"""Subgraph-enumeration launcher of the port.

    PYTHONPATH=src python -m repro_torch.launch.enumerate \\
        --pattern chordal-square --n 2000 --edges 8000 \\
        [--engine torch|torch-gpu|ref|dist|oocache] [--device cpu] [--vcbc] \\
        [--devices N] [--hot 64] [--rebalance]

Generates a synthetic graph, compiles the best execution plan (Alg. 3 with
all optimizations) and runs it through the port's Executor API on the card
(``--device cpu`` runs the plain PyTorch versions instead). ``torch-gpu``
fuses single-use DBQ gathers into the intersect kernel. Prints the same
``matches :`` and ``frontier rows/level`` lines as
``repro.launch.enumerate``.

``--engine oocache`` runs the out-of-core fetch path: adjacency rows live
in host-RAM shards, device memory holds only a bounded row cache
(``--cache-frac`` of N rows + ``--hot`` pinned top-degree rows) and the
next chunk's rows are prefetched while the current chunk computes; the
report adds hit rate / cold rows / bytes moved per DBQ level.

Continuous enumeration (S-BENU, Alg. 4) runs the timestep loop instead:

    PYTHONPATH=src python -m repro_torch.launch.enumerate \\
        --engine sbenu-torch --pattern "q1'" --n 5000 --edges 25000 \\
        --steps 3 --update-batch 500 [--snapshot-storage host]

``--engine sbenu`` interprets every task on the host; ``--engine
sbenu-torch`` runs the vectorized delta-frontier engine over the six-block
device snapshot; ``--engine sbenu-dist`` shards the six blocks over the
ranks. All print the reference's per-step ``dR+ / dR-`` lines.

``dist`` and ``sbenu-dist`` run one process per shard over
torch.distributed. Under torchrun (``RANK`` / ``WORLD_SIZE`` set) each
process joins that group; otherwise ``--devices N`` spawns N ranks here:
NCCL with one card a rank (more ranks than cards is an error), or gloo
with ``--device cpu``. Without ``--devices`` the run is a world of one
rank in this process. Only rank 0 prints. ``--engine ref`` interprets
every task on the host and prints the remote DBQ rows of its model.

``--trace PATH`` traces the run (``core/trace.py``): rank 0 writes the
spans to PATH as Chrome trace-event JSON and prints the self time of each
span name.
"""

from __future__ import annotations

import argparse
import os
import shutil
import tempfile
import time
from contextlib import nullcontext
from datetime import timedelta

import torch
import torch.distributed as dist


def say(*args) -> None:
    """print, on rank 0 only when a process group is initialised."""
    if not dist.is_initialized() or dist.get_rank() == 0:
        print(*args, flush=True)


def _rank_main(rank: int, world: int, backend: str, init_method: str,
               fn, args) -> None:
    kw = {}
    if backend == "nccl":
        kw["device_id"] = torch.device(
            "cuda", int(os.environ.get("LOCAL_RANK", rank)))
        torch.cuda.set_device(kw["device_id"])
    else:           # CPU ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world, timeout=timedelta(seconds=600),
                            **kw)
    try:
        fn(*args)
        # no rank tears its connections down while a peer still reads
        # from them
        dist.barrier()
    finally:
        dist.destroy_process_group()


def run_on_ranks(n_ranks: int, device, fn, *args) -> None:
    """Run ``fn(*args)`` in every rank of a process group: NCCL with one
    card a rank, or gloo when ``device`` is ``'cpu'``. Under torchrun
    (``RANK`` / ``WORLD_SIZE`` set) this process joins that group;
    otherwise ``n_ranks`` processes are spawned here (one rank runs in
    this process), meeting through a file store in a temporary
    directory. More ranks than cards raises: there is no CPU fallback."""
    backend = "gloo" if device is not None and \
        torch.device(device).type == "cpu" else "nccl"
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        _rank_main(int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"]),
                   backend, "env://", fn, args)
        return
    n_ranks = max(n_ranks, 1)
    if backend == "nccl" and n_ranks > torch.cuda.device_count():
        raise RuntimeError(
            f"{n_ranks} NCCL ranks need {n_ranks} CUDA cards, one a rank; "
            f"this machine has {torch.cuda.device_count()} (no CUDA device "
            "is a CPU run only with --device cpu)")
    tmp = tempfile.mkdtemp(prefix="repro_torch_pg_")
    init = "file://" + os.path.join(tmp, "store")
    try:
        if n_ranks == 1:
            _rank_main(0, 1, backend, init, fn, args)
        else:
            import torch.multiprocessing as mp
            mp.spawn(_rank_main, args=(n_ranks, backend, init, fn, args),
                     nprocs=n_ranks)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _run_continuous(args) -> None:
    """Algorithm 4's timestep loop over the chosen S-BENU backend."""
    from ..core.estimate import GraphStats
    from ..core.pattern import get_pattern
    from ..core.sbenu import generate_best_sbenu_plans, run_timestep
    from ..graph.dynamic import SnapshotStore, stream_width_floors
    from ..graph.generate import edge_stream

    backend = None
    if args.engine == "sbenu-torch":
        # resolve the device before the (host) stream is generated, so a
        # missing card raises at once
        from ..core.engine_torch import resolve_device
        device = resolve_device(args.device)
    P = get_pattern(args.pattern)
    if not P.directed:
        raise SystemExit(f"--engine {args.engine} needs a directed pattern "
                         f"(q1'..q5', dtoy); got {args.pattern!r}")
    g0, batches = edge_stream(n=args.n, m_init=args.edges, steps=args.steps,
                              batch=args.update_batch, seed=args.seed)
    store = SnapshotStore(g0)
    stats = GraphStats(args.n, args.edges, delta_edges=args.update_batch)
    plans = generate_best_sbenu_plans(P, stats)
    say(f"pattern {args.pattern}: {len(plans)} incremental plans "
        f"(one per delta edge)")
    if args.engine in ("sbenu-torch", "sbenu-dist"):
        # one backend for the whole stream, widths pinned over every step:
        # the resident blocks are built once
        from ..core.executor import SBenuDistBackend, SBenuTorchBackend
        d, dd = stream_width_floors(g0, batches)
        if args.engine == "sbenu-torch":
            backend = SBenuTorchBackend(
                collect="counts", d_min=d, delta_d_min=dd,
                snapshot_storage=args.snapshot_storage, device=device)
        else:
            backend = SBenuDistBackend(
                collect="counts", d_min=d, delta_d_min=dd, hot=args.hot,
                rebalance=args.rebalance, device=args.device)
    total_p = total_m = 0
    t_all = 0.0
    for step, batch in enumerate(batches, 1):
        t0 = time.time()
        dp, dm, ctr = run_timestep(P, plans, store, batch,
                                   engine=args.engine, backend=backend,
                                   chunk=args.batch_per_shard,
                                   collect="counts")
        dt = time.time() - t0
        t_all += dt
        total_p += ctr.matches_plus
        total_m += ctr.matches_minus
        say(f"step {step}: dR+ {ctr.matches_plus:>8}  "
            f"dR- {ctr.matches_minus:>8}  {dt:6.2f}s  "
            f"{args.update_batch / max(dt, 1e-9):,.0f} updates/s")
    say(f"\nengine             : {args.engine}")
    say(f"total dR+ / dR-    : {total_p} / {total_m}")
    say(f"wall time          : {t_all:.2f}s over {args.steps} steps")
    if args.engine == "sbenu-torch":
        say(f"device             : {backend.device} (snapshot storage "
            f"{args.snapshot_storage}, rebuilds {backend.dstore.rebuilds})")
    elif args.engine == "sbenu-dist":
        say(f"mesh               : {backend.S} ranks on {backend.device.type} "
            f"(hot {args.hot} rows replicated, "
            f"rebalance {'on' if args.rebalance else 'off'})")


def _run(args) -> None:
    """One engine run (in every rank for ``dist`` / ``sbenu-dist``)."""
    if args.engine in ("sbenu", "sbenu-torch", "sbenu-dist"):
        _run_continuous(args)
        return

    from ..core.executor import make_executor
    from ..core.pattern import get_pattern
    from ..core.plangen import generate_best_plan
    from ..graph.generate import erdos_renyi, powerlaw

    batch = args.batch_per_shard
    if args.engine == "oocache":
        ex = make_executor("oocache", cache_frac=args.cache_frac,
                           hot=args.hot, prefetch=not args.no_prefetch,
                           device=args.device)
    elif args.engine == "dist":
        ex = make_executor("dist", hot=args.hot, rebalance=args.rebalance,
                           device=args.device)
        batch *= dist.get_world_size()
    elif args.engine == "ref":
        ex = make_executor("ref")
    else:
        ex = make_executor(args.engine, device=args.device)
    P = get_pattern(args.pattern)
    g = (powerlaw(args.n, max(args.edges // args.n, 2), seed=args.seed)
         if args.graph == "powerlaw"
         else erdos_renyi(args.n, args.edges, seed=args.seed))
    plan = generate_best_plan(P, g.stats(), vcbc=args.vcbc)
    say(plan.pretty())

    t0 = time.time()
    st = ex.run(plan, g, batch=batch)
    dt = time.time() - t0
    where = "host" if args.engine == "ref" else ex.backend.device
    say(f"\nengine             : {args.engine} ({where})")
    say(f"matches            : {st.count}")
    say(f"wall time          : {dt:.2f}s")
    say(f"chunks run         : {st.chunks_run} "
        f"(split {st.chunks_split}, retried {st.chunks_retried})")
    if args.engine == "ref":
        say(f"remote DBQ rows    : {st.extras['remote_queries']}")
    elif args.engine == "dist":
        cold, row = st.extras["cold_rows_fetched"], ex.backend.spec.d * 4
        say(f"cold rows fetched  : {cold} "
            f"(x {row}B row bytes = {cold * row / 1e6:.1f}MB)")
        say(f"per-shard matches  : "
            f"{st.extras['per_shard_counts'].tolist()}")
        say(f"request budget     : {st.extras['req_cap']} ids a peer "
            f"({st.drops_seen} requests dropped and retried)")
    elif args.engine == "oocache":
        c = st.extras["cache"]
        say(f"host store         : {st.extras['host_store_bytes'] / 1e6:.1f}MB "
            f"in {st.extras['host_store_shards']} shards")
        say(f"device resident    : {st.extras['device_resident_rows']} rows "
            f"({st.extras['device_resident_bytes'] / 1e6:.2f}MB = "
            f"{st.extras['device_resident_rows'] / (g.n + 1) * 100:.1f}% of N)")
        say(f"row queries        : {c['queries']} ({c['hit_rate'] * 100:.1f}% "
            f"served without a host fetch)")
        say(f"cold rows fetched  : {c['cold_rows']} "
            f"({c['bytes_demand'] / 1e6:.2f}MB demand + "
            f"{c['bytes_prefetch'] / 1e6:.2f}MB prefetch)")
        say(f"prefetch used      : {c['prefetch_used']} rows; "
            f"evictions {c['evictions']}")
        for lvl, (q, cold, b) in c["per_level"].items():
            say(f"  DBQ level {lvl}      : {q:>9} queries  {cold:>8} cold  "
                f"{b / 1e6:8.2f}MB")
        say(f"lookup host time   : {st.extras['lookup_host_s']:.3f}s")
    else:
        lv = st.extras["level_sizes"]
        say(f"fused fetch        : "
            f"{'on' if st.extras['fused_fetch'] else 'off'}")
        say(f"frontier rows/level: {lv.tolist()}")


def _traced_run(args) -> None:
    """``_run``, inside ``trace.recording()`` when ``--trace`` names a
    file."""
    from ..core import trace
    with trace.recording() if args.trace else nullcontext() as rec:
        _run(args)
    if rec is None or (dist.is_initialized() and dist.get_rank() != 0):
        return
    spans = rec.spans
    trace.to_chrome(spans, args.trace)
    say(f"trace              : {len(spans)} spans of {len(rec.queries)} "
        f"queries -> {args.trace}")
    for name, s in sorted(trace.self_times(spans).items(),
                          key=lambda kv: -kv[1]):
        say(f"  self {name:<20}: {s:.4f}s")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--pattern", default="chordal-square")
    ap.add_argument("--n", type=int, default=2000)
    ap.add_argument("--edges", type=int, default=8000)
    ap.add_argument("--graph", choices=["er", "powerlaw"],
                    default="powerlaw")
    ap.add_argument("--engine",
                    choices=["torch", "torch-gpu", "ref", "dist", "oocache",
                             "sbenu", "sbenu-torch", "sbenu-dist"],
                    default="torch-gpu")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card, one a rank "
                         "for dist/sbenu-dist; raises when there is none); "
                         "'cpu' runs dist/sbenu-dist ranks over gloo")
    ap.add_argument("--devices", type=int, default=0,
                    help="dist/sbenu-dist: ranks to spawn here (default "
                         "one, in this process; ignored under torchrun)")
    ap.add_argument("--batch-per-shard", type=int, default=256)
    ap.add_argument("--hot", type=int, default=64,
                    help="replicated/pinned hot rows: top-degree for "
                         "dist/oocache (degree-relabeled load); the "
                         "highest-id range for sbenu-dist (streams are "
                         "not relabeled)")
    ap.add_argument("--cache-frac", type=float, default=0.15,
                    help="oocache: device LRU slab size as a fraction of N")
    ap.add_argument("--no-prefetch", action="store_true",
                    help="oocache: disable the async next-chunk prefetch")
    ap.add_argument("--snapshot-storage", choices=["device", "host"],
                    default="device",
                    help="sbenu-torch: 'host' keeps resident blocks in "
                         "host-RAM shards (no persistent device memory "
                         "between steps; each step moves full blocks)")
    ap.add_argument("--rebalance", action="store_true",
                    help="dist/sbenu-dist: stripe every child frontier "
                         "round-robin over the ranks")
    ap.add_argument("--vcbc", action="store_true")
    ap.add_argument("--steps", type=int, default=3,
                    help="time steps (continuous engines)")
    ap.add_argument("--update-batch", type=int, default=200,
                    help="edge updates per time step (continuous engines)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="trace the run: write its spans to PATH (Chrome "
                         "trace-event JSON) and print self time by span")
    args = ap.parse_args(argv)

    if args.engine in ("dist", "sbenu-dist"):
        run_on_ranks(args.devices, args.device, _traced_run, args)
    else:
        _traced_run(args)


if __name__ == "__main__":
    main()
