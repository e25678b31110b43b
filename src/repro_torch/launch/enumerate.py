"""Subgraph-enumeration launcher of the port (one device).

    PYTHONPATH=src python -m repro_torch.launch.enumerate \\
        --pattern chordal-square --n 2000 --edges 8000 \\
        [--engine torch|torch-gpu|oocache] [--device cpu] [--vcbc]

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
device snapshot. Both print the reference's per-step ``dR+ / dR-`` lines.
"""

from __future__ import annotations

import argparse
import time


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
    print(f"pattern {args.pattern}: {len(plans)} incremental plans "
          f"(one per delta edge)")
    if args.engine == "sbenu-torch":
        # one backend for the whole stream, widths pinned over every step:
        # the resident blocks are built once
        from ..core.executor import SBenuTorchBackend
        d, dd = stream_width_floors(g0, batches)
        backend = SBenuTorchBackend(collect="counts", d_min=d,
                                    delta_d_min=dd,
                                    snapshot_storage=args.snapshot_storage,
                                    device=device)
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
        print(f"step {step}: dR+ {ctr.matches_plus:>8}  "
              f"dR- {ctr.matches_minus:>8}  {dt:6.2f}s  "
              f"{args.update_batch / max(dt, 1e-9):,.0f} updates/s")
    print(f"\nengine             : {args.engine}")
    print(f"total dR+ / dR-    : {total_p} / {total_m}")
    print(f"wall time          : {t_all:.2f}s over {args.steps} steps")
    if backend is not None:
        print(f"device             : {backend.device} (snapshot storage "
              f"{args.snapshot_storage}, rebuilds {backend.dstore.rebuilds})")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--pattern", default="chordal-square")
    ap.add_argument("--n", type=int, default=2000)
    ap.add_argument("--edges", type=int, default=8000)
    ap.add_argument("--graph", choices=["er", "powerlaw"],
                    default="powerlaw")
    ap.add_argument("--engine",
                    choices=["torch", "torch-gpu", "oocache", "sbenu",
                             "sbenu-torch"],
                    default="torch-gpu")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; raises "
                         "when there is none)")
    ap.add_argument("--batch-per-shard", type=int, default=256)
    ap.add_argument("--hot", type=int, default=64,
                    help="oocache: pinned top-degree rows (degree-relabeled "
                         "load)")
    ap.add_argument("--cache-frac", type=float, default=0.15,
                    help="oocache: device LRU slab size as a fraction of N")
    ap.add_argument("--no-prefetch", action="store_true",
                    help="oocache: disable the async next-chunk prefetch")
    ap.add_argument("--snapshot-storage", choices=["device", "host"],
                    default="device",
                    help="sbenu-torch: 'host' keeps resident blocks in "
                         "host-RAM shards (no persistent device memory "
                         "between steps; each step moves full blocks)")
    ap.add_argument("--vcbc", action="store_true")
    ap.add_argument("--steps", type=int, default=3,
                    help="time steps (continuous engines)")
    ap.add_argument("--update-batch", type=int, default=200,
                    help="edge updates per time step (continuous engines)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    if args.engine in ("sbenu", "sbenu-torch"):
        _run_continuous(args)
        return

    from ..core.executor import make_executor
    from ..core.pattern import get_pattern
    from ..core.plangen import generate_best_plan
    from ..graph.generate import erdos_renyi, powerlaw

    if args.engine == "oocache":
        ex = make_executor("oocache", cache_frac=args.cache_frac,
                           hot=args.hot, prefetch=not args.no_prefetch,
                           device=args.device)
    else:
        ex = make_executor(args.engine, device=args.device)
    P = get_pattern(args.pattern)
    g = (powerlaw(args.n, max(args.edges // args.n, 2), seed=args.seed)
         if args.graph == "powerlaw"
         else erdos_renyi(args.n, args.edges, seed=args.seed))
    plan = generate_best_plan(P, g.stats(), vcbc=args.vcbc)
    print(plan.pretty())

    t0 = time.time()
    st = ex.run(plan, g, batch=args.batch_per_shard)
    dt = time.time() - t0
    print(f"\nengine             : {args.engine} "
          f"({ex.backend.device})")
    print(f"matches            : {st.count}")
    print(f"wall time          : {dt:.2f}s")
    print(f"chunks run         : {st.chunks_run} "
          f"(split {st.chunks_split}, retried {st.chunks_retried})")
    if args.engine == "oocache":
        c = st.extras["cache"]
        print(f"host store         : {st.extras['host_store_bytes'] / 1e6:.1f}MB "
              f"in {st.extras['host_store_shards']} shards")
        print(f"device resident    : {st.extras['device_resident_rows']} rows "
              f"({st.extras['device_resident_bytes'] / 1e6:.2f}MB = "
              f"{st.extras['device_resident_rows'] / (g.n + 1) * 100:.1f}% of N)")
        print(f"row queries        : {c['queries']} ({c['hit_rate'] * 100:.1f}% "
              f"served without a host fetch)")
        print(f"cold rows fetched  : {c['cold_rows']} "
              f"({c['bytes_demand'] / 1e6:.2f}MB demand + "
              f"{c['bytes_prefetch'] / 1e6:.2f}MB prefetch)")
        print(f"prefetch used      : {c['prefetch_used']} rows; "
              f"evictions {c['evictions']}")
        for lvl, (q, cold, b) in c["per_level"].items():
            print(f"  DBQ level {lvl}      : {q:>9} queries  {cold:>8} cold  "
                  f"{b / 1e6:8.2f}MB")
        print(f"lookup host time   : {st.extras['lookup_host_s']:.3f}s")
        return
    lv = st.extras["level_sizes"]
    print(f"fused fetch        : "
          f"{'on' if st.extras['fused_fetch'] else 'off'}")
    print(f"frontier rows/level: {lv.tolist()}")


if __name__ == "__main__":
    main()
