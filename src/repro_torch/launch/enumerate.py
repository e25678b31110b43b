"""Subgraph-enumeration launcher of the port (static B-BENU, one device).

    PYTHONPATH=src python -m repro_torch.launch.enumerate \\
        --pattern chordal-square --n 2000 --edges 8000 \\
        [--engine torch|torch-gpu] [--device cpu] [--vcbc]

Generates a synthetic graph, compiles the best execution plan (Alg. 3 with
all optimizations) and runs it through the port's Executor API on the card
(``--device cpu`` runs the plain PyTorch versions instead). ``torch-gpu``
fuses single-use DBQ gathers into the intersect kernel. Prints the same
``matches :`` and ``frontier rows/level`` lines as
``repro.launch.enumerate``.
"""

from __future__ import annotations

import argparse
import time


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--pattern", default="chordal-square")
    ap.add_argument("--n", type=int, default=2000)
    ap.add_argument("--edges", type=int, default=8000)
    ap.add_argument("--graph", choices=["er", "powerlaw"],
                    default="powerlaw")
    ap.add_argument("--engine", choices=["torch", "torch-gpu"],
                    default="torch-gpu")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; raises "
                         "when there is none)")
    ap.add_argument("--batch-per-shard", type=int, default=256)
    ap.add_argument("--vcbc", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    from ..core.executor import make_executor
    from ..core.pattern import get_pattern
    from ..core.plangen import generate_best_plan
    from ..graph.generate import erdos_renyi, powerlaw

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
    lv = st.extras["level_sizes"]
    print(f"fused fetch        : "
          f"{'on' if st.extras['fused_fetch'] else 'off'}")
    print(f"frontier rows/level: {lv.tolist()}")


if __name__ == "__main__":
    main()
