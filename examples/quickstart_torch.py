"""Quickstart on the port: compile a best execution plan and enumerate a
pattern.

Counterpart of ``examples/quickstart.py`` that imports only
``repro_torch``: the same power-law graph and chordal-square pattern, the
plan of Alg. 3, the frontier engine on the card (unless ``--device
cpu``), and the brute-force check.

    PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
"""

import argparse

from repro_torch.core.engine_torch import enumerate_graph, resolve_device
from repro_torch.core.pattern import get_pattern
from repro_torch.core.plangen import generate_best_plan
from repro_torch.core.ref_engine import count_isomorphic_subgraphs
from repro_torch.graph.generate import powerlaw


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; raises "
                         "when there is none)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    # 1. a data graph (power-law, like the paper's social networks)
    g = powerlaw(n=500, m_per_node=4, seed=0)
    print(f"data graph: {g.n} vertices, {g.m} edges")

    # 2. the pattern: the chordal square (core of the paper's hard patterns)
    p = get_pattern("chordal-square")

    # 3. Alg. 3: search matching orders, apply CSE/reordering/triangle-cache
    plan = generate_best_plan(p, g.stats())
    print("\nbest execution plan (paper §4):")
    print(plan.pretty())

    # 4. run the vectorized frontier engine on the device
    result = enumerate_graph(plan, g, batch=128, device=dev)
    print(f"\nmatches found: {result['count']} (on {dev})")

    # 5. cross-check against brute force
    expected = count_isomorphic_subgraphs(p, g)
    if result["count"] != expected:
        raise SystemExit(f"brute force gives {expected}, the engine "
                         f"{result['count']}")
    print(f"brute-force check: {expected} — OK")
    return result["count"]


if __name__ == "__main__":
    main()
