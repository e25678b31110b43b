"""Continuous subgraph enumeration with S-BENU (paper §5) on the port.

Counterpart of ``examples/continuous_enum.py`` that imports only
``repro_torch``: the same stream of batch updates over a dynamic directed
graph and the same pattern ``q3'``. Each time step runs on the card
(unless ``--device cpu``) through the vectorized delta-frontier engine
(``sbenu-torch``), and its appearing and disappearing matches are checked
against the brute-force snapshot diff and against the interpreter, whose
DBQ count the table shows (the reference example's column).

    PYTHONPATH=src python examples/continuous_enum_torch.py [--device cpu]
"""

import argparse

from repro_torch.core.engine_torch import resolve_device
from repro_torch.core.estimate import GraphStats
from repro_torch.core.executor import SBenuTorchBackend
from repro_torch.core.pattern import get_pattern
from repro_torch.core.sbenu import (generate_best_sbenu_plans, run_timestep,
                                    snapshot_diff_oracle)
from repro_torch.graph.dynamic import SnapshotStore, stream_width_floors
from repro_torch.graph.generate import edge_stream


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; raises "
                         "when there is none)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    p = get_pattern("q3'")        # directed triangle + 2-path chord
    g0, batches = edge_stream(n=150, m_init=900, steps=5, batch=60, seed=1)
    # one store for the device engine, one for the interpreter
    store, ref_store = SnapshotStore(g0), SnapshotStore(g0)
    d, dd = stream_width_floors(g0, batches)
    backend = SBenuTorchBackend(collect="matches", d_min=d, delta_d_min=dd,
                                device=dev)

    plans = generate_best_sbenu_plans(
        p, GraphStats(150, 900, delta_edges=60))
    print(f"{p.name}: {len(plans)} incremental execution plans "
          f"(one per pattern edge)\n")
    print("plan for the first incremental pattern graph dP_1:")
    print(plans[0].pretty())

    rows = []
    print(f"\nstep |  dR+  |  dR-  | DBQ queries   (sbenu-torch on {dev})")
    for t, batch in enumerate(batches, 1):
        want = snapshot_diff_oracle(p, store, batch)
        dp, dm, _ = run_timestep(p, plans, store, batch,
                                 engine="sbenu-torch", backend=backend)
        rp, rm, ctr = run_timestep(p, plans, ref_store, batch)
        if (dp, dm) != want or (rp, rm) != want:
            raise SystemExit(f"step {t}: the engine's dR+/dR- differ from "
                             f"the snapshot diff")
        rows.append((len(dp), len(dm), ctr.dbq))
        print(f"{t:4d} | {len(dp):5d} | {len(dm):5d} | {ctr.dbq}")
    print("\nall steps validated against the snapshot-diff oracle")
    return rows


if __name__ == "__main__":
    main()
