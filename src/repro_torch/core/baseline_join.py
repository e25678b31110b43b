"""BFS-style distributed join baseline (the paper's competitor family).

Counterpart of ``repro/core/baseline_join.py``, in torch on an explicit
device (the card unless ``device=`` says otherwise). Left-deep edge join
(TwinTwig/SEED/CBF all specialize this skeleton): grow partial-match
tables one pattern edge at a time; every join step in a distributed
dataflow engine must SHUFFLE the partial-match table across the cluster
(hash repartition on the join key). The join runs on the device and
*meters* that shuffle: ``bytes_shuffled`` accumulates the byte size of
every intermediate table — the quantity BENU's on-demand design avoids
(Tables 5-6's communication column).

The tables are int64, as in the reference, so ``bytes_shuffled`` counts 8
bytes an entry and every :class:`JoinStats` field equals the reference's.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..graph.storage import Graph
from .engine_torch import resolve_device
from .pattern import Pattern
from .symmetry import symmetry_breaking_constraints


@dataclass
class JoinStats:
    matches: int
    bytes_shuffled: int
    max_intermediate_rows: int
    steps: List[Tuple[str, int]]          # (edge, rows after join)


def _edge_join_order(pattern: Pattern) -> List[Tuple[int, int]]:
    """Order pattern edges so each one shares a vertex with the prefix."""
    edges = list(pattern.undirected_edges)
    # start from the highest-degree edge (most selective joins first)
    edges.sort(key=lambda e: -(pattern.degree(e[0]) + pattern.degree(e[1])))
    out = [edges.pop(0)]
    placed = set(out[0])
    while edges:
        for i, e in enumerate(edges):
            if e[0] in placed or e[1] in placed:
                out.append(edges.pop(i))
                placed.update(e)
                break
        else:                              # disconnected remainder
            out.append(edges.pop(0))
            placed.update(out[-1])
    return out


def enumerate_join(pattern: Pattern, graph: Graph,
                   constraints: Optional[Sequence[Tuple[int, int]]] = None,
                   device=None) -> JoinStats:
    """Every match of ``pattern`` in ``graph`` by left-deep edge joins on
    ``device`` (the card by default; raises when there is none)."""
    dev = resolve_device(device)
    if constraints is None:
        constraints = symmetry_breaking_constraints(pattern)
    cons = list(constraints)
    n = graph.n
    # CSR adjacency
    deg = torch.from_numpy(np.asarray(graph.deg, np.int64)).to(dev)
    indptr = torch.zeros(n + 1, dtype=torch.int64, device=dev)
    torch.cumsum(deg, 0, out=indptr[1:])
    nbrs = torch.from_numpy(
        np.concatenate(graph.adj).astype(np.int64) if n
        else np.zeros(0, np.int64)).to(dev)
    src = torch.repeat_interleave(torch.arange(n, device=dev), deg)
    # both directions of every edge, as sorted unique keys
    edge_keys = torch.unique(src * n + nbrs)

    order = _edge_join_order(pattern)
    cols: Dict[int, int] = {}              # pattern vertex -> column index
    pm = torch.zeros((0, 0), dtype=torch.int64, device=dev)
    stats = JoinStats(matches=0, bytes_shuffled=0,
                      max_intermediate_rows=0, steps=[])

    def apply_constraints(pm: torch.Tensor, newly: int) -> torch.Tensor:
        keep = torch.ones(pm.shape[0], dtype=torch.bool, device=dev)
        cn = cols[newly]
        for a, b in cons:
            if a == newly and b in cols:
                keep &= pm[:, cn] < pm[:, cols[b]]
            elif b == newly and a in cols:
                keep &= pm[:, cols[a]] < pm[:, cn]
        # injectivity vs all mapped vertices
        for u, cu in cols.items():
            if u != newly:
                keep &= pm[:, cu] != pm[:, cn]
        return pm[keep]

    first = True
    for (a, b) in order:
        if first:
            pm = torch.stack([src, nbrs], dim=1)      # both directions
            cols = {a: 0, b: 1}
            pm = apply_constraints(pm, b)
            pm = apply_constraints(pm, a)
            first = False
        elif a in cols and b in cols:
            keys = pm[:, cols[a]] * n + pm[:, cols[b]]
            pm = pm[torch.isin(keys, edge_keys)]
        else:
            have, new = (a, b) if a in cols else (b, a)
            hv = pm[:, cols[have]]
            counts = deg[hv]
            rep = torch.repeat_interleave(
                torch.arange(pm.shape[0], device=dev), counts)
            # neighbor expansion: offsets within each row's adjacency
            offs = torch.arange(rep.shape[0], device=dev) - \
                (torch.cumsum(counts, 0) - counts)[rep]
            new_vals = nbrs[indptr[hv][rep] + offs]
            pm = torch.cat([pm[rep], new_vals[:, None]], dim=1)
            cols = dict(cols)
            cols[new] = pm.shape[1] - 1
            pm = apply_constraints(pm, new)
        rows = pm.shape[0]
        stats.bytes_shuffled += pm.numel() * pm.element_size()
        stats.max_intermediate_rows = max(stats.max_intermediate_rows, rows)
        stats.steps.append((f"({a},{b})", rows))
    stats.matches = pm.shape[0]
    return stats
