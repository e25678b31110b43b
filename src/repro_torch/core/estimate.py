"""Cardinality estimation for partial pattern graphs (paper §4.3.1).

BENU reuses the model of Lai et al. [8] §5.1: under an Erdős–Rényi view of
the data graph (N vertices, M undirected edges, edge probability
``p_e = 2M / (N (N-1))``), the expected number of *matches* (injective
order-sensitive embeddings) of a pattern ``p`` with ``k`` used vertices and
``b`` edges is::

    E[#matches(p)] = N (N-1) ... (N-k+1) * p_e^b

Disconnected partial patterns multiply over connected components (the paper
handles this case explicitly). Isolated pattern vertices contribute a factor
of (remaining) N each — the product form ``P(N, k) * p_e^b`` already captures
that.

For S-BENU the paper treats incremental partial patterns as undirected and
reuses this model (§5.4); delta edges are rare, so we scale each delta edge by
``p_delta = |delta| / M`` when stats provide a batch size — this keeps order
search preferring plans that touch delta sets early, mirroring the fixed
(u_si, u_ti) prefix.

The model is deliberately pluggable (the paper: "The estimation model can be
replaced if a more accurate model is proposed later").
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, Optional, Sequence, Tuple


@dataclass(frozen=True)
class GraphStats:
    """Summary statistics of the data graph used for plan costing."""

    n_vertices: int
    n_edges: int                      # undirected edge count
    delta_edges: int = 0              # |Delta o_t| for S-BENU costing

    @property
    def p_edge(self) -> float:
        n = max(self.n_vertices, 2)
        return min(1.0, 2.0 * self.n_edges / (n * (n - 1)))

    @property
    def p_delta(self) -> float:
        if self.n_edges == 0:
            return 0.0
        return min(1.0, self.delta_edges / self.n_edges)


DEFAULT_STATS = GraphStats(n_vertices=1_000_000, n_edges=10_000_000)


def _components(vertices: Sequence[int],
                edges: Iterable[Tuple[int, int]]):
    vs = list(vertices)
    idx = {v: i for i, v in enumerate(vs)}
    parent = list(range(len(vs)))

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    es = list(edges)
    for a, b in es:
        ra, rb = find(idx[a]), find(idx[b])
        if ra != rb:
            parent[ra] = rb
    comp = {}
    for v in vs:
        comp.setdefault(find(idx[v]), []).append(v)
    comps = []
    for members in comp.values():
        ms = set(members)
        comps.append((members, [e for e in es if e[0] in ms]))
    return comps


def estimate_matches(vertices: Sequence[int],
                     edges: Sequence[Tuple[int, int]],
                     stats: GraphStats = DEFAULT_STATS,
                     delta_flags: Optional[Sequence[bool]] = None) -> float:
    """Expected #matches of the partial pattern on ``vertices``/``edges``.

    ``delta_flags[i]`` marks ``edges[i]`` as a delta edge (S-BENU costing).
    """
    if not vertices:
        return 1.0
    n = stats.n_vertices
    pe = stats.p_edge
    pd = stats.p_delta if stats.delta_edges else pe
    flag = {tuple(e): bool(delta_flags[i]) for i, e in enumerate(edges)} \
        if delta_flags is not None else {}
    total = 1.0
    for members, comp_edges in _components(vertices, edges):
        cnt = 1.0
        for i in range(len(members)):
            cnt *= max(n - i, 1)
        for e in comp_edges:
            cnt *= pd if flag.get(tuple(e), False) else pe
        total *= max(cnt, 1e-30)
    return total


class PartialPatternTracker:
    """Incrementally tracks the partial pattern during order search /
    ESTIMATECOMPUTATIONCOST scans (paper Alg. 3)."""

    def __init__(self, pattern, stats: GraphStats = DEFAULT_STATS,
                 delta_edge: int = 0):
        self.pattern = pattern
        self.stats = stats
        self.vertices: list = []
        self.edges: list = []
        self.delta_flags: list = []
        # S-BENU: 1-based index of the delta edge in pattern.edges, 0=BENU
        self.delta_edge = delta_edge

    def clone(self) -> "PartialPatternTracker":
        t = PartialPatternTracker(self.pattern, self.stats, self.delta_edge)
        t.vertices = list(self.vertices)
        t.edges = list(self.edges)
        t.delta_flags = list(self.delta_flags)
        return t

    def add_vertex(self, u: int) -> None:
        present = set(self.vertices)
        self.vertices.append(u)
        for k, (a, b) in enumerate(self.pattern.edges, start=1):
            if (a == u and b in present) or (b == u and a in present):
                self.edges.append((min(a, b), max(a, b)))
                self.delta_flags.append(k == self.delta_edge)

    def estimate(self) -> float:
        return estimate_matches(self.vertices, self.edges, self.stats,
                                self.delta_flags)
