"""Data-graph storage substrate.

The paper stores adjacency sets in a distributed KV database keyed by vertex
id. Our in-memory logical form mirrors that: per-vertex *sorted* adjacency
arrays. Two physical layouts are provided:

* ``Graph`` / ``DiGraph``: python/numpy adjacency lists — used by the plan
  compiler, the drivers and the dynamic-graph machinery.
* ``padded_adjacency``: a dense ``int32[N, D]`` row matrix padded with the
  sentinel ``N`` — the device-resident layout consumed by the frontier
  engine (rows are what DBQ fetches).

**Total order / symmetry breaking**: the paper uses a degree-based total
order on V(G) for static graphs. We *relabel* vertices by ``(degree, id)``
ascending at load time (``canonicalize=True``) so that the total order is the
natural integer order — symmetry-breaking filters compile to plain integer
compares on both CPU and GPU.
"""

from __future__ import annotations

import warnings
from typing import Iterable, List, Optional, Sequence, Tuple

import numpy as np

from ..core.estimate import GraphStats

Edge = Tuple[int, int]


def padded_width(max_len: int, d_max: Optional[int] = None, lane: int = 8,
                 strict: bool = False) -> int:
    """The one padded-row width rule: ``max(d_max or max_len, 1)`` rounded
    up to a multiple of ``lane``. ``strict=True`` raises when ``d_max``
    is below ``max_len`` (callers that refuse truncation outright, e.g.
    the host row store)."""
    if strict and d_max is not None and d_max < max_len:
        raise ValueError(f"d_max={d_max} below the max degree {max_len}")
    d = max_len if d_max is None else d_max
    d = max(d, 1)
    return ((d + lane - 1) // lane) * lane


def pad_rows(adj: Sequence[np.ndarray], sentinel: int,
             d_max: Optional[int] = None, lane: int = 8,
             on_overflow: str = "raise") -> np.ndarray:
    """Pack per-vertex sorted arrays into a sentinel-padded ``int32[N, D]``.

    ``D`` is ``max(d_max or max-len, 1)`` rounded up to a multiple of
    ``lane``. When a row is longer than the final width ``D`` (so entries
    would actually be dropped), ``on_overflow`` decides: ``"raise"``
    (default) fails, ``"clamp"`` keeps the first ``D`` entries and emits a
    ``RuntimeWarning`` — never a silent truncation.
    """
    max_len = max((len(a) for a in adj), default=0)
    d = padded_width(max_len, d_max=d_max, lane=lane)
    if max_len > d:
        overfull = sum(1 for a in adj if len(a) > d)
        msg = (f"padded rows truncated: {overfull} row(s) exceed the "
               f"padded width {d} (longest has {max_len} entries)")
        if on_overflow == "raise":
            raise ValueError(msg + "; pass on_overflow='clamp' to truncate")
        if on_overflow != "clamp":
            raise ValueError(f"unknown on_overflow={on_overflow!r}")
        warnings.warn(msg, RuntimeWarning, stacklevel=2)
    rows = np.full((len(adj), d), sentinel, dtype=np.int32)
    for v, a in enumerate(adj):
        a = a[:d]
        rows[v, :len(a)] = a
    return rows


class Graph:
    """Static undirected simple graph with sorted adjacency arrays."""

    def __init__(self, n: int, adj: List[np.ndarray],
                 relabel: Optional[np.ndarray] = None):
        self.n = n
        self.adj = adj                      # adj[v]: sorted int64 array
        self.relabel = relabel              # original id -> canonical id
        self.deg = np.array([len(a) for a in adj], dtype=np.int64)

    # ------------------------------------------------------------- builders
    @staticmethod
    def from_edges(n: int, edges: Iterable[Edge],
                   canonicalize: bool = True) -> "Graph":
        nbr: List[set] = [set() for _ in range(n)]
        for a, b in edges:
            if a == b:
                continue
            nbr[a].add(b)
            nbr[b].add(a)
        if canonicalize:
            deg = np.array([len(s) for s in nbr])
            # vertices sorted by (degree, id) ascending; rank = new id
            order = np.lexsort((np.arange(n), deg))
            relabel = np.empty(n, dtype=np.int64)
            relabel[order] = np.arange(n)
            adj = [None] * n  # type: ignore
            for v in range(n):
                adj[relabel[v]] = np.array(
                    sorted(relabel[w] for w in nbr[v]), dtype=np.int64)
            return Graph(n, adj, relabel)
        adj = [np.array(sorted(s), dtype=np.int64) for s in nbr]
        return Graph(n, adj)

    # -------------------------------------------------------------- queries
    def neighbors(self, v: int) -> np.ndarray:
        return self.adj[v]

    def has_edge(self, a: int, b: int) -> bool:
        arr = self.adj[a]
        i = np.searchsorted(arr, b)
        return i < len(arr) and arr[i] == b

    @property
    def m(self) -> int:
        return int(self.deg.sum() // 2)

    def stats(self) -> GraphStats:
        return GraphStats(n_vertices=self.n, n_edges=self.m)

    def edges(self) -> Iterable[Edge]:
        for v in range(self.n):
            for w in self.adj[v]:
                if v < w:
                    yield (v, int(w))

    # ---------------------------------------------------------- dense layout
    def padded_adjacency(self, d_max: Optional[int] = None,
                         lane: int = 8, on_overflow: str = "raise"
                         ) -> Tuple[np.ndarray, np.ndarray]:
        """``(rows int32[N, D], deg int32[N])`` padded with sentinel N.

        ``D`` is rounded up to a multiple of ``lane`` for friendly layouts
        (the engine passes lane=128).
        A ``d_max`` below the real maximum degree raises by default;
        ``on_overflow='clamp'`` truncates with a RuntimeWarning instead.
        """
        rows = pad_rows(self.adj, self.n, d_max=d_max, lane=lane,
                        on_overflow=on_overflow)
        return rows, self.deg.astype(np.int32)


class DiGraph:
    """Static directed simple graph (S-BENU snapshots)."""

    def __init__(self, n: int):
        self.n = n
        self.out: List[set] = [set() for _ in range(n)]
        self.inn: List[set] = [set() for _ in range(n)]

    @staticmethod
    def from_edges(n: int, edges: Iterable[Edge]) -> "DiGraph":
        g = DiGraph(n)
        for a, b in edges:
            g.add_edge(a, b)
        return g

    def add_edge(self, a: int, b: int) -> None:
        if a == b:
            return
        self.out[a].add(b)
        self.inn[b].add(a)

    def remove_edge(self, a: int, b: int) -> None:
        self.out[a].discard(b)
        self.inn[b].discard(a)

    def has_edge(self, a: int, b: int) -> bool:
        return b in self.out[a]

    def copy(self) -> "DiGraph":
        g = DiGraph(self.n)
        g.out = [set(s) for s in self.out]
        g.inn = [set(s) for s in self.inn]
        return g

    @property
    def m(self) -> int:
        return sum(len(s) for s in self.out)

    def edges(self) -> Iterable[Edge]:
        for v in range(self.n):
            for w in sorted(self.out[v]):
                yield (v, w)

    def stats(self) -> GraphStats:
        return GraphStats(n_vertices=self.n, n_edges=self.m)

    # ---------------------------------------------------------- dense layout
    def padded_adjacency(self, direction: str = "out",
                         d_max: Optional[int] = None, lane: int = 8,
                         on_overflow: str = "raise") -> np.ndarray:
        """Sentinel-padded ``int32[N, D]`` rows of one adjacency direction."""
        sets = self.out if direction == "out" else self.inn
        adj = [np.array(sorted(s), dtype=np.int64) for s in sets]
        return pad_rows(adj, self.n, d_max=d_max, lane=lane,
                        on_overflow=on_overflow)
