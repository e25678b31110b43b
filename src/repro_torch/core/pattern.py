"""Pattern graphs for (continuous) subgraph enumeration.

A :class:`Pattern` is a small, connected, simple graph. Undirected patterns
drive BENU; directed patterns drive S-BENU (edges carry a fixed numbering so
incremental pattern graphs are well defined).

Vertices are 0-based ints ``0..n-1`` (the paper uses 1-based ``u_1..u_n``).
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from functools import cached_property
from typing import Dict, FrozenSet, List, Sequence, Tuple

Edge = Tuple[int, int]


def _norm_undirected(e: Edge) -> Edge:
    a, b = e
    if a == b:
        raise ValueError(f"self loop {e} not allowed in a simple pattern")
    return (a, b) if a < b else (b, a)


@dataclass(frozen=True)
class Pattern:
    """A connected simple pattern graph.

    Parameters
    ----------
    n : number of vertices.
    edges : edge list. For undirected patterns the stored form is normalized
        to ``a < b``; for directed patterns the pair order is meaningful and
        the *position* in the tuple is the paper's edge id (1-based id = pos+1).
    directed : S-BENU patterns are directed; BENU patterns are undirected.
    name : optional label (q1..q9, q1'..q5', ...).
    """

    n: int
    edges: Tuple[Edge, ...]
    directed: bool = False
    name: str = ""

    def __post_init__(self):
        if self.n < 2:
            raise ValueError("pattern needs >= 2 vertices")
        es = list(self.edges)
        if not self.directed:
            es = [_norm_undirected(e) for e in es]
        seen = set()
        for e in es:
            if e in seen:
                raise ValueError(f"duplicate edge {e}")
            if self.directed and (e[0] == e[1]):
                raise ValueError(f"self loop {e}")
            seen.add(e)
            for v in e:
                if not (0 <= v < self.n):
                    raise ValueError(f"vertex {v} out of range 0..{self.n-1}")
        object.__setattr__(self, "edges", tuple(es))
        if not self.is_connected():
            raise ValueError(f"pattern {self.name or es} must be connected")

    # ------------------------------------------------------------------ basic
    @property
    def m(self) -> int:
        return len(self.edges)

    @cached_property
    def undirected_edges(self) -> Tuple[Edge, ...]:
        """Edge set viewed undirected (dedup of anti-parallel pairs)."""
        return tuple(sorted({_norm_undirected(e) for e in self.edges}))

    @cached_property
    def adj(self) -> Tuple[FrozenSet[int], ...]:
        """Undirected adjacency (union of in/out for directed patterns)."""
        nbr: List[set] = [set() for _ in range(self.n)]
        for a, b in self.edges:
            nbr[a].add(b)
            nbr[b].add(a)
        return tuple(frozenset(s) for s in nbr)

    @cached_property
    def adj_out(self) -> Tuple[FrozenSet[int], ...]:
        nbr: List[set] = [set() for _ in range(self.n)]
        for a, b in self.edges:
            nbr[a].add(b)
        return tuple(frozenset(s) for s in nbr)

    @cached_property
    def adj_in(self) -> Tuple[FrozenSet[int], ...]:
        nbr: List[set] = [set() for _ in range(self.n)]
        for a, b in self.edges:
            nbr[b].add(a)
        return tuple(frozenset(s) for s in nbr)

    def degree(self, v: int) -> int:
        return len(self.adj[v])

    def is_connected(self) -> bool:
        seen = {0}
        stack = [0]
        nbr: List[set] = [set() for _ in range(self.n)]
        for a, b in self.edges:
            nbr[a].add(b)
            nbr[b].add(a)
        while stack:
            v = stack.pop()
            for w in nbr[v]:
                if w not in seen:
                    seen.add(w)
                    stack.append(w)
        return len(seen) == self.n

    def has_edge(self, a: int, b: int) -> bool:
        if self.directed:
            return (a, b) in self._edge_set
        return _norm_undirected((a, b)) in self._edge_set

    @cached_property
    def _edge_set(self) -> FrozenSet[Edge]:
        return frozenset(self.edges)

    # -------------------------------------------------------------- morphisms
    @cached_property
    def automorphisms(self) -> Tuple[Tuple[int, ...], ...]:
        """All automorphisms as permutation tuples ``perm[u] = image of u``.

        Brute-force backtracking with degree pruning — patterns are tiny
        (n <= 10 in the paper's experiments).
        """
        deg = [self.degree(v) for v in range(self.n)]
        # group vertices by degree for candidate pruning
        out: List[Tuple[int, ...]] = []
        perm = [-1] * self.n
        used = [False] * self.n

        if self.directed:
            indeg = [len(self.adj_in[v]) for v in range(self.n)]
            outdeg = [len(self.adj_out[v]) for v in range(self.n)]

        def ok(u: int, img: int) -> bool:
            if deg[u] != deg[img]:
                return False
            if self.directed and (
                len(self.adj_in[u]) != len(self.adj_in[img])
                or len(self.adj_out[u]) != len(self.adj_out[img])
            ):
                return False
            # check edges to already-mapped vertices
            for w in range(self.n):
                if perm[w] < 0 or w == u:
                    continue
                if self.directed:
                    if ((u, w) in self._edge_set) != ((img, perm[w]) in self._edge_set):
                        return False
                    if ((w, u) in self._edge_set) != ((perm[w], img) in self._edge_set):
                        return False
                else:
                    if self.has_edge(u, w) != self.has_edge(img, perm[w]):
                        return False
            return True

        def rec(u: int):
            if u == self.n:
                out.append(tuple(perm))
                return
            for img in range(self.n):
                if used[img] or not ok(u, img):
                    continue
                perm[u] = img
                used[img] = True
                rec(u + 1)
                perm[u] = -1
                used[img] = False

        rec(0)
        return tuple(out)

    # ------------------------------------------------ syntactic equivalence
    def syntactic_equivalent(self, a: int, b: int) -> bool:
        """``u_a ~= u_b`` iff Gamma(a) - {b} == Gamma(b) - {a} (paper 4.3.2)."""
        if self.directed:
            raise ValueError("use IncrementalPattern.syntactic_equivalent")
        return (self.adj[a] - {b}) == (self.adj[b] - {a})

    def se_pairs(self) -> List[Tuple[int, int]]:
        return [
            (a, b)
            for a in range(self.n)
            for b in range(a + 1, self.n)
            if self.syntactic_equivalent(a, b)
        ]

    # ----------------------------------------------------------------- misc
    def induced(self, vertices: Sequence[int]) -> "Pattern":
        vs = list(vertices)
        remap = {v: i for i, v in enumerate(vs)}
        es = [
            (remap[a], remap[b])
            for a, b in self.edges
            if a in remap and b in remap
        ]
        return Pattern(len(vs), tuple(es), directed=self.directed,
                       name=f"{self.name}[{vs}]")

    def is_vertex_cover(self, vs: Sequence[int]) -> bool:
        s = set(vs)
        return all(a in s or b in s for a, b in self.undirected_edges)

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        kind = "DiPattern" if self.directed else "Pattern"
        return f"{kind}({self.name or ''} n={self.n} edges={list(self.edges)})"


# ---------------------------------------------------------------------------
# Pattern library.
#
# Fig. 8 of the paper is an image (not machine-readable in our source). q1-q5
# follow the CBF paper (Qiao et al., PVLDB'17) which the authors cite as the
# origin of q1..q5; q6-q9 are "hard" patterns sharing a chordal-square core as
# the text describes. The Fig.1 running-example pattern is reconstructed
# exactly from the textual clues (fan F5: hub u1 + path u2-u3-u4-u5-u6;
# automorphism (u2 u6)(u3 u5); symmetry constraint u3 < u5; CSE finds
# {A1,A3} and {A1,A5} for order u1,u3,u5,u2,u6,u4).
# ---------------------------------------------------------------------------


def _p(n: int, edges: Sequence[Edge], name: str) -> Pattern:
    return Pattern(n, tuple(edges), directed=False, name=name)


TRIANGLE = _p(3, [(0, 1), (1, 2), (0, 2)], "triangle")
SQUARE = _p(4, [(0, 1), (1, 2), (2, 3), (0, 3)], "square")  # 4-cycle
CHORDAL_SQUARE = _p(4, [(0, 1), (1, 2), (2, 3), (0, 3), (0, 2)], "chordal-square")
CLIQUE4 = _p(4, list(itertools.combinations(range(4), 2)), "clique4")
CLIQUE5 = _p(5, list(itertools.combinations(range(5), 2)), "clique5")
PATH5 = _p(5, [(0, 1), (1, 2), (2, 3), (3, 4)], "path5")       # 5-path
CYCLE5 = _p(5, [(0, 1), (1, 2), (2, 3), (3, 4), (0, 4)], "cycle5")  # 5-cycle
HOUSE = _p(5, [(0, 1), (1, 2), (2, 3), (3, 4), (0, 4), (0, 1), ][:5] + [], "house")
# house = square + roof triangle
HOUSE = _p(5, [(0, 1), (1, 2), (2, 3), (0, 3), (0, 4), (1, 4)], "house")
# fan F5 = running example of Fig.1 (hub 0, path 1-2-3-4-5)
FAN5 = _p(
    6,
    [(0, 1), (0, 2), (0, 3), (0, 4), (0, 5), (1, 2), (2, 3), (3, 4), (4, 5)],
    "fan5",
)

# Benchmark pattern set (paper Fig. 8). q1..q5 from CBF; q6..q9 hard patterns
# around a chordal-square core.
Q1 = _p(4, SQUARE.edges, "q1")
Q2 = _p(4, CHORDAL_SQUARE.edges, "q2")
Q3 = _p(4, CLIQUE4.edges, "q3")
Q4 = _p(5, HOUSE.edges, "q4")
Q5 = _p(5, CLIQUE5.edges, "q5")
# q6: chordal square + pendant path ("tailed diamond")
Q6 = _p(5, list(CHORDAL_SQUARE.edges) + [(3, 4)], "q6")
# q7: chordal square core + a vertex adjacent to two opposite core vertices
Q7 = _p(5, list(CHORDAL_SQUARE.edges) + [(1, 4), (3, 4)], "q7")
# q8: chordal square core + triangle hanging off the chord
Q8 = _p(6, list(CHORDAL_SQUARE.edges) + [(0, 4), (2, 4), (0, 5), (4, 5)], "q8")
# q9: two chordal squares sharing the chord
Q9 = _p(6, list(CHORDAL_SQUARE.edges) + [(0, 4), (2, 4), (0, 5), (2, 5)], "q9")

UNDIRECTED_PATTERNS: Dict[str, Pattern] = {
    p.name: p
    for p in [
        TRIANGLE, SQUARE, CHORDAL_SQUARE, CLIQUE4, CLIQUE5, PATH5, CYCLE5,
        HOUSE, FAN5, Q1, Q2, Q3, Q4, Q5, Q6, Q7, Q8, Q9,
    ]
}


def _dp(n: int, edges: Sequence[Edge], name: str) -> Pattern:
    return Pattern(n, tuple(edges), directed=True, name=name)


# S-BENU patterns q1'..q5' follow BiGJoin's dynamic queries (directed cycles /
# small DAG motifs).
DQ1 = _dp(3, [(0, 1), (1, 2), (2, 0)], "q1'")  # directed triangle cycle
DQ2 = _dp(4, [(0, 1), (1, 2), (2, 3), (3, 0)], "q2'")  # directed 4-cycle
DQ3 = _dp(4, [(0, 1), (1, 2), (2, 0), (0, 3), (3, 1)], "q3'")  # tri + 2-path chord
DQ4 = _dp(5, [(0, 1), (1, 2), (2, 0), (0, 3), (3, 4), (4, 0)], "q4'")  # two cycles
DQ5 = _dp(4, [(0, 1), (0, 2), (0, 3), (1, 2), (2, 3), (1, 3)], "q5'")  # DAG K4
# Fig.5 running example of the dynamic section: directed triangle u1->u3,
# u3->u2 ... the paper's DeltaP_2 demo uses edges e1=(u1,u2), e2=(u1,u3),
# e3=(u2,u3) with O_2: u1,u3,u2.
DTOY = _dp(3, [(0, 1), (0, 2), (1, 2)], "dtoy")

DIRECTED_PATTERNS: Dict[str, Pattern] = {
    p.name: p for p in [DQ1, DQ2, DQ3, DQ4, DQ5, DTOY]
}


def get_pattern(name: str) -> Pattern:
    if name in UNDIRECTED_PATTERNS:
        return UNDIRECTED_PATTERNS[name]
    if name in DIRECTED_PATTERNS:
        return DIRECTED_PATTERNS[name]
    raise KeyError(f"unknown pattern {name!r}; have "
                   f"{sorted(UNDIRECTED_PATTERNS) + sorted(DIRECTED_PATTERNS)}")
