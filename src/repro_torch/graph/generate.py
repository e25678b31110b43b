"""Synthetic data-graph generators (deterministic, numpy-only core).

The paper evaluates on SNAP graphs (as-Skitter, LiveJournal, ...) which are
not available offline; we generate Erdős–Rényi and power-law
(Barabási–Albert-style preferential attachment) graphs of configurable size —
the two regimes that matter for BENU (uniform vs heavy-tail degree skew,
which drives the task-splitting experiments).
"""

from __future__ import annotations

from typing import List, Set, Tuple

import numpy as np

from .storage import DiGraph, Graph


def erdos_renyi(n: int, m: int, seed: int = 0,
                canonicalize: bool = True) -> Graph:
    rng = np.random.default_rng(seed)
    edges: Set[Tuple[int, int]] = set()
    while len(edges) < m:
        need = m - len(edges)
        a = rng.integers(0, n, size=2 * need + 8)
        b = rng.integers(0, n, size=2 * need + 8)
        for x, y in zip(a, b):
            if x == y:
                continue
            e = (min(int(x), int(y)), max(int(x), int(y)))
            edges.add(e)
            if len(edges) >= m:
                break
    return Graph.from_edges(n, list(edges), canonicalize=canonicalize)


def powerlaw(n: int, m_per_node: int = 4, seed: int = 0,
             canonicalize: bool = True) -> Graph:
    """Barabási–Albert preferential attachment."""
    rng = np.random.default_rng(seed)
    targets = list(range(m_per_node))
    repeated: List[int] = list(range(m_per_node))
    edges: Set[Tuple[int, int]] = set()
    for v in range(m_per_node, n):
        for t in targets:
            e = (min(v, t), max(v, t))
            edges.add(e)
            repeated.extend([v, t])
        targets = [int(repeated[i])
                   for i in rng.integers(0, len(repeated), size=m_per_node)]
        targets = list(dict.fromkeys(targets))[:m_per_node]
        while len(targets) < m_per_node:
            t = int(rng.integers(0, v))
            if t not in targets:
                targets.append(t)
    return Graph.from_edges(n, list(edges), canonicalize=canonicalize)


def random_digraph(n: int, m: int, seed: int = 0) -> DiGraph:
    rng = np.random.default_rng(seed)
    g = DiGraph(n)
    added = 0
    while added < m:
        a = int(rng.integers(0, n))
        b = int(rng.integers(0, n))
        if a != b and not g.has_edge(a, b):
            g.add_edge(a, b)
            added += 1
    return g


def edge_stream(n: int, m_init: int, steps: int, batch: int, seed: int = 0,
                delete_frac: float = 0.3):
    """A dynamic directed graph: initial DiGraph + per-step batch updates.

    Returns ``(g0, [batch_1, ..., batch_steps])`` where each batch is a list
    of ``(op, src, dst)`` with op in {'+', '-'}, each edge appearing at most
    once per batch (paper's assumption).
    """
    rng = np.random.default_rng(seed)
    g0 = random_digraph(n, m_init, seed=seed)
    cur = g0.copy()
    batches = []
    for _ in range(steps):
        ops = []
        touched = set()
        existing = list(cur.edges())
        n_del = min(int(batch * delete_frac), max(len(existing) - 1, 0))
        if n_del and existing:
            idx = rng.choice(len(existing), size=n_del, replace=False)
            for i in idx:
                a, b = existing[int(i)]
                if (a, b) in touched:
                    continue
                ops.append(("-", a, b))
                touched.add((a, b))
        while len(ops) < batch:
            a = int(rng.integers(0, n))
            b = int(rng.integers(0, n))
            if a == b or cur.has_edge(a, b) or (a, b) in touched:
                continue
            ops.append(("+", a, b))
            touched.add((a, b))
        for op, a, b in ops:     # advance the generator's view
            if op == "+":
                cur.add_edge(a, b)
            else:
                cur.remove_edge(a, b)
        batches.append(ops)
    return g0, batches


def toy_graph_fig1() -> Graph:
    """A small graph akin to Fig. 1(b) for doc examples/tests (8 vertices)."""
    edges = [(0, 1), (0, 2), (0, 3), (0, 4), (0, 6), (0, 7), (1, 2), (2, 3),
             (3, 4), (4, 7), (1, 6), (2, 6), (4, 5), (5, 7)]
    return Graph.from_edges(8, edges, canonicalize=False)
