"""The frozen graph generator: seeded, simple, degree-ranked, and the
GAP suite's uniform random graph at small sizes."""

import numpy as np
import pytest

from bench.graphgen import canonical_csr, make_graph, uniform_edges


def spec(scale, structure_seed=1):
    return {"graph_model": "uniform_random", "scale": scale, "degree": 16,
            "structure_seed": structure_seed}


def test_same_seed_same_graph():
    a, b = make_graph(spec(11), 2**33 + 5), make_graph(spec(11), 2**33 + 5)
    assert np.array_equal(a.indptr, b.indptr)
    assert np.array_equal(a.col, b.col)


def test_seed_orders_one_graph():
    """Another run seed: the same edges in another vertex order (equal
    degrees, other ties), so one amount of work a cell."""
    a, b = make_graph(spec(11), 1), make_graph(spec(11), 2)
    assert np.array_equal(a.deg, b.deg)
    assert not np.array_equal(a.col, b.col)
    other = make_graph(spec(11, structure_seed=2), 1)
    assert not np.array_equal(a.deg, other.deg)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_simple_sorted_and_ranked(seed):
    g = make_graph(spec(10, seed), seed + 10)
    row = np.repeat(np.arange(g.n), g.deg)
    assert (g.col != row).all()                          # no loop
    key = row * g.n + g.col
    assert (np.diff(key) > 0).all()                      # sorted, no repeat
    back = np.sort(g.col * g.n + row)
    assert np.array_equal(back, key)                     # symmetric
    assert (np.diff(g.deg) >= 0).all()                   # ids rank degree


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_uniform_degrees(seed):
    """``degree`` edges a vertex less the few loops and repeats the
    builder removes, and degrees binomial about twice that: GAP's Urand
    (2^31 edges on 2^27 vertices)."""
    n, k = 1 << 13, 16
    e = uniform_edges(n, k, seed).numpy()
    assert 0.99 * k * n <= e.shape[0] <= k * n
    deg = np.bincount(e.ravel(), minlength=n)
    assert abs(deg.mean() - 2 * k) < 0.1
    assert 0.9 <= deg.std() / np.sqrt(2 * k) <= 1.1
    assert deg.max() <= 2 * k + 8 * np.sqrt(2 * k)


def test_canonical_ties_follow_the_seed():
    edges = np.array([[0, 1], [2, 3]])
    orders = {tuple(canonical_csr(4, edges, s).col) for s in range(8)}
    assert len(orders) > 1
