"""The plain reference against brute force on small graphs."""

import itertools

import numpy as np
import pytest

from bench.graphgen import Csr, canonical_csr, uniform_edges
from bench.reference.counts import count

SQUARE = [(0, 1), (1, 2), (2, 3), (0, 3)]


def brute(csr, starts=None):
    """Distinct edge sets of the injective maps of the square, charged to
    their lowest vertex."""
    adj = [set(csr.col[csr.indptr[v]:csr.indptr[v + 1]].tolist())
           for v in range(csr.n)]
    copies = set()
    for t in itertools.permutations(range(csr.n), 4):
        if all(t[j] in adj[t[i]] for i, j in SQUARE):
            if starts is None or starts[min(t)]:
                copies.add(frozenset(frozenset((t[i], t[j]))
                                     for i, j in SQUARE))
    return len(copies)


def small(n, degree, seed):
    return canonical_csr(n, uniform_edges(n, degree, seed), seed)


@pytest.mark.parametrize("seed", range(4))
def test_against_brute_force(seed):
    csr = small(28, 4, seed)
    assert count("q1", csr) == brute(csr)


def test_k4():
    k4 = canonical_csr(4, np.asarray(list(itertools.combinations(range(4),
                                                                 2))), 0)
    assert count("q1", k4) == 3


def test_starts_split_the_count():
    csr = small(40, 4, 3)
    half = np.random.default_rng(0).random(csr.n) < 0.5
    a = count("q1", csr, starts=half)
    b = count("q1", csr, starts=~half)
    assert a + b == count("q1", csr)
    assert a == brute(csr, starts=half)


def test_blocks_do_not_change_the_count():
    from bench.reference import counts
    csr = small(500, 8, 1)
    assert counts.four_cycles(csr, block=64) == counts.four_cycles(csr)


def test_empty_graph():
    empty = Csr(n=5, indptr=np.zeros(6, np.int64), col=np.zeros(0, np.int64))
    assert count("q1", empty) == 0


def test_unknown_pattern_is_named():
    with pytest.raises(KeyError, match="q3"):
        count("q3", small(10, 2, 0))
