"""Symmetry breaking (paper §2.2).

Implements the Grochow–Kellis technique [22]: impose a partial order ``<`` on
V(P) such that every subgraph of G isomorphic to P admits exactly one match
respecting ``f(u_i) < f(u_j)`` under the total order on V(G).

The classic construction: repeatedly pick the largest automorphism orbit,
anchor its minimum vertex ``u`` with conditions ``u < w`` for every other
orbit member ``w``, then restrict the automorphism group to the stabilizer of
``u``; stop when the group is trivial.
"""

from __future__ import annotations

from typing import List, Set, Tuple

from .pattern import Pattern

Constraint = Tuple[int, int]  # (a, b) means f(u_a) < f(u_b)


def orbits(perms: List[Tuple[int, ...]], n: int) -> List[Set[int]]:
    """Vertex orbits under a set of permutations (union-find)."""
    parent = list(range(n))

    def find(x: int) -> int:
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for p in perms:
        for v in range(n):
            a, b = find(v), find(p[v])
            if a != b:
                parent[a] = b
    groups = {}
    for v in range(n):
        groups.setdefault(find(v), set()).add(v)
    return list(groups.values())


def symmetry_breaking_constraints(pattern: Pattern) -> List[Constraint]:
    """Partial-order constraints ``(a, b)`` meaning ``f(u_a) < f(u_b)``."""
    perms = list(pattern.automorphisms)
    constraints: List[Constraint] = []
    while len(perms) > 1:
        obs = [o for o in orbits(perms, pattern.n) if len(o) > 1]
        if not obs:  # non-trivial perms but trivial orbits cannot happen
            break
        # largest orbit; ties -> containing the smallest vertex id
        orbit = max(obs, key=lambda o: (len(o), -min(o)))
        anchor = min(orbit)
        for w in sorted(orbit):
            if w != anchor:
                constraints.append((anchor, w))
        perms = [p for p in perms if p[anchor] == anchor]
    return constraints


def check_unique_representative(pattern: Pattern,
                                constraints: List[Constraint]) -> bool:
    """Verify the defining property: for every automorphism image of the
    identity labeling, exactly one permutation of each automorphism class of
    labelings satisfies the constraints.

    Concretely: among ``{perm : perm in Aut(P)}`` applied to any injective
    labeling, exactly one ordering survives. We check on the canonical
    labeling ``u_i -> i``: matches of P onto itself are automorphisms, and
    exactly one automorphism image must satisfy all constraints.
    """
    ok = 0
    for p in pattern.automorphisms:
        # labeling v -> p[v]; constraint (a, b): p[a] < p[b]
        if all(p[a] < p[b] for a, b in constraints):
            ok += 1
    return ok == 1
