"""BENU execution-plan generation (paper §4).

Pipeline::

    matching order O
      -> raw plan                      (§4.1)
      -> Opt1 common-subexpr elim      (§4.2.1)
      -> Opt2 instruction reordering   (§4.2.2)
      -> Opt3 triangle caching         (§4.2.3)
      -> (optional) VCBC compression   (§4.2.4)

and the best-plan search (Alg. 3) with dual pruning + cost-based pruning.
"""

from __future__ import annotations

import heapq
import itertools
import time
from dataclasses import replace
from typing import Dict, FrozenSet, List, Optional, Sequence, Set, Tuple

from .estimate import DEFAULT_STATS, GraphStats, PartialPatternTracker
from .instructions import (DBQ, ENU, INI, INT, RES, TRC, TYPE_RANK, VG, Instr,
                           Plan, Var, substitute)
from .pattern import Pattern
from .symmetry import symmetry_breaking_constraints

# --------------------------------------------------------------------------
# Raw plan generation (§4.1)
# --------------------------------------------------------------------------


def generate_raw_plan(pattern: Pattern,
                      order: Sequence[int],
                      constraints: Optional[Sequence[Tuple[int, int]]] = None,
                      keep: FrozenSet[Var] = frozenset(),
                      eliminate: bool = True) -> Plan:
    """Generate the raw execution plan for matching order ``order``.

    ``constraints`` are symmetry-breaking pairs (a, b) == f_a < f_b; computed
    from the pattern when omitted. ``keep`` marks target vars protected from
    uni-operand elimination (VCBC outputs).
    """
    if sorted(order) != list(range(pattern.n)):
        raise ValueError(f"order {order} is not a permutation of V(P)")
    if constraints is None:
        constraints = symmetry_breaking_constraints(pattern)
    cons = set(map(tuple, constraints))
    pos = {u: i for i, u in enumerate(order)}
    k1 = order[0]

    instrs: List[Instr] = [Instr(INI, ("f", k1))]
    if any(pos[w] > 0 for w in pattern.adj[k1]):
        instrs.append(Instr(DBQ, ("A", k1), operands=(("f", k1),)))

    for i in range(1, pattern.n):
        u = order[i]
        preds = sorted((w for w in pattern.adj[u] if pos[w] < i),
                       key=lambda w: pos[w])
        ops: Tuple[Var, ...] = tuple(("A", w) for w in preds) or (VG,)
        instrs.append(Instr(INT, ("T", u), operands=ops))
        fcs: List[Tuple[str, Var]] = []
        for j in order[:i]:
            if (j, u) in cons:
                fcs.append((">", ("f", j)))      # f_u must be > f_j
            elif (u, j) in cons:
                fcs.append(("<", ("f", j)))
            elif j not in pattern.adj[u]:
                fcs.append(("!=", ("f", j)))      # injectivity (adjacency implies !=)
        instrs.append(Instr(INT, ("C", u), operands=(("T", u),),
                            filters=tuple(fcs)))
        instrs.append(Instr(ENU, ("f", u), operands=(("C", u),)))
        if any(pos[w] > i for w in pattern.adj[u]):
            instrs.append(Instr(DBQ, ("A", u), operands=(("f", u),)))

    instrs.append(Instr(RES, None,
                        report=tuple(("f", u) for u in range(pattern.n))))

    plan = Plan(pattern_name=pattern.name, n=pattern.n,
                matching_order=tuple(order), instrs=instrs,
                constraints=tuple(sorted(cons)))
    if eliminate:
        uni_operand_elimination(plan, keep)
    return plan


def uni_operand_elimination(plan: Plan, keep: FrozenSet[Var] = frozenset()
                            ) -> None:
    """Remove ``X := Intersect(Y)`` with no filters; rename X -> Y (§4.1.2)."""
    changed = True
    while changed:
        changed = False
        for idx, ins in enumerate(plan.instrs):
            if (ins.op == INT and len(ins.operands) == 1 and not ins.filters
                    and ins.target not in keep):
                src = ins.operands[0]
                tgt = ins.target
                del plan.instrs[idx]
                plan.instrs[:] = [substitute(other, tgt, src)
                                  for other in plan.instrs]
                changed = True
                break


# --------------------------------------------------------------------------
# Opt1: common-subexpression elimination (§4.2.1)
# --------------------------------------------------------------------------


def _subexpr_stats(plan: Plan) -> Dict[FrozenSet[Var], Tuple[int, int]]:
    """All operand subsets (|s| >= 2) of INT instructions -> (count, first_idx)."""
    stats: Dict[FrozenSet[Var], Tuple[int, int]] = {}
    for idx, ins in enumerate(plan.instrs):
        if ins.op != INT or len(ins.operands) < 2:
            continue
        opset = list(dict.fromkeys(ins.operands))
        for r in range(2, len(opset) + 1):
            for sub in itertools.combinations(opset, r):
                key = frozenset(sub)
                cnt, first = stats.get(key, (0, idx))
                stats[key] = (cnt + 1, min(first, idx))
    return stats


def _fresh_t_index(plan: Plan) -> int:
    used = {v[1] for ins in plan.instrs
            for v in (ins.target,) + ins.uses() if v and v[0] == "T"}
    used |= set(range(plan.n))
    i = plan.n
    while i in used:
        i += 1
    return i


def common_subexpression_elimination(plan: Plan,
                                     keep: FrozenSet[Var] = frozenset()
                                     ) -> int:
    """Opt1. Returns the number of subexpressions eliminated."""
    eliminated = 0
    while True:
        stats = _subexpr_stats(plan)
        cands = [(len(k), cnt, -first, k)
                 for k, (cnt, first) in stats.items() if cnt >= 2]
        if not cands:
            break
        # most operands, then most frequent, then appearing first
        cands.sort(key=lambda t: (-t[0], -t[1], t[2]))
        size, cnt, negfirst, sub = cands[0]
        first_idx = -negfirst
        tvar: Var = ("T", _fresh_t_index(plan))
        new = Instr(INT, tvar, operands=tuple(
            sorted(sub, key=lambda v: _def_index(plan, v))))
        # rewrite users
        for idx, ins in enumerate(plan.instrs):
            if ins.op == INT and sub <= set(ins.operands):
                ops = tuple(v for v in ins.operands if v not in sub) + (tvar,)
                plan.instrs[idx] = replace(ins, operands=ops)
        plan.instrs.insert(first_idx, new)
        eliminated += 1
    uni_operand_elimination(plan, keep)
    return eliminated


def _def_index(plan: Plan, v: Var) -> int:
    if v[0] == "VG":
        return -1
    for idx, ins in enumerate(plan.instrs):
        if ins.target == v:
            return idx
    return -1  # undefined (e.g. being inserted) sorts first


# --------------------------------------------------------------------------
# Opt2: instruction reordering (§4.2.2)
# --------------------------------------------------------------------------


def flatten_intersections(plan: Plan) -> None:
    """Flatten INT instructions with > 2 operands into binary chains."""
    out: List[Instr] = []
    for ins in plan.instrs:
        if ins.op == INT and len(ins.operands) > 2:
            ops = sorted(ins.operands, key=lambda v: _def_index(plan, v))
            acc = ops[0]
            for j, nxt in enumerate(ops[1:]):
                last = j == len(ops) - 2
                if last:
                    out.append(replace(ins, operands=(acc, nxt)))
                else:
                    tv: Var = ("T", _fresh_t_index_from(out, plan))
                    out.append(Instr(INT, tv, operands=(acc, nxt)))
                    acc = tv
        else:
            out.append(ins)
    plan.instrs[:] = out


def _fresh_t_index_from(extra: List[Instr], plan: Plan) -> int:
    used = {v[1] for ins in list(plan.instrs) + extra
            for v in (ins.target,) + ins.uses() if v and v[0] == "T"}
    used |= set(range(plan.n))
    i = plan.n
    while i in used:
        i += 1
    return i


def reorder_instructions(plan: Plan) -> None:
    """Opt2: dependency-graph topological sort with type ranking.

    Rank: INI < INT < TRC/INS < DBQ < ENU < RES; ties -> original position
    (the paper: "the instruction in the front ranks higher").
    """
    flatten_intersections(plan)
    n = len(plan.instrs)
    defs: Dict[Var, int] = {}
    for idx, ins in enumerate(plan.instrs):
        if ins.target is not None:
            defs[ins.target] = idx
        if ins.op == "DENU":          # Delta-ENU binds the snapshot selector
            defs[("op", -1)] = idx
    preds: List[Set[int]] = [set() for _ in range(n)]
    succs: List[Set[int]] = [set() for _ in range(n)]
    for idx, ins in enumerate(plan.instrs):
        for v in ins.uses():
            if v in defs and defs[v] != idx:
                preds[idx].add(defs[v])
                succs[defs[v]].add(idx)
        # RES depends on everything that defines a reported var (covered by
        # uses()); additionally keep RES last by rank.
    indeg = [len(p) for p in preds]
    heap = [(TYPE_RANK[plan.instrs[i].op], i)
            for i in range(n) if indeg[i] == 0]
    heapq.heapify(heap)
    order: List[int] = []
    while heap:
        _, i = heapq.heappop(heap)
        order.append(i)
        for j in succs[i]:
            indeg[j] -= 1
            if indeg[j] == 0:
                heapq.heappush(heap, (TYPE_RANK[plan.instrs[j].op], j))
    if len(order) != n:
        raise RuntimeError("cycle in instruction dependency graph")
    plan.instrs[:] = [plan.instrs[i] for i in order]


# --------------------------------------------------------------------------
# Opt3: triangle caching (§4.2.3)
# --------------------------------------------------------------------------


def apply_triangle_cache(plan: Plan, pattern: Pattern) -> int:
    """Replace ``X := Intersect(A_k1, A_j)`` by a TCache instruction when u_j
    is a pattern-neighbor of the start vertex u_k1. Returns #replaced."""
    k1 = plan.matching_order[0]
    count = 0
    for idx, ins in enumerate(plan.instrs):
        if ins.op != INT or len(ins.operands) != 2:
            continue
        a, b = ins.operands
        if a[0] != "A" or b[0] != "A":
            continue
        i, j = a[1], b[1]
        if i == k1 and j in pattern.adj[k1] or j == k1 and i in pattern.adj[k1]:
            plan.instrs[idx] = replace(
                ins, op=TRC,
                operands=(("f", i), ("f", j), ("A", i), ("A", j)))
            count += 1
    return count


# --------------------------------------------------------------------------
# Optimized plan assembly
# --------------------------------------------------------------------------


def generate_optimized_plan(pattern: Pattern,
                            order: Sequence[int],
                            constraints: Optional[Sequence[Tuple[int, int]]]
                            = None,
                            use_cse: bool = True,
                            use_reorder: bool = True,
                            use_trc: bool = True,
                            vcbc: bool = False) -> Plan:
    keep: FrozenSet[Var] = frozenset()
    core_k = 0
    if vcbc:
        core_k = _vcbc_core_k(pattern, order)
        keep = frozenset(("C", u) for u in order[core_k:])
    plan = generate_raw_plan(pattern, order, constraints, keep=keep)
    if use_cse:
        common_subexpression_elimination(plan, keep)
    if use_reorder:
        reorder_instructions(plan)
    if use_trc:
        apply_triangle_cache(plan, pattern)
    if vcbc:
        from .vcbc import compress_plan  # local import to avoid cycle
        compress_plan(plan, pattern, core_k)
        if use_reorder:
            reorder_instructions(plan)
    return plan


def _vcbc_core_k(pattern: Pattern, order: Sequence[int]) -> int:
    for k in range(1, pattern.n + 1):
        if pattern.is_vertex_cover(order[:k]):
            return k
    return pattern.n


# --------------------------------------------------------------------------
# Cost estimation over a plan (paper Alg. 3 ESTIMATECOMPUTATIONCOST)
# --------------------------------------------------------------------------


def estimate_computation_cost(pattern: Pattern, plan: Plan,
                              stats: GraphStats = DEFAULT_STATS) -> float:
    """#executions of INT/TRC instructions under the cardinality model.

    Deviation from the paper's pseudo-code (documented): INI also updates the
    partial pattern, so instructions hoisted before the first ENU are costed
    once-per-task (|V(G)| times) instead of zero — the pseudo-code initializes
    curNum to 0 which under-counts hoisted instructions; semantics in §4.3.1
    ("instructions between the i-th and i+1-th ENU execute as often as the
    i-th ENU") imply our reading.
    """
    tracker = PartialPatternTracker(pattern, stats, plan.delta_edge)
    cur = 0.0
    cost = 0.0
    for ins in plan.instrs:
        if ins.op in (INI, ENU, "DENU"):
            tracker.add_vertex(ins.target[1])
            cur = tracker.estimate()
        elif ins.op in (INT, TRC, "INS"):
            cost += cur
    return cost


def estimate_communication_cost(pattern: Pattern, plan: Plan,
                                stats: GraphStats = DEFAULT_STATS) -> float:
    """#executions of DBQ instructions under the cardinality model."""
    tracker = PartialPatternTracker(pattern, stats, plan.delta_edge)
    cur = 0.0
    cost = 0.0
    for ins in plan.instrs:
        if ins.op in (INI, ENU, "DENU"):
            tracker.add_vertex(ins.target[1])
            cur = tracker.estimate()
        elif ins.op == DBQ:
            cost += cur
    return cost


# --------------------------------------------------------------------------
# Best execution plan search (paper Alg. 3)
# --------------------------------------------------------------------------


def _se_classes(pattern: Pattern) -> List[List[int]]:
    cls: List[List[int]] = []
    assigned = [False] * pattern.n
    for a in range(pattern.n):
        if assigned[a]:
            continue
        group = [a]
        assigned[a] = True
        for b in range(a + 1, pattern.n):
            if not assigned[b] and pattern.syntactic_equivalent(a, b):
                group.append(b)
                assigned[b] = True
        cls.append(group)
    return cls


class SearchResult:
    def __init__(self):
        self.best_comm = float("inf")
        self.candidates: List[Tuple[int, ...]] = []
        self.orders_explored = 0
        self.orders_total = 0


def search_matching_orders(pattern: Pattern,
                           stats: GraphStats = DEFAULT_STATS,
                           fixed_prefix: Tuple[int, ...] = (),
                           delta_edge: int = 0,
                           max_candidates: int = 256,
                           se_classes: Optional[List[List[int]]] = None
                           ) -> SearchResult:
    """SEARCH procedure of Alg. 3: candidate orders minimizing comm cost.

    ``fixed_prefix`` pins the first vertices (S-BENU pins (u_si, u_ti)).
    ``delta_edge`` feeds the S-BENU delta-aware cardinality model.
    ``se_classes`` overrides the syntactic-equivalence classes used for dual
    pruning (S-BENU's stricter typed/directed condition, paper §5.4).
    """
    if se_classes is not None:
        se = se_classes
    else:
        se = _se_classes(pattern) if not pattern.directed else None
    # for dual pruning: smaller-id SE sibling must be placed first
    se_pred: Dict[int, List[int]] = {v: [] for v in range(pattern.n)}
    if se is not None:
        for group in se:
            for i, v in enumerate(group[1:], start=1):
                se_pred[v] = group[:i]

    res = SearchResult()
    import math
    res.orders_total = math.factorial(pattern.n - len(fixed_prefix))

    def has_later_neighbor(u: int, placed: Set[int]) -> bool:
        return any(w not in placed and w != u for w in pattern.adj[u])

    def search(order: List[int], remaining: Set[int],
               tracker: PartialPatternTracker, comm: float) -> None:
        if not remaining:
            res.orders_explored += 1
            if comm < res.best_comm - 1e-12:
                res.best_comm = comm
                res.candidates = [tuple(order)]
            elif abs(comm - res.best_comm) <= 1e-12 * max(1.0, comm):
                if len(res.candidates) < max_candidates:
                    res.candidates.append(tuple(order))
            return
        for u in sorted(remaining):
            if se_pred is not None and any(p in remaining for p in se_pred[u]
                                           if p != u):
                continue  # dual pruning
            t2 = tracker.clone()
            t2.add_vertex(u)
            placed = set(order) | {u}
            if has_later_neighbor(u, placed):
                s = t2.estimate()          # case 1: a DBQ will be generated
            else:
                s = 0.0                    # case 2
            comm2 = comm + s
            if comm2 > res.best_comm * (1 + 1e-12):
                continue                   # cost-based pruning
            order.append(u)
            remaining.discard(u)
            search(order, remaining, t2, comm2)
            order.pop()
            remaining.add(u)

    tracker = PartialPatternTracker(pattern, stats, delta_edge)
    order = list(fixed_prefix)
    comm = 0.0
    for u in fixed_prefix:
        tracker.add_vertex(u)
        placed = set(order[:order.index(u) + 1]) if u in order else set(order)
    # recompute comm contributions of the fixed prefix
    tracker = PartialPatternTracker(pattern, stats, delta_edge)
    comm = 0.0
    for i, u in enumerate(fixed_prefix):
        tracker.add_vertex(u)
        placed = set(fixed_prefix[:i + 1])
        if has_later_neighbor(u, placed):
            comm += tracker.estimate()
    remaining = set(range(pattern.n)) - set(fixed_prefix)
    search(list(fixed_prefix), remaining, tracker, comm)
    return res


def generate_best_plan(pattern: Pattern,
                       stats: GraphStats = DEFAULT_STATS,
                       vcbc: bool = False,
                       use_cse: bool = True,
                       use_reorder: bool = True,
                       use_trc: bool = True) -> Plan:
    """Alg. 3: best plan = min comm cost, ties by min computation cost."""
    sr = search_matching_orders(pattern, stats)
    best_plan: Optional[Plan] = None
    best_cost = float("inf")
    for order in sr.candidates:
        plan = generate_optimized_plan(pattern, order, vcbc=vcbc,
                                       use_cse=use_cse,
                                       use_reorder=use_reorder,
                                       use_trc=use_trc)
        cost = estimate_computation_cost(pattern, plan, stats)
        if cost < best_cost:
            best_cost = cost
            best_plan = plan
    assert best_plan is not None
    return best_plan
