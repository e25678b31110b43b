"""VCBC (vertex-cover based compression) support (paper §4.2.4).

Given a plan whose matching order's first ``k`` vertices form a vertex cover
V_c of P (and first k-1 do not), the matches of the first k vertices are the
*helves*; each non-core vertex u_j contributes its *conditional image set*
C_j. The plan is modified to delete non-core ENU instructions and report
``(helve, image sets)`` compressed codes directly.

``expand_code`` reconstructs exact match tuples from a code — used to verify
compressed counting against uncompressed enumeration. Expansion enforces the
residual constraints the plan dropped: injectivity and symmetry-order
constraints *between non-core vertices* (non-core vertices are pairwise
non-adjacent because V_c is a vertex cover, so the plan never checked these).
"""

from __future__ import annotations

import itertools
from dataclasses import replace
from typing import Dict, Iterable, List, Sequence, Tuple

from .instructions import DBQ, ENU, INT, RES, Instr, Plan, Var
from .pattern import Pattern


def compress_plan(plan: Plan, pattern: Pattern, core_k: int) -> None:
    """Modify ``plan`` in place to emit VCBC-compressed codes."""
    order = plan.matching_order
    core = set(order[:core_k])
    noncore = [u for u in order[core_k:]]
    noncore_f: set = {("f", u) for u in noncore}

    out: List[Instr] = []
    for ins in plan.instrs:
        if ins.op == ENU and ins.target in noncore_f:
            continue                       # delete non-core enumeration
        if ins.op == DBQ and ins.operands[0] in noncore_f:
            continue  # cannot happen for a true cover; defensive
        if ins.filters:
            flt = tuple((op, v) for op, v in ins.filters
                        if v not in noncore_f)
            ins = replace(ins, filters=flt)
        if ins.op == RES:
            rep = tuple(("C", v[1]) if v in noncore_f else v
                        for v in ins.report)
            ins = replace(ins, report=rep)
        out.append(ins)
    plan.instrs[:] = out
    plan.vcbc = True
    plan.core_k = core_k


def residual_constraints(plan: Plan, pattern: Pattern
                         ) -> Tuple[List[Tuple[int, int]], List[Tuple[int, int]]]:
    """(order_constraints, injective_pairs) among non-core vertices."""
    core = set(plan.matching_order[:plan.core_k])
    noncore = [u for u in plan.matching_order[plan.core_k:]]
    order_c = [(a, b) for a, b in plan.constraints
               if a not in core and b not in core]
    inj = [(a, b) for i, a in enumerate(noncore) for b in noncore[i + 1:]]
    return order_c, inj


def expand_code(plan: Plan, pattern: Pattern,
                code: Dict[Var, object]) -> List[Tuple[int, ...]]:
    """Expand one compressed code ``{('f',i): v, ('C',j): iterable}`` into the
    exact list of match tuples (f_1..f_n)."""
    order_c, inj = residual_constraints(plan, pattern)
    noncore = [u for u in plan.matching_order[plan.core_k:]]
    fixed = {u: code[("f", u)] for u in plan.matching_order[:plan.core_k]}
    image_sets = [sorted(code[("C", u)]) for u in noncore]
    out: List[Tuple[int, ...]] = []
    for combo in itertools.product(*image_sets):
        assign = dict(fixed)
        ok = True
        for u, v in zip(noncore, combo):
            assign[u] = v
        for a, b in inj:
            if assign[a] == assign[b]:
                ok = False
                break
        if ok:
            for a, b in order_c:
                if not assign[a] < assign[b]:
                    ok = False
                    break
        if ok:
            out.append(tuple(assign[u] for u in range(pattern.n)))
    return out


def count_code(plan: Plan, pattern: Pattern, code: Dict[Var, object]) -> int:
    """Exact number of matches a compressed code expands to.

    With <= 3 non-core vertices (all the paper's patterns) inclusion-
    exclusion over equal-value collisions is cheap; we expand for full
    generality since image sets are small.
    """
    return len(expand_code(plan, pattern, code))
