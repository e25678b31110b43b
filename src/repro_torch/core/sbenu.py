"""S-BENU: continuous subgraph enumeration on dynamic directed graphs (§5).

Counterpart of ``repro/core/sbenu.py`` (pure Python, copied; only
:func:`run_timestep`'s engines are the port's).

The continuous problem is reduced to ordinary subgraph enumeration of the
*incremental pattern graphs* ΔP_i (Definition 5): the i-th incremental
pattern fixes edge i of P as a **delta** edge, edges before i as **either**
and edges after i as **unaltered**. Theorems 1-5 guarantee that enumerating
incremental matches of every ΔP_i in the two snapshots G'_t / G'_{t-1}
yields exactly ΔR_t^+ / ΔR_t^- with no duplicates and no omissions.

This module provides

* :class:`IncrementalPattern` — ΔP_i with its edge-type mapping τ_i,
* :func:`generate_sbenu_plan` / :func:`generate_best_sbenu_plans` — the
  incremental execution-plan compiler (§5.3-§5.4): pinned (u_si, u_ti)
  prefix, typed/directed DBQ, Delta-ENU, INS back-edge tests, useless-DBQ
  removal, CSE + reordering (no triangle cache, per the paper),
* :class:`SBenuRefEngine` — the per-task interpreter over a
  :class:`~repro_torch.graph.dynamic.SnapshotStore`,
* :func:`run_timestep` — Algorithm 4's continuous-enumeration phase,
* :func:`snapshot_diff_oracle` — an independent brute-force oracle.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Dict, FrozenSet, List, Optional, Sequence, Set, Tuple

from ..graph.dynamic import SnapshotStore, Update
from ..graph.storage import DiGraph
from .estimate import DEFAULT_STATS, GraphStats
from .instructions import (DBQ, DENU, ENU, INI, INS, INT, RES, Instr, Plan,
                           Var, substitute)
from .pattern import Pattern
from .plangen import (common_subexpression_elimination, reorder_instructions,
                      search_matching_orders, uni_operand_elimination,
                      estimate_computation_cost)
from .symmetry import symmetry_breaking_constraints

# edge types
EITHER, DELTA, UNALTERED = "either", "delta", "unaltered"
_TYPE_LETTER = {EITHER: "E", DELTA: "D", UNALTERED: "U"}


# --------------------------------------------------------------------------
# Incremental pattern graphs (Definition 5)
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class IncrementalPattern:
    """ΔP_i: the pattern P with edge-type mapping τ_i.

    ``delta_edge`` is the paper's 1-based edge index i; ``pattern.edges[i-1]``
    is the delta edge.
    """

    pattern: Pattern
    delta_edge: int  # 1-based

    def __post_init__(self):
        if not self.pattern.directed:
            raise ValueError("S-BENU patterns are directed")
        if not (1 <= self.delta_edge <= self.pattern.m):
            raise ValueError(f"delta edge {self.delta_edge} out of range")

    def tau(self, k: int) -> str:
        """Type of the k-th (1-based) edge of P under τ_i."""
        if k < self.delta_edge:
            return EITHER
        if k == self.delta_edge:
            return DELTA
        return UNALTERED

    def edge_type(self, e: Tuple[int, int]) -> str:
        k = self.pattern.edges.index(e) + 1
        return self.tau(k)

    @property
    def delta_src(self) -> int:
        return self.pattern.edges[self.delta_edge - 1][0]

    @property
    def delta_dst(self) -> int:
        return self.pattern.edges[self.delta_edge - 1][1]

    # -------------------------------------------------- dual condition (§5.4)
    def neighborhood_contained(self, x: int, y: int) -> bool:
        """True iff the typed neighborhood of u_x is contained in u_y's."""
        P = self.pattern
        es = set(P.edges)
        for (a, b) in P.edges:
            if a == x and b != y:          # e = (u_x, u_z)
                if (y, b) not in es or self.edge_type((a, b)) != \
                        self.edge_type((y, b)):
                    return False
            if b == x and a != y:          # e = (u_z, u_x)
                if (a, y) not in es or self.edge_type((a, b)) != \
                        self.edge_type((a, y)):
                    return False
        return True

    def syntactic_equivalent(self, x: int, y: int) -> bool:
        return (self.neighborhood_contained(x, y)
                and self.neighborhood_contained(y, x))

    def se_classes(self) -> List[List[int]]:
        n = self.pattern.n
        cls: List[List[int]] = []
        assigned = [False] * n
        for a in range(n):
            if assigned[a]:
                continue
            group = [a]
            assigned[a] = True
            for b in range(a + 1, n):
                if not assigned[b] and self.syntactic_equivalent(a, b):
                    group.append(b)
                    assigned[b] = True
            cls.append(group)
        return cls


def incremental_patterns(pattern: Pattern) -> List[IncrementalPattern]:
    return [IncrementalPattern(pattern, i) for i in range(1, pattern.m + 1)]


# --------------------------------------------------------------------------
# Incremental execution plan generation (§5.3.2)
# --------------------------------------------------------------------------


def _adj_var(type_: str, direction: str, vertex: int) -> Var:
    """('AEO', 3) style S-BENU adjacency variable."""
    return ("A" + _TYPE_LETTER[type_] + ("I" if direction == "in" else "O"),
            vertex)


def generate_sbenu_raw_plan(dp: IncrementalPattern,
                            order: Sequence[int],
                            constraints: Optional[Sequence[Tuple[int, int]]]
                            = None) -> Plan:
    """Raw incremental plan for ΔP_i bound to matching order ``order``.

    ``order`` must start with (u_si, u_ti) — the endpoints of the delta edge.
    """
    P = dp.pattern
    s, t = dp.delta_src, dp.delta_dst
    if tuple(order[:2]) != (s, t):
        raise ValueError(f"order must start with delta endpoints ({s},{t})")
    if sorted(order) != list(range(P.n)):
        raise ValueError(f"order {order} is not a permutation of V(P)")
    if constraints is None:
        constraints = symmetry_breaking_constraints(P)
    cons = set(map(tuple, constraints))
    pos = {u: i for i, u in enumerate(order)}
    es = set(P.edges)

    instrs: List[Instr] = []

    def filters_for(u: int, upto: int) -> Tuple[Tuple[str, Var], ...]:
        fcs: List[Tuple[str, Var]] = []
        for j in order[:upto]:
            if (j, u) in cons:
                fcs.append((">", ("f", j)))
            elif (u, j) in cons:
                fcs.append(("<", ("f", j)))
            elif j not in P.adj[u]:
                fcs.append(("!=", ("f", j)))
        return tuple(fcs)

    def dbqs_for(u: int) -> List[Instr]:
        """The {either,unaltered} x {in,out} adjacency fetches for u."""
        out = []
        for ty in (EITHER, UNALTERED):
            for di in ("in", "out"):
                out.append(Instr(DBQ, _adj_var(ty, di, u),
                                 operands=(("f", u),),
                                 adj_type=ty, adj_dir=di, adj_op="op"))
        return out

    # ---- bootstrap: the delta edge (Alg. 4 lines 12-16)
    instrs.append(Instr(INI, ("f", s)))
    instrs.append(Instr(DBQ, _adj_var(DELTA, "out", s), operands=(("f", s),),
                        adj_type=DELTA, adj_dir="out", adj_op="*"))
    instrs.append(Instr(INT, ("C", t), operands=(_adj_var(DELTA, "out", s),),
                        filters=filters_for(t, 1)))
    instrs.append(Instr(DENU, ("f", t), operands=(("C", t),)))
    instrs.extend(dbqs_for(s))
    instrs.extend(dbqs_for(t))
    # back edge (u_t, u_s): existence test against f_t's typed out-adjacency
    if (t, s) in es:
        ty = dp.edge_type((t, s))
        instrs.append(Instr(INS, None,
                            operands=(("f", s), _adj_var(ty, "out", t))))

    # ---- remaining vertices
    for i in range(2, P.n):
        u = order[i]
        ops: List[Var] = []
        for x in sorted((x for x in P.adj_in[u] if pos[x] < i),
                        key=lambda x: pos[x]):
            ops.append(_adj_var(dp.edge_type((x, u)), "out", x))
        for x in sorted((x for x in P.adj_out[u] if pos[x] < i),
                        key=lambda x: pos[x]):
            ops.append(_adj_var(dp.edge_type((u, x)), "in", x))
        if not ops:
            raise ValueError("pattern must be connected under the order")
        instrs.append(Instr(INT, ("T", u), operands=tuple(ops)))
        instrs.append(Instr(INT, ("C", u), operands=(("T", u),),
                            filters=filters_for(u, i)))
        instrs.append(Instr(ENU, ("f", u), operands=(("C", u),)))
        instrs.extend(dbqs_for(u))

    instrs.append(Instr(RES, None,
                        report=tuple(("f", u) for u in range(P.n))))

    plan = Plan(pattern_name=P.name, n=P.n, matching_order=tuple(order),
                instrs=instrs, constraints=tuple(sorted(cons)),
                delta_edge=dp.delta_edge)
    remove_useless_dbqs(plan)
    uni_operand_elimination(plan)
    return plan


def remove_useless_dbqs(plan: Plan) -> int:
    """Drop DBQ instructions whose targets no other instruction reads."""
    removed = 0
    changed = True
    while changed:
        changed = False
        used: Set[Var] = set()
        for ins in plan.instrs:
            used.update(ins.uses())
        for idx, ins in enumerate(plan.instrs):
            if ins.op == DBQ and ins.target not in used:
                del plan.instrs[idx]
                removed += 1
                changed = True
                break
    return removed


def generate_sbenu_plan(dp: IncrementalPattern,
                        order: Sequence[int],
                        use_cse: bool = True,
                        use_reorder: bool = True) -> Plan:
    """Optimized incremental plan (CSE + reordering; no TRC — §5.4)."""
    plan = generate_sbenu_raw_plan(dp, order)
    if use_cse:
        common_subexpression_elimination(plan)
    if use_reorder:
        reorder_instructions(plan)
    return plan


def generate_best_sbenu_plans(pattern: Pattern,
                              stats: GraphStats = DEFAULT_STATS,
                              use_cse: bool = True,
                              use_reorder: bool = True) -> List[Plan]:
    """Best incremental execution plan per ΔP_i (modified Alg. 3, §5.4)."""
    plans: List[Plan] = []
    for dp in incremental_patterns(pattern):
        prefix = (dp.delta_src, dp.delta_dst)
        sr = search_matching_orders(pattern, stats, fixed_prefix=prefix,
                                    delta_edge=dp.delta_edge,
                                    se_classes=dp.se_classes())
        best: Optional[Plan] = None
        best_cost = float("inf")
        for order in sr.candidates:
            plan = generate_sbenu_plan(dp, order, use_cse=use_cse,
                                       use_reorder=use_reorder)
            cost = estimate_computation_cost(pattern, plan, stats)
            if cost < best_cost:
                best_cost = cost
                best = plan
        assert best is not None, f"no candidate order for dP_{dp.delta_edge}"
        plans.append(best)
    return plans


# --------------------------------------------------------------------------
# Reference engine (Algorithm 4, enumeration sub-phase)
# --------------------------------------------------------------------------


class FlaggedSet(list):
    """A delta adjacency set: list of ``(op, vertex)`` with op in {'+','-'}."""


@dataclass
class SBenuCounters:
    dbq: int = 0
    int_: int = 0
    ins: int = 0
    enu: int = 0
    matches_plus: int = 0
    matches_minus: int = 0
    per_task_work: List[int] = None  # type: ignore

    def __post_init__(self):
        if self.per_task_work is None:
            self.per_task_work = []


class SBenuRefEngine:
    """Interprets the m incremental plans over a SnapshotStore at step t."""

    def __init__(self, plans: Sequence[Plan], pattern: Pattern,
                 store: SnapshotStore, collect: str = "matches",
                 cache_capacity: Optional[int] = None):
        self.plans = list(plans)
        self.pattern = pattern
        self.store = store
        self.collect = collect
        self.counters = SBenuCounters()
        self.delta_plus: List[Tuple[int, ...]] = []
        self.delta_minus: List[Tuple[int, ...]] = []
        # local DB cache (paper §6.1/§6.2 cache-format): keyed by vertex,
        # value = the full quad; hits avoid "remote" store queries.
        self.cache_capacity = cache_capacity
        self._cache: Dict[int, Dict[Tuple[str, str, str], frozenset]] = {}
        self.remote_queries = 0
        self.total_queries = 0

    # ------------------------------------------------------------------ run
    def run_timestep(self, theta: Optional[int] = None) -> None:
        """Enumerate ΔR_t^± for the store's current (begun) step."""
        self.run_starts(self.store.start_vertices(), theta=theta)

    def run_starts(self, starts, theta: Optional[int] = None) -> None:
        """Run the local search tasks for ``starts``; heavy tasks θ-split
        on their delta adjacency list. The single task-split rule shared
        with the unified Executor's sbenu backend."""
        for start in starts:
            start = int(start)
            delta_out = self.store.delta_adj_out(start)
            if theta is not None and len(delta_out) > theta:
                n_sub = -(-len(delta_out) // theta)
                for si in range(n_sub):
                    sl = delta_out[si * theta:(si + 1) * theta]
                    self._run_task(start, sl)
            else:
                self._run_task(start, delta_out)

    def _run_task(self, start: int,
                  delta_out: List[Tuple[str, int]]) -> None:
        work0 = self.counters.int_ + self.counters.enu
        for plan in self.plans:
            env: Dict[Var, object] = {"__delta_out__": delta_out}
            self._exec(plan, 0, env, start, None)
        self.counters.per_task_work.append(
            self.counters.int_ + self.counters.enu - work0)

    # -------------------------------------------------------------- adjacency
    def _get_adj(self, v: int, ty: str, di: str, op: str) -> object:
        self.total_queries += 1
        if self.cache_capacity is not None:
            self.total_queries -= 1  # counted below per-cache semantics
            return self._get_adj_cached(v, ty, di, op)
        return self.store.get_adj(v, ty, di, op)

    def _get_adj_cached(self, v: int, ty: str, di: str, op: str) -> object:
        self.total_queries += 1
        quad = self._cache.get(v)
        if quad is None:
            self.remote_queries += 1
            quad = {}
            for ty2 in (EITHER, DELTA, UNALTERED):
                for di2 in ("in", "out"):
                    for op2 in ("+", "-"):
                        quad[(ty2, di2, op2)] = self.store.get_adj(
                            v, ty2, di2, op2)
            if self.cache_capacity > 0:
                self._cache[v] = quad
                if len(self._cache) > self.cache_capacity:
                    self._cache.pop(next(iter(self._cache)))
        return quad[(ty, di, op)]

    # ------------------------------------------------------------- interpret
    def _apply_filters(self, values, filters, env):
        flagged = isinstance(values, FlaggedSet)
        out = []
        for x in values:
            w = x[1] if flagged else x   # flagged delta entries are (op, w)
            ok = True
            for op, var in filters:
                fv = env[var]
                if op == "<" and not w < fv:
                    ok = False
                elif op == ">" and not w > fv:
                    ok = False
                elif op == "!=" and w == fv:
                    ok = False
                if not ok:
                    break
            if ok:
                out.append(x)
        return FlaggedSet(out) if flagged else out

    def _exec(self, plan: Plan, ip: int, env: Dict[Var, object],
              start: int, op: Optional[str]) -> None:
        if ip >= len(plan.instrs):
            return
        ins = plan.instrs[ip]
        kind = ins.op
        if kind == INI:
            env[ins.target] = start
            self._exec(plan, ip + 1, env, start, op)
        elif kind == DBQ:
            v = env[ins.operands[0]]
            self.counters.dbq += 1
            if ins.adj_type == DELTA and ins.adj_op == "*":
                if v == start and env.get("__delta_out__") is not None \
                        and ins.adj_dir == "out":
                    env[ins.target] = FlaggedSet(env["__delta_out__"])
                else:  # pragma: no cover - plans always query the start here
                    plus = self._get_adj(v, DELTA, ins.adj_dir, "+")
                    minus = self._get_adj(v, DELTA, ins.adj_dir, "-")
                    env[ins.target] = FlaggedSet(sorted(
                        [("+", w) for w in plus] + [("-", w) for w in minus],
                        key=lambda x: x[1]))
            else:
                eff_op = op if ins.adj_op == "op" else ins.adj_op
                assert eff_op in ("+", "-"), "op not yet bound"
                env[ins.target] = self._get_adj(
                    v, ins.adj_type, ins.adj_dir, eff_op)
            self._exec(plan, ip + 1, env, start, op)
        elif kind == INT:
            self.counters.int_ += 1
            sets = [env[v] for v in ins.operands]
            if any(isinstance(s, FlaggedSet) for s in sets):
                # delta (flagged) set intersected with plain sets
                flagged = [s for s in sets if isinstance(s, FlaggedSet)]
                plain = [frozenset(s) for s in sets
                         if not isinstance(s, FlaggedSet)]
                assert len(flagged) == 1
                acc = FlaggedSet(x for x in flagged[0]
                                 if all(x[1] in p for p in plain))
            else:
                fs = sorted((frozenset(s) for s in sets), key=len)
                acc = fs[0]
                for s in fs[1:]:
                    acc = acc & s
                acc = sorted(acc)
            acc = self._apply_filters(acc, ins.filters, env)
            env[ins.target] = acc
            self._exec(plan, ip + 1, env, start, op)
        elif kind == INS:
            self.counters.ins += 1
            fv = env[ins.operands[0]]
            if fv in env[ins.operands[1]]:
                self._exec(plan, ip + 1, env, start, op)
            # else: backtrack
        elif kind == DENU:
            src = env[ins.operands[0]]
            for entry in src:
                eop, w = entry
                self.counters.enu += 1
                env[ins.target] = w
                self._exec(plan, ip + 1, env, start, eop)
            env.pop(ins.target, None)
        elif kind == ENU:
            src = env[ins.operands[0]]
            for w in sorted(src):
                self.counters.enu += 1
                env[ins.target] = w
                self._exec(plan, ip + 1, env, start, op)
            env.pop(ins.target, None)
        elif kind == RES:
            match = tuple(env[v] for v in ins.report)
            if op == "+":
                self.counters.matches_plus += 1
                self.delta_plus.append(match)
            else:
                self.counters.matches_minus += 1
                self.delta_minus.append(match)
            self._exec(plan, ip + 1, env, start, op)
        else:  # pragma: no cover
            raise ValueError(f"S-BENU engine cannot execute {kind}")


def run_timestep(pattern: Pattern, plans: Sequence[Plan],
                 store: SnapshotStore, batch: Sequence[Update],
                 theta: Optional[int] = None,
                 cache_capacity: Optional[int] = None,
                 chunk: int = 64, engine: str = "ref",
                 collect: str = "matches", backend=None, **backend_kwargs
                 ) -> Tuple[Set[Tuple[int, ...]], Set[Tuple[int, ...]],
                            SBenuCounters]:
    """One full Alg. 4 iteration: pre-process, enumerate, post-process.

    The enumeration sub-phase routes through the port's Executor API
    (core/executor.py). ``engine`` picks the backend: ``"ref"`` (alias
    ``"sbenu"``) interprets every task in Python; ``"sbenu-torch"`` runs
    the vectorized delta-frontier engine over the six-block device
    snapshot (``device=`` among ``backend_kwargs``; the card by default).
    Either way the shared driver chunks the touched-vertex start set and
    splits overloaded chunks (θ delta-slicing for the interpreter,
    adaptive re-chunking for the vectorized engine).

    Passing a prepared ``backend`` reuses it (the vectorized backend then
    keeps its device snapshot mirror and runners across the stream).
    """
    from .executor import (ExecutorConfig, SBenuBackend, SBenuTorchBackend,
                           drive)
    store.begin_step(batch)
    if backend is None:
        if engine in ("ref", "sbenu"):
            backend = SBenuBackend(pattern, cache_capacity=cache_capacity,
                                   collect=collect, **backend_kwargs)
        elif engine == "sbenu-torch":
            backend = SBenuTorchBackend(collect=collect,
                                        **backend_kwargs)
        else:
            raise ValueError(f"unknown S-BENU engine {engine!r}")
    st = drive(backend, list(plans), store,
               ExecutorConfig(batch=chunk, theta=theta,
                              collect_matches=(collect == "matches")))
    store.end_step()
    return (st.extras["delta_plus"], st.extras["delta_minus"],
            st.extras["counters"])


# --------------------------------------------------------------------------
# Independent oracle: brute-force snapshot diff
# --------------------------------------------------------------------------


def enumerate_matches_digraph(pattern: Pattern, g: DiGraph,
                              constraints: Sequence[Tuple[int, int]] = ()
                              ) -> Set[Tuple[int, ...]]:
    """All order-respecting injective matches of a directed P in g."""
    n = pattern.n
    cons = list(constraints)
    out: Set[Tuple[int, ...]] = set()
    assign = [-1] * n
    used: Set[int] = set()

    def ok(u: int, v: int) -> bool:
        for w in pattern.adj_out[u]:
            if assign[w] >= 0 and assign[w] not in g.out[v]:
                return False
        for w in pattern.adj_in[u]:
            if assign[w] >= 0 and v not in g.out[assign[w]]:
                return False
        for a, b in cons:
            if a == u and assign[b] >= 0 and not v < assign[b]:
                return False
            if b == u and assign[a] >= 0 and not assign[a] < v:
                return False
        return True

    def rec(u: int) -> None:
        if u == n:
            out.add(tuple(assign))
            return
        for v in range(g.n):
            if v in used or not ok(u, v):
                continue
            assign[u] = v
            used.add(v)
            rec(u + 1)
            assign[u] = -1
            used.discard(v)

    rec(0)
    return out


def snapshot_diff_oracle(pattern: Pattern, store: SnapshotStore,
                         batch: Sequence[Update]
                         ) -> Tuple[Set[Tuple[int, ...]],
                                    Set[Tuple[int, ...]]]:
    """ΔR_t^± by brute force on materialized snapshots (test oracle).

    Must be called *before* the engine's begin_step (it materializes both
    snapshots itself and leaves the store untouched).
    """
    cons = symmetry_breaking_constraints(pattern)
    prev = store.snapshot("prev")
    cur = prev.copy()
    for op, a, b in batch:
        if op == "+":
            cur.add_edge(a, b)
        else:
            cur.remove_edge(a, b)
    r_prev = enumerate_matches_digraph(pattern, prev, cons)
    r_cur = enumerate_matches_digraph(pattern, cur, cons)
    return r_cur - r_prev, r_prev - r_cur
