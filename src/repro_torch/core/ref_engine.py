"""Reference (oracle) executor for BENU plans — pure Python.

Counterpart of ``repro/core/ref_engine.py`` (pure Python, copied). It
interprets an execution plan the way the paper's workers do: local search
tasks per start vertex, adjacency queries against a (cached) database, a
triangle cache per task, optional task splitting. It is the correctness
oracle of the port's frontier engines and the counting model of the
paper's cache and task-split figures.
"""

from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from ..graph.storage import Graph
from .instructions import (DBQ, ENU, INI, INT, RES, TRC, Instr, Plan, Var)
from .pattern import Pattern


# --------------------------------------------------------------------------
# Database with LRU cache (paper §6.1)
# --------------------------------------------------------------------------


class GraphDB:
    """Adjacency database with an optional LRU row cache.

    ``cache_capacity`` counts rows (the paper's capacity is bytes relative to
    graph size; benchmarks convert). ``remote_queries`` counts misses — the
    communication cost in the paper's model.
    """

    def __init__(self, graph: Graph, cache_capacity: Optional[int] = None):
        self.graph = graph
        self.capacity = cache_capacity
        self.cache: "OrderedDict[int, frozenset]" = OrderedDict()
        self.total_queries = 0
        self.remote_queries = 0

    def get_adj(self, v: int) -> frozenset:
        self.total_queries += 1
        if self.capacity is not None:
            hit = self.cache.get(v)
            if hit is not None:
                self.cache.move_to_end(v)
                return hit
        self.remote_queries += 1
        row = frozenset(int(w) for w in self.graph.adj[v])
        if self.capacity is not None and self.capacity > 0:
            self.cache[v] = row
            if len(self.cache) > self.capacity:
                self.cache.popitem(last=False)
        return row

    @property
    def hit_rate(self) -> float:
        if self.total_queries == 0:
            return 0.0
        return 1.0 - self.remote_queries / self.total_queries


# --------------------------------------------------------------------------
# Counters
# --------------------------------------------------------------------------


@dataclass
class Counters:
    dbq: int = 0
    int_: int = 0
    trc: int = 0
    trc_hits: int = 0
    enu: int = 0
    matches: int = 0
    per_task_work: List[int] = field(default_factory=list)

    def merge(self, other: "Counters") -> None:
        self.dbq += other.dbq
        self.int_ += other.int_
        self.trc += other.trc
        self.trc_hits += other.trc_hits
        self.enu += other.enu
        self.matches += other.matches
        self.per_task_work.extend(other.per_task_work)

    @property
    def computation_cost(self) -> int:
        return self.int_ + self.trc

    @property
    def communication_cost(self) -> int:
        return self.dbq


# --------------------------------------------------------------------------
# Task generation + splitting (paper §3.1, §6.3)
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class Task:
    start: int
    c2_slice: Optional[Tuple[int, int]] = None   # (begin, end) into sorted C2


def tasks_for_starts(plan: Plan, pattern: Pattern, graph: Graph,
                     starts: Iterable[int],
                     theta: Optional[int] = None) -> List[Task]:
    """Local search tasks for ``starts``; heavy tasks split by θ into C2
    slices. The single task-split rule shared by RefEngine.run and the
    unified Executor's ref backend."""
    k1, k2 = plan.matching_order[:2]
    adjacent12 = k2 in pattern.adj[k1]
    tasks: List[Task] = []
    for v in starts:
        v = int(v)
        base = int(graph.deg[v]) if adjacent12 else graph.n
        if theta is not None and base > theta:
            n_sub = -(-base // theta)
            for s in range(n_sub):
                tasks.append(Task(v, (s * theta, min((s + 1) * theta, base))))
        else:
            tasks.append(Task(v))
    return tasks


def make_tasks(plan: Plan, graph: Graph,
               theta: Optional[int] = None) -> List[Task]:
    """One task per data vertex; heavy tasks split by degree threshold θ."""
    order = plan.matching_order
    k1, k2 = order[0], order[1]
    adjacent12 = k2 in _pattern_adj(plan, k1)
    tasks: List[Task] = []
    for v in range(graph.n):
        base = int(graph.deg[v]) if adjacent12 else graph.n
        if theta is not None and base > theta:
            n_sub = -(-base // theta)
            for s in range(n_sub):
                tasks.append(Task(v, (s * theta, min((s + 1) * theta, base))))
        else:
            tasks.append(Task(v))
    return tasks


def _pattern_adj(plan: Plan, u: int) -> Set[int]:
    # reconstruct u's pattern neighbours from the plan's raw structure: the
    # ENU of order[1] consumes a set derived from A_{k1} iff adjacent. We
    # instead thread the pattern through execute(); this helper is only used
    # by make_tasks when the pattern is unavailable.
    return set(range(plan.n))  # conservative: treat as adjacent


# --------------------------------------------------------------------------
# Plan interpreter
# --------------------------------------------------------------------------


class RefEngine:
    """Interprets a BENU plan over a Graph. Oracle for the frontier
    engines."""

    def __init__(self, plan: Plan, pattern: Pattern, graph: Graph,
                 db: Optional[GraphDB] = None,
                 collect: str = "count"):
        """``collect``: 'count' | 'matches' | 'codes' (VCBC)."""
        self.plan = plan
        self.pattern = pattern
        self.graph = graph
        self.db = db or GraphDB(graph)
        self.collect = collect
        self.matches: List[Tuple[int, ...]] = []
        self.codes: List[Dict[Var, object]] = []
        self.counters = Counters()
        # resolve the ENU instruction of the 2nd matching-order vertex for
        # task splitting
        self._second_enu_idx = None
        tgt = ("f", plan.matching_order[1]) if plan.n >= 2 else None
        for i, ins in enumerate(plan.instrs):
            if ins.op == ENU and ins.target == tgt:
                self._second_enu_idx = i
                break

    # ---------------------------------------------------------------- public
    def run(self, tasks: Optional[Sequence[Task]] = None,
            theta: Optional[int] = None) -> Counters:
        if tasks is None:
            tasks = tasks_for_starts(self.plan, self.pattern, self.graph,
                                     range(self.graph.n), theta=theta)
        for task in tasks:
            self._run_task(task)
        return self.counters

    # --------------------------------------------------------------- internal
    def _run_task(self, task: Task) -> None:
        env: Dict[Var, object] = {}
        tcache: Dict[Tuple[int, int], frozenset] = {}
        work_before = self.counters.int_ + self.counters.trc + self.counters.enu
        self._exec(0, env, task, tcache)
        self.counters.per_task_work.append(
            self.counters.int_ + self.counters.trc + self.counters.enu
            - work_before)

    def _apply_filters(self, values: Iterable[int], filters,
                       env: Dict[Var, object]) -> frozenset:
        out = []
        for x in values:
            ok = True
            for op, var in filters:
                fv = env[var]
                if op == "<" and not x < fv:
                    ok = False
                elif op == ">" and not x > fv:
                    ok = False
                elif op == "!=" and x == fv:
                    ok = False
                if not ok:
                    break
            if ok:
                out.append(x)
        return frozenset(out)

    def _operand_set(self, var: Var, env: Dict[Var, object]) -> frozenset:
        if var[0] == "VG":
            return frozenset(range(self.graph.n))
        return env[var]  # type: ignore

    def _exec(self, ip: int, env: Dict[Var, object], task: Task,
              tcache: Dict[Tuple[int, int], frozenset]) -> None:
        if ip >= len(self.plan.instrs):
            return
        ins = self.plan.instrs[ip]
        op = ins.op
        if op == INI:
            env[ins.target] = task.start
            self._exec(ip + 1, env, task, tcache)
        elif op == DBQ:
            v = env[ins.operands[0]]
            env[ins.target] = self.db.get_adj(v)  # type: ignore
            self.counters.dbq += 1
            self._exec(ip + 1, env, task, tcache)
        elif op == INT:
            self.counters.int_ += 1
            sets = [self._operand_set(v, env) for v in ins.operands]
            sets.sort(key=len)
            acc = sets[0]
            for s in sets[1:]:
                acc = acc & s
            if ins.filters:
                acc = self._apply_filters(acc, ins.filters, env)
            env[ins.target] = acc
            self._exec(ip + 1, env, task, tcache)
        elif op == TRC:
            self.counters.trc += 1
            fi, fj = env[ins.operands[0]], env[ins.operands[1]]
            key = (fi, fj)  # type: ignore
            hit = tcache.get(key)
            if hit is None:
                ai = self._operand_set(ins.operands[2], env)
                aj = self._operand_set(ins.operands[3], env)
                hit = ai & aj
                tcache[key] = hit
            else:
                self.counters.trc_hits += 1
            if ins.filters:
                hit = self._apply_filters(hit, ins.filters, env)
            env[ins.target] = hit
            self._exec(ip + 1, env, task, tcache)
        elif op == ENU:
            src = sorted(self._operand_set(ins.operands[0], env))
            if ip == self._second_enu_idx and task.c2_slice is not None:
                b, e = task.c2_slice
                src = src[b:e]
            for v in src:
                self.counters.enu += 1
                env[ins.target] = v
                self._exec(ip + 1, env, task, tcache)
            env.pop(ins.target, None)
        elif op == RES:
            self.counters.matches += 1
            if self.collect == "matches":
                self.matches.append(tuple(env[v] for v in ins.report))
            elif self.collect == "codes":
                self.codes.append({v: env[v] for v in ins.report})
            self._exec(ip + 1, env, task, tcache)
        else:
            raise ValueError(f"ref engine cannot execute {op}")


# --------------------------------------------------------------------------
# Brute-force oracle (independent of the plan machinery)
# --------------------------------------------------------------------------


def enumerate_matches_brute(pattern: Pattern, graph: Graph,
                            constraints: Sequence[Tuple[int, int]] = ()
                            ) -> List[Tuple[int, ...]]:
    """All injective order-respecting matches of P in G by naive backtracking."""
    cons = list(constraints)
    n = pattern.n
    out: List[Tuple[int, ...]] = []
    assign: List[int] = [-1] * n
    used: Set[int] = set()

    adjacency = [set(int(w) for w in graph.adj[v]) for v in range(graph.n)]

    def ok(u: int, v: int) -> bool:
        for w in pattern.adj[u]:
            if assign[w] >= 0 and assign[w] not in adjacency[v]:
                return False
        for a, b in cons:
            if a == u and assign[b] >= 0 and not v < assign[b]:
                return False
            if b == u and assign[a] >= 0 and not assign[a] < v:
                return False
        return True

    def rec(u: int) -> None:
        if u == n:
            out.append(tuple(assign))
            return
        for v in range(graph.n):
            if v in used or not ok(u, v):
                continue
            assign[u] = v
            used.add(v)
            rec(u + 1)
            assign[u] = -1
            used.discard(v)

    rec(0)
    return out


def count_isomorphic_subgraphs(pattern: Pattern, graph: Graph) -> int:
    """#subgraphs of G isomorphic to P = #matches / |Aut(P)|."""
    total = len(enumerate_matches_brute(pattern, graph))
    n_aut = len(pattern.automorphisms)
    assert total % n_aut == 0
    return total // n_aut
