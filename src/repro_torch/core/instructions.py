"""Execution-plan instructions (paper Table 3).

BENU (static, undirected):
    INI   f_i := Init(start)
    DBQ   A_i := GetAdj(f_i)
    INT   X   := Intersect(ops...)[| FCs]
    ENU   f_i := Foreach(X)
    TRC   X   := TCache(f_i, f_j, A_i, A_j)
    RES   f   := ReportMatch(f_1, ..)      (VCBC: some f_i replaced by C_i)

S-BENU additions (dynamic, directed):
    DBQ   A?? _i := GetAdj(f_i, type, dir, op)   type in {either,delta,unaltered}
    DENU  op, f_i := Foreach(X)                  (delta enumeration)
    INS   InSetTest(f_i, X)                      (back-edge existence test)

Variables are (kind, index) pairs. Kinds:
    'f'  mapped data vertex            'A'  adjacency set (BENU)
    'T'  intermediate intersection     'C'  candidate set
    'VG' the whole vertex set V(G)
    S-BENU adjacency kinds: 'AEI','AEO','ADI','ADO','AUI','AUO'
        (A + Either/Delta/Unaltered + In/Out)
Filter conditions are (op, var) with op in {'<', '>', '!='} comparing the
instruction's elements against ``f_var`` under the total order on V(G).
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import List, Optional, Tuple

Var = Tuple[str, int]          # e.g. ('A', 3), ('f', 0), ('VG', -1)
Filter = Tuple[str, Var]       # ('<', ('f', 2))

VG: Var = ("VG", -1)

INI, DBQ, INT, ENU, TRC, RES = "INI", "DBQ", "INT", "ENU", "TRC", "RES"
DENU, INS = "DENU", "INS"

# type rank used by Opt2 instruction reordering (paper §4.2.2)
TYPE_RANK = {INI: 0, INT: 1, TRC: 2, INS: 2, DBQ: 3, ENU: 4, DENU: 4, RES: 5}

SB_ADJ_KINDS = ("AEI", "AEO", "ADI", "ADO", "AUI", "AUO")


def var_name(v: Var) -> str:
    k, i = v
    return "V(G)" if k == "VG" else f"{k}{i + 1}"  # 1-based like the paper


@dataclass(frozen=True)
class Instr:
    op: str
    target: Optional[Var]                 # None for INS / RES
    operands: Tuple[Var, ...] = ()
    filters: Tuple[Filter, ...] = ()
    # DBQ (S-BENU): adjacency spec
    adj_type: Optional[str] = None        # either|delta|unaltered
    adj_dir: Optional[str] = None         # in|out
    adj_op: Optional[str] = None          # '+'|'-'|'*' (op-dependent snapshot)
    # RES payload: for VCBC, some entries are C-vars instead of f-vars
    report: Tuple[Var, ...] = ()

    def uses(self) -> Tuple[Var, ...]:
        """All variables this instruction reads (operands + filters + report).

        S-BENU: a DBQ with ``adj_op='op'`` reads the snapshot selector bound
        by the Delta-ENU, modeled as the pseudo-variable ``('op', -1)`` so the
        reorderer cannot hoist it above the Delta-ENU (cf. Fig. 6b).
        """
        vs = list(self.operands)
        vs += [v for _, v in self.filters]
        vs += list(self.report)
        if self.adj_op == "op":
            vs.append(("op", -1))
        return tuple(vs)

    def pretty(self) -> str:
        f = ""
        if self.filters:
            f = " | " + ", ".join(f"{op}{var_name(v)}" for op, v in self.filters)
        if self.op == INI:
            return f"{var_name(self.target)} := Init(start)"
        if self.op == DBQ:
            if self.adj_type is None:
                return f"{var_name(self.target)} := GetAdj({var_name(self.operands[0])})"
            return (f"{var_name(self.target)} := GetAdj("
                    f"{var_name(self.operands[0])},{self.adj_type},"
                    f"{self.adj_dir},{self.adj_op})")
        if self.op == INT:
            ops = ", ".join(var_name(v) for v in self.operands)
            return f"{var_name(self.target)} := Intersect({ops}){f}"
        if self.op == TRC:
            ops = ", ".join(var_name(v) for v in self.operands)
            return f"{var_name(self.target)} := TCache({ops}){f}"
        if self.op == ENU:
            return f"{var_name(self.target)} := Foreach({var_name(self.operands[0])})"
        if self.op == DENU:
            return (f"op,{var_name(self.target)} := "
                    f"Foreach({var_name(self.operands[0])})")
        if self.op == INS:
            return (f"InSetTest({var_name(self.operands[0])}, "
                    f"{var_name(self.operands[1])})")
        if self.op == RES:
            ops = ", ".join(var_name(v) for v in self.report)
            return f"f := ReportMatch({ops})"
        raise ValueError(self.op)


@dataclass
class Plan:
    """An ordered instruction list bound to a matching order."""

    pattern_name: str
    n: int
    matching_order: Tuple[int, ...]
    instrs: List[Instr]
    vcbc: bool = False
    core_k: int = 0                        # VCBC: first core_k of O are the cover
    constraints: Tuple[Tuple[int, int], ...] = ()   # symmetry partial order
    # S-BENU: which incremental pattern this plan enumerates (1-based), 0=BENU
    delta_edge: int = 0

    def pretty(self) -> str:
        hdr = (f"# plan for {self.pattern_name}, O="
               f"{[i + 1 for i in self.matching_order]}"
               + (f", VCBC core k={self.core_k}" if self.vcbc else "")
               + (f", dP_{self.delta_edge}" if self.delta_edge else ""))
        return "\n".join([hdr] + [f"{i:2d}: {ins.pretty()}"
                                  for i, ins in enumerate(self.instrs)])

    def count_ops(self) -> dict:
        c: dict = {}
        for ins in self.instrs:
            c[ins.op] = c.get(ins.op, 0) + 1
        return c

    def replace_instr(self, idx: int, new: Instr) -> None:
        self.instrs[idx] = new


def substitute(ins: Instr, old: Var, new: Var) -> Instr:
    """Replace variable ``old`` with ``new`` everywhere in ``ins``."""
    ops = tuple(new if v == old else v for v in ins.operands)
    flt = tuple((op, new if v == old else v) for op, v in ins.filters)
    rep = tuple(new if v == old else v for v in ins.report)
    return replace(ins, operands=ops, filters=flt, report=rep)
