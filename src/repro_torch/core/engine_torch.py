"""Level-synchronous frontier engine for BENU execution plans, in PyTorch.

Counterpart of ``repro/core/engine_jax.py``. Algorithm 1's per-start
backtracking becomes frontier expansion: a frontier is a batch of partial
matches (one row each), and every instruction acts on the whole frontier:

    INI   materialize the start-vertex column
    DBQ   gather adjacency rows for a frontier column
    INT   row-wise padded-set intersection (csrc/sorted_intersect.cu)
    TRC   the same intersection of its two adjacency operands
    ENU   expand each row by its candidate set and compact the valid
          children into a fixed-capacity child frontier (overflow is
          counted; the driver re-chunks)
    RES   count (or collect) the rows that are complete matches

Sets are padded int32 rows: entries equal to the sentinel (= N) are holes
and valid entries ascend. Intersection keeps entries in place, so nothing
is compacted before ENU.

Differences from the JAX engine, all of them bit-neutral:

* torch indexing faults on out-of-range ids where JAX clips, so every
  gather clamps its ids to ``[0, n]`` (row ``n`` is all holes);
* torch scatter has no drop mode: ENU scatters into a ``cap + 1`` buffer
  and slices off slot ``cap``, where every overflowing or invalid child
  lands (the order of those colliding writes does not matter);
* flat child positions are int64 (``B * D`` passes 2**31 at full width)
  and a child's parent row is ``take // D`` instead of an indexed
  ``repeat(arange(B), D)``;
* counts are int64, read back as Python ints.
"""

from __future__ import annotations

from collections import Counter
from dataclasses import dataclass
from typing import Callable, Dict, FrozenSet, List, Optional, Sequence, Tuple

import torch

from ..graph.storage import Graph
from ..kernels import ops as kops
from .instructions import DBQ, ENU, INI, INT, RES, TRC, Plan, Var

FetchFn = Callable[[torch.Tensor], torch.Tensor]  # int32[B] -> int32[B, D]


def resolve_device(device: Optional[object]) -> torch.device:
    """``device`` as a torch.device; ``None`` means the card, and raises
    when there is none (the port never moves to the CPU silently)."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass "
                           "device='cpu' to run the port on the CPU")
    return torch.device("cuda")


# --------------------------------------------------------------------------
# Device-resident graph
# --------------------------------------------------------------------------


@dataclass
class DeviceGraph:
    """Padded adjacency rows on a device. Row ``n`` (the sentinel row) is
    all holes, so gathers with clamped invalid ids are safe."""

    rows: torch.Tensor     # int32[N+1, D]
    n: int                 # number of real vertices; the sentinel value

    @property
    def d(self) -> int:
        return self.rows.shape[1]

    @staticmethod
    def from_graph(graph: Graph, device: torch.device) -> "DeviceGraph":
        """Rows padded to a multiple of 128 lanes, plus the sentinel row."""
        rows, _ = graph.padded_adjacency(lane=128)
        out = torch.empty((graph.n + 1, rows.shape[1]), dtype=torch.int32,
                          device=device)
        out[:graph.n].copy_(torch.from_numpy(rows))
        out[graph.n] = graph.n
        return DeviceGraph(rows=out, n=graph.n)

    def local_fetch(self) -> FetchFn:
        rows, n = self.rows, self.n

        def fetch(ids: torch.Tensor) -> torch.Tensor:
            return rows.index_select(0, ids.clamp(0, n))

        return fetch


# --------------------------------------------------------------------------
# Plan preprocessing: liveness + static checks
# --------------------------------------------------------------------------


def _liveness(plan: Plan) -> List[frozenset]:
    """live[i] = vars read at instruction >= i (gathered across ENUs)."""
    live: List[frozenset] = [frozenset()] * (len(plan.instrs) + 1)
    acc: frozenset = frozenset()
    for i in range(len(plan.instrs) - 1, -1, -1):
        acc = acc | frozenset(v for v in plan.instrs[i].uses()
                              if v[0] != "op")
        live[i] = acc
    return live


def classify_fusable_dbqs(plan: Plan) -> FrozenSet[Var]:
    """DBQ targets whose gather can fuse into the intersect kernel.

    A DBQ row set is *fusable* when it is consumed exactly once, by an INT
    or TRC, as a **non-first** operand: the fused kernel
    (csrc/gather_intersect.cu) then probes the running result against the
    adjacency rows directly and the ``[B, D]`` gather is never written.
    First operands stay materialized (their slots define the result
    layout, keeping fused runs bit-equal to unfused ones), and multi-use
    row sets stay materialized too (that reuse is the triangle cache).
    """
    use_count: Counter = Counter()
    for ins in plan.instrs:
        use_count.update(ins.uses())
    dbq_targets = {ins.target for ins in plan.instrs if ins.op == DBQ}
    fusable = set()
    for ins in plan.instrs:
        if ins.op == INT:
            consumed = ins.operands[1:]
        elif ins.op == TRC:
            consumed = ins.operands[3:]      # engine folds operands[2] ∩ [3]
        else:
            continue
        for v in consumed:
            if v in dbq_targets and use_count[v] == 1:
                fusable.add(v)
    return frozenset(fusable)


def check_jit_supported(plan: Plan) -> bool:
    """Validate the plan; returns True iff it consumes V(G) (detached-vertex
    matching orders, e.g. the wedge order for the square — the driver then
    also iterates universe chunks). The name is the reference's."""
    n_vg = 0
    for ins in plan.instrs:
        if ins.op not in (INI, DBQ, INT, TRC, ENU, RES):
            raise NotImplementedError(
                f"engine_torch supports BENU plans only (got {ins.op})")
        n_vg += sum(1 for v in ins.operands if v[0] == "VG")
    if n_vg > 1:
        raise NotImplementedError(
            "plans with two detached vertices need nested universe loops; "
            "the best-plan search never emits these")
    return n_vg == 1


# --------------------------------------------------------------------------
# Instruction primitives
# --------------------------------------------------------------------------


def _apply_filters(sets: torch.Tensor, filters,
                   env: Dict[Var, torch.Tensor],
                   sentinel: int) -> torch.Tensor:
    out = sets
    for op, var in filters:
        f = env[var][:, None]
        if op == "<":
            cond = out < f
        elif op == ">":
            cond = out > f
        elif op == "!=":
            cond = out != f
        else:  # pragma: no cover
            raise ValueError(op)
        out = out.masked_fill(~cond, sentinel)
    return out


def _expand(env: Dict[Var, torch.Tensor], valid: torch.Tensor,
            cand: torch.Tensor, target: Var, cap: int, live: frozenset,
            sentinel: int, compaction: str = "cumsum",
            extra_cols: Optional[Dict[Var, torch.Tensor]] = None
            ) -> Tuple[Dict[Var, torch.Tensor], torch.Tensor, torch.Tensor]:
    """ENU: frontier [B] -> child frontier [cap]. Returns (env', valid',
    overflow_count).

    ``extra_cols`` maps extra per-candidate columns (``[B, D]`` aligned with
    ``cand``) to env vars of the child frontier — the S-BENU Delta-ENU uses
    this to carry each candidate's ± snapshot selector alongside its vertex
    (0 in invalid child slots).

    Compaction of the valid children to the front, in flat order:
      * "cumsum": positions by prefix sum + one scatter into a ``cap + 1``
        buffer whose last slot takes every dropped child;
      * "sort":   stable argsort on the invalid mask.
    Both orders are identical, so results are bit-equal.
    """
    B, D = cand.shape
    n = B * D
    flat = cand.reshape(n)
    fvalid = ((cand != sentinel) & valid[:, None]).reshape(n)
    if compaction == "sort":
        take = torch.argsort((~fvalid).to(torch.int8), stable=True)[:cap]
        new_valid = fvalid[take]
    else:
        slot = torch.cumsum(fvalid, 0)               # int64
        slot -= 1
        slot.masked_fill_(~(fvalid & (slot < cap)), cap)
        take = torch.full((cap + 1,), n, dtype=torch.int64,
                          device=cand.device)
        take.scatter_(0, slot, torch.arange(n, dtype=torch.int64,
                                            device=cand.device))
        del slot
        take = take[:cap]
        new_valid = take < n
        take = take.masked_fill(~new_valid, 0)
    parents = torch.div(take, D, rounding_mode="floor")
    total = fvalid.sum()
    overflow = (total - new_valid.sum()).clamp(min=0)
    new_env: Dict[Var, torch.Tensor] = {}
    for v, arr in env.items():
        if v in live:
            new_env[v] = arr.index_select(0, parents)
    new_env[target] = flat[take].masked_fill(~new_valid, sentinel)
    if extra_cols:
        for v, arr in extra_cols.items():
            new_env[v] = arr.reshape(n)[take].masked_fill(~new_valid, 0)
    return new_env, new_valid, overflow


def _vcbc_row_counts(plan: Plan, env: Dict[Var, torch.Tensor],
                     valid: torch.Tensor, sentinel: int,
                     report: Sequence[Var]) -> torch.Tensor:
    """Exact per-row match counts (int64) for VCBC-compressed plans.

    Non-core vertices are pairwise non-adjacent (V_c is a vertex cover), so
    the plan dropped (a) pairwise injectivity and (b) symmetry order
    constraints between them; both are re-imposed here. Closed forms cover
    <= 2 non-core vertices (every paper pattern's compressed plan).
    """
    noncore = [v for v in report if v[0] == "C"]
    if len(noncore) > 2:
        raise NotImplementedError(
            f"{len(noncore)} non-core vertices; use a non-VCBC plan")
    if not noncore:
        return valid.to(torch.int64)
    if len(noncore) == 1:
        cnt = (env[noncore[0]] != sentinel).sum(dim=1)
        return torch.where(valid, cnt, 0)
    (va, vb) = noncore
    a, b = env[va], env[vb]
    ua, ub = va[1], vb[1]
    cons = set(plan.constraints)
    pair_valid = (a[:, :, None] != sentinel) & (b[:, None, :] != sentinel)
    if (ua, ub) in cons:
        cond = a[:, :, None] < b[:, None, :]
    elif (ub, ua) in cons:
        cond = a[:, :, None] > b[:, None, :]
    else:
        cond = a[:, :, None] != b[:, None, :]
    cnt = (pair_valid & cond).sum(dim=(1, 2))
    return torch.where(valid, cnt, 0)


# --------------------------------------------------------------------------
# Enumerator builder
# --------------------------------------------------------------------------


@dataclass
class EnumResult:
    count: torch.Tensor                       # int64 scalar: matches
    overflow: torch.Tensor                    # int64 scalar: dropped children
    level_sizes: Tuple[torch.Tensor, ...]     # occupancy after each ENU
    matches: Optional[torch.Tensor] = None    # int32[cap, n] (if collected)
    matches_valid: Optional[torch.Tensor] = None


def build_enumerator(plan: Plan,
                     sentinel: int,
                     caps: Sequence[int],
                     fetch: FetchFn,
                     collect_matches: bool = False,
                     intersect_impl: str = "auto",
                     post_expand: Optional[Callable] = None,
                     compaction: str = "cumsum",
                     fused_rows: Optional[torch.Tensor] = None,
                     gather_intersect_impl: str = "auto"
                     ) -> Callable[..., EnumResult]:
    """Compile ``plan`` into a function of (starts, starts_valid
    [, universe_chunk]) on tensors of one device.

    ``caps[i]`` is the child-frontier capacity of the i-th ENU instruction;
    the result reports ``overflow`` > 0 when a capacity was hit. Plans
    consuming V(G) also take ``universe_chunk: int32[W]``, a
    sentinel-padded slice of V(G); the driver sums counts over chunks.

    ``fused_rows`` (the ``[N+1, D]`` device adjacency, row N all-sentinel)
    turns on the fused fetch path: DBQ targets classified by
    :func:`classify_fusable_dbqs` stay *lazy* — the engine carries the id
    column instead of gathered rows, and the consuming INT/TRC runs
    ``kops.fused_gather_intersect``. Results are bit-equal to the unfused
    path.

    ``post_expand(env, valid) -> (env, valid)`` (if given) runs right
    after every ENU expansion, before its level size is taken: the
    distributed engine's frontier rebalancer (core/engine_dist.py).
    """
    has_universe = check_jit_supported(plan)
    live = _liveness(plan)
    n_enu = sum(1 for ins in plan.instrs if ins.op == ENU)
    if len(caps) != n_enu:
        raise ValueError(f"need {n_enu} caps, got {len(caps)}")
    if collect_matches and plan.vcbc:
        raise ValueError("cannot collect raw matches from a VCBC plan")
    fusable = (classify_fusable_dbqs(plan) if fused_rows is not None
               else frozenset())

    def isect(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return kops.intersect_padded(a, b, sentinel, impl=intersect_impl)

    def fused(cand: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
        return kops.fused_gather_intersect(cand, ids, fused_rows, sentinel,
                                           impl=gather_intersect_impl)

    def run(starts: torch.Tensor, starts_valid: torch.Tensor,
            universe_chunk: Optional[torch.Tensor] = None) -> EnumResult:
        if has_universe and universe_chunk is None:
            raise ValueError("plan consumes V(G): pass universe_chunk")
        dev = starts.device
        env: Dict[Var, torch.Tensor] = {}
        lazy: set = set()        # fusable DBQ targets currently holding ids
        valid = starts_valid
        count = torch.zeros((), dtype=torch.int64, device=dev)
        overflow = torch.zeros((), dtype=torch.int64, device=dev)
        level_sizes: List[torch.Tensor] = []
        matches = None
        matches_valid = None
        enu_i = 0
        for ip, ins in enumerate(plan.instrs):
            if ins.op == INI:
                env[ins.target] = starts.masked_fill(~valid, sentinel)
            elif ins.op == DBQ:
                ids = env[ins.operands[0]]
                if ins.target in fusable:
                    # lazy: keep the id column; the consuming INT/TRC
                    # fuses the gather into the intersect kernel
                    env[ins.target] = ids
                    lazy.add(ins.target)
                else:
                    env[ins.target] = fetch(ids)
            elif ins.op in (INT, TRC):
                opvars = (list(ins.operands[2:4]) if ins.op == TRC
                          else list(ins.operands))
                res = None
                for v in opvars:
                    if v[0] == "VG":
                        B = valid.shape[0]
                        s = universe_chunk[None, :].expand(
                            B, universe_chunk.shape[0]).contiguous()
                        res = s if res is None else isect(res, s)
                    elif v in lazy:
                        lazy.discard(v)          # single-use by construction
                        # only non-first operands are lazy, so a running
                        # result always exists here
                        assert res is not None, v
                        res = fused(res, env[v])
                    else:
                        s = env[v]
                        res = s if res is None else isect(res, s)
                if ins.filters:
                    res = _apply_filters(res, ins.filters, env, sentinel)
                env[ins.target] = res
            elif ins.op == ENU:
                cand = env[ins.operands[0]]
                env, valid, ov = _expand(env, valid, cand, ins.target,
                                         caps[enu_i], live[ip + 1], sentinel,
                                         compaction=compaction)
                overflow = overflow + ov
                if post_expand is not None:
                    env, valid = post_expand(env, valid)
                level_sizes.append(valid.sum())
                enu_i += 1
            elif ins.op == RES:
                if plan.vcbc:
                    count = count + _vcbc_row_counts(
                        plan, env, valid, sentinel, ins.report).sum()
                else:
                    count = count + valid.sum()
                    if collect_matches:
                        matches = torch.stack([env[v] for v in ins.report],
                                              dim=1)
                        matches_valid = valid
        return EnumResult(count=count, overflow=overflow,
                          level_sizes=tuple(level_sizes),
                          matches=matches, matches_valid=matches_valid)

    return run


def default_caps(plan: Plan, batch: int, d: int,
                 growth: float = 4.0, cap_max: int = 1 << 20) -> List[int]:
    """Heuristic per-level capacities: level0 = batch * d/4, then geometric
    growth clipped to cap_max."""
    n_enu = sum(1 for ins in plan.instrs if ins.op == ENU)
    caps = []
    cur = batch * max(d // 4, 1)
    for _ in range(n_enu):
        caps.append(int(min(max(cur, batch), cap_max)))
        cur *= growth
    return caps


def enumerate_graph(plan: Plan, graph: Graph, batch: int = 256,
                    collect_matches: bool = False,
                    device=None) -> Dict[str, object]:
    """Run ``plan`` over every start vertex of ``graph`` on one device
    (the card unless ``device`` says otherwise).

    Thin wrapper over the driver (core/executor.py) and the ``torch``
    backend, as ``repro.core.engine_jax.enumerate_graph`` is over the JAX
    one: the driver re-chunks overflowing start batches (the paper's §5.2
    task splitting) and escalates to capacity doubling only for single
    unsplittable chunks — exact in all cases. Returns ``count``,
    ``chunks_retried`` (retries and splits), ``chunks_split`` and, with
    ``collect_matches``, ``matches`` (int32 ``[count, k]``). Other
    settings: call ``drive`` with an ``ExecutorConfig``.
    """
    from .executor import ExecutorConfig, TorchBackend, drive
    cfg = ExecutorConfig(batch=batch, collect_matches=collect_matches)
    st = drive(TorchBackend(device=device), plan, graph, cfg)
    out: Dict[str, object] = {"count": st.count,
                              "chunks_retried": st.chunks_retried
                              + st.chunks_split,
                              "chunks_split": st.chunks_split}
    if collect_matches:
        out["matches"] = st.matches
    return out
