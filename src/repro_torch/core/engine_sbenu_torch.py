"""Vectorized executor for S-BENU incremental execution plans, in PyTorch.

Counterpart of ``repro/core/engine_sbenu_jax.py``. ``engine_torch``
re-expresses BENU's per-task backtracking as lockstep frontier expansion;
this module does the same for the streaming half of the paper (§5): every
incremental plan ΔP_i becomes a function over a batch of start vertices
(the touched-vertex set of the update batch) and the six-block device
snapshot of :mod:`repro_torch.graph.dynamic`.

What changes relative to the static engine:

    DBQ   takes a (type, direction, op) selector against the dual-snapshot
          store: ``(either, dir, +/-)`` gathers the current/previous block,
          ``unaltered`` masks previous rows lane-wise against the deleted
          delta entries, ``delta`` sign-filters the flagged delta rows.
          ``adj_op='op'`` resolves per row via the snapshot selector bound
          by the Delta-ENU (one offset gather into the stacked prev/cur
          buffer of the direction).
    DENU  Delta-ENU: expands the flagged candidate set like ENU but carries
          each child's ± flag as an extra frontier column — the per-row
          snapshot selector for every later op-dependent DBQ and for the
          ΔR_t^+ / ΔR_t^- classification at RES.
    INS   back-edge existence test: a lane-wise membership probe of the
          mapped vertex against a fetched typed row; failing rows are
          invalidated (the vectorized backtrack).

Flagged sets are value/sign row pairs: values follow the padded-set
convention (sentinel holes, ascending), signs are +1/-1 with 0 at holes.
The port's driver (core/executor.py, ``sbenu-torch`` backend) owns
chunking and overflow. Every INT goes through
:func:`repro_torch.kernels.ops.intersect_padded`: the hand-written
``sorted_intersect`` on a CUDA tensor, which takes holes anywhere in both
operands, so rows are never re-sorted there; on the CPU the binary-search
probe, whose ascending-row invariant ``_resort_fn`` keeps (the reference's
non-TPU default, so both packages build the same frontiers). Counts are
int64.

The instruction loop is split from the data source: the typed-DBQ selector
is a pluggable ``fetch(ids, type, direction, op, opsign)`` built by
:func:`make_typed_fetch` from three gather callbacks.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..graph.dynamic import SNAPSHOT_BLOCKS, DeviceSnapshot
from ..kernels import dispatch
from ..kernels import ops as kops
from .engine_torch import _apply_filters, _expand
from .instructions import (DBQ, DENU, ENU, INI, INS, INT, RES, Instr, Plan,
                           Var)

#: pseudo-variable carrying the per-row snapshot selector (+1 -> G'_t,
#: -1 -> G'_{t-1}); bound by DENU, read by op-dependent DBQs and RES.
OP_VAR: Var = ("op", -1)


def device_put_snapshot(snap: DeviceSnapshot, device) -> DeviceSnapshot:
    """``snap`` with its blocks as int32 tensors on ``device`` and the
    stacked ``[prev; cur]`` buffer of each direction built (``prev_*`` and
    ``cur_*`` become views of it). A snapshot already there is returned
    as it is, so the stacking happens once per time step."""
    device = torch.device(device)
    if snap.stacked_out is not None and \
            snap.stacked_out.device.type == device.type and \
            device.index in (None, snap.stacked_out.device.index):
        return snap
    blocks: Dict[str, torch.Tensor] = {}
    for k in SNAPSHOT_BLOCKS:
        b = getattr(snap, k)
        if not torch.is_tensor(b):
            b = torch.from_numpy(np.ascontiguousarray(b, np.int32))
        blocks[k] = b.to(device, torch.int32)
    rows = snap.n + 1
    for di in ("out", "in"):
        stacked = torch.cat([blocks[f"prev_{di}"], blocks[f"cur_{di}"]])
        blocks[f"stacked_{di}"] = stacked
        blocks[f"prev_{di}"] = stacked[:rows]
        blocks[f"cur_{di}"] = stacked[rows:]
    return DeviceSnapshot(n=snap.n, **blocks)


# --------------------------------------------------------------------------
# Plan preprocessing
# --------------------------------------------------------------------------


def check_sbenu_jit_supported(plan: Plan) -> None:
    """Validate that ``plan`` is a connected-order incremental plan (the
    name is the reference's)."""
    n_denu = 0
    for ins in plan.instrs:
        if ins.op not in (INI, DBQ, INT, ENU, DENU, INS, RES):
            raise NotImplementedError(
                f"engine_sbenu_torch cannot execute {ins.op}")
        if any(v[0] == "VG" for v in ins.operands):
            raise NotImplementedError(
                "incremental plans are rooted at the delta edge and never "
                "consume V(G)")
        n_denu += ins.op == DENU
    if n_denu != 1:
        raise NotImplementedError(
            f"expected exactly one Delta-ENU, got {n_denu}")


def _sbenu_liveness(plan: Plan) -> List[frozenset]:
    """live[i] = vars read at instruction >= i. Unlike the static engine,
    the op pseudo-variable is tracked: RES classifies matches by it."""
    live: List[frozenset] = [frozenset()] * (len(plan.instrs) + 1)
    acc: frozenset = frozenset({OP_VAR})   # RES (last instr) reads it
    for i in range(len(plan.instrs) - 1, -1, -1):
        acc = acc | frozenset(plan.instrs[i].uses())
        live[i] = acc
    return live


def plan_level_count(plan: Plan) -> int:
    """Expansion levels = DENU + ENU instructions (one capacity each)."""
    return sum(1 for ins in plan.instrs if ins.op in (ENU, DENU))


def sbenu_default_caps(plan: Plan, batch: int, d_delta: int = 0,
                       d: int = 0, growth: float = 2.0,
                       cap_max: int = 1 << 20) -> List[int]:
    """Per-level capacities for delta frontiers.

    Delta frontiers stay near the start-batch size: a start emits its
    handful of delta edges, and every later level intersects typed
    adjacency — almost always a contraction. Capacities therefore start at
    ``2 * batch`` and grow gently; the rare heavy step overflows and is
    re-chunked (or capacity-doubled) by the adaptive driver. ``d_delta``/
    ``d`` only tighten the first level when the delta rows are known to be
    narrow."""
    caps: List[int] = []
    first = 2 * batch
    if d_delta:
        first = min(first, batch * max(d_delta, 1))
    cur = float(max(first, 8))
    for ins in plan.instrs:
        if ins.op in (DENU, ENU):
            caps.append(int(min(max(int(cur), batch), cap_max)))
            cur *= growth
    return caps


def sbenu_level_fanouts(plan: Plan) -> List[bool]:
    """Per expansion level: does it *fan out* (True) or contract (False)?

    A level whose candidate set is built from a single typed adjacency
    multiplies the frontier by ~avg degree; a level intersecting >= 2
    adjacencies almost always contracts. The DENU level is always reported
    as contracting — its exact bound (the chunk's delta-edge total) is
    computed separately.
    """
    from .instructions import SB_ADJ_KINDS
    defs: Dict[Var, Instr] = {}
    for ins in plan.instrs:
        if ins.target is not None:
            defs[ins.target] = ins

    def adj_inputs(var: Var, seen: frozenset) -> set:
        ins = defs.get(var)
        if ins is None or var in seen:
            return set()
        out: set = set()
        for v in ins.operands:
            if v[0] in SB_ADJ_KINDS:
                out.add(v)
            else:
                out |= adj_inputs(v, seen | {var})
        return out

    fan: List[bool] = []
    for ins in plan.instrs:
        if ins.op == DENU:
            fan.append(False)
        elif ins.op == ENU:
            fan.append(len(adj_inputs(ins.operands[0], frozenset())) < 2)
    return fan


def _resolve_intersect_impl(impl: str, platform: str) -> str:
    """``auto`` -> the hand-written kernel on a CUDA tensor, the
    binary-search probe on the CPU (delta rows are kept ascending there
    precisely so the O(D log D) path applies).

    A veneer over :func:`repro_torch.kernels.dispatch.resolve_impl` (explicit
    impl > ``REPRO_TORCH_INTERSECT_IMPL`` > device default) that swaps
    only the CPU default from the dense probe to the binary search.
    """
    resolved = dispatch.resolve_impl("intersect", impl, platform=platform)
    env = os.environ.get("REPRO_TORCH_INTERSECT_IMPL", "").strip()
    if impl == "auto" and resolved in ("ref", "chunked") \
            and env in ("", "auto"):
        return "binary"
    return resolved


def _resort_fn(binary: bool) -> Callable[[torch.Tensor], torch.Tensor]:
    """The binary-search intersect needs b-side rows fully ascending with
    tail holes; resort() restores that invariant after masking/filtering
    (identity for every other impl — they accept holes anywhere)."""
    if binary:
        return lambda rows: torch.sort(rows, dim=-1).values
    return lambda rows: rows


# --------------------------------------------------------------------------
# Enumerator builder
# --------------------------------------------------------------------------


@dataclass
class SBenuEnumResult:
    count_plus: torch.Tensor                 # int64: ΔR_t^+ matches
    count_minus: torch.Tensor                # int64: ΔR_t^- matches
    overflow: torch.Tensor                   # int64: dropped children
    level_sizes: Tuple[torch.Tensor, ...]
    matches: Optional[torch.Tensor] = None        # int32[cap, n]
    match_ops: Optional[torch.Tensor] = None      # int32[cap] (+1/-1)
    matches_valid: Optional[torch.Tensor] = None  # bool[cap]


FlaggedRows = Tuple[torch.Tensor, torch.Tensor]     # (values, signs)

#: fetch(ids, type, direction, op, opsign) -> rows | (values, signs)
TypedFetch = Callable[..., Union[torch.Tensor, FlaggedRows]]


def make_typed_fetch(sentinel: int,
                     resort: Callable[[torch.Tensor], torch.Tensor],
                     gather_prev: Callable[[str, torch.Tensor], torch.Tensor],
                     gather_cur: Callable[[str, torch.Tensor], torch.Tensor],
                     gather_delta: Callable[[str, torch.Tensor], FlaggedRows],
                     gather_opsel: Optional[Callable] = None) -> TypedFetch:
    """The (type, direction, op) DBQ selector of §5.3.1 over three row
    gathers.

    ``gather_prev``/``gather_cur`` serve G'_{t-1}/G'_t rows for one
    direction; ``gather_delta`` serves the flagged delta (values, signs)
    pair. ``gather_opsel`` is an optional fast path for the op-dependent
    select (one offset gather over the stacked prev/cur buffer); without
    it the select is two gathers + a row-wise ``where``.
    """

    def fetch(ids: torch.Tensor, ty: str, direction: str, op,
              opsign: Optional[torch.Tensor]
              ) -> Union[torch.Tensor, FlaggedRows]:
        if ty == "either":
            if op == "+":
                return gather_cur(direction, ids)
            if op == "-":
                return gather_prev(direction, ids)
            # per-row snapshot selector bound by the Delta-ENU
            if gather_opsel is not None:
                return gather_opsel(direction, ids, opsign)
            pv = gather_prev(direction, ids)
            cv = gather_cur(direction, ids)
            return torch.where((opsign > 0)[:, None], cv, pv)
        if ty == "unaltered":
            # prev minus deleted: mask prev entries that appear with a
            # '-' flag in the delta row (lane-wise membership probe)
            rows = gather_prev(direction, ids)
            dvals, dsigns = gather_delta(direction, ids)
            deleted = dvals.masked_fill(dsigns >= 0, sentinel)
            hit = (rows[:, :, None] == deleted[:, None, :]).any(dim=2)
            return resort(rows.masked_fill(hit, sentinel))
        if ty == "delta":
            dvals, dsigns = gather_delta(direction, ids)
            if op == "*":
                return dvals, dsigns
            want = (dsigns > 0) if op == "+" else (dsigns < 0) \
                if op == "-" else (dsigns * opsign[:, None] > 0)
            return resort(dvals.masked_fill(~want, sentinel))
        raise ValueError(ty)

    return fetch


def build_sbenu_instr_runner(plan: Plan, sentinel: int, caps: Sequence[int],
                             collect_matches: bool = False,
                             intersect_impl: str = "auto",
                             compaction: str = "cumsum"
                             ) -> Callable[..., SBenuEnumResult]:
    """The incremental instruction loop over a pluggable typed fetch.

    Returns ``run_instrs(fetch, starts, starts_valid)`` where ``fetch`` is
    a :func:`make_typed_fetch` selector. The intersect impl resolves per
    call from the device of ``starts``.
    """
    check_sbenu_jit_supported(plan)
    live = _sbenu_liveness(plan)
    n_lv = plan_level_count(plan)
    if len(caps) != n_lv:
        raise ValueError(f"need {n_lv} caps, got {len(caps)}")

    def run_instrs(fetch: TypedFetch, starts: torch.Tensor,
                   starts_valid: torch.Tensor) -> SBenuEnumResult:
        impl = _resolve_intersect_impl(intersect_impl, starts.device.type)
        resort = _resort_fn(impl == "binary")

        def isect(a, b):
            return kops.intersect_padded(a, b, sentinel, impl=impl)

        dev = starts.device
        env: Dict[Var, object] = {}
        valid = starts_valid
        count_plus = torch.zeros((), dtype=torch.int64, device=dev)
        count_minus = torch.zeros((), dtype=torch.int64, device=dev)
        overflow = torch.zeros((), dtype=torch.int64, device=dev)
        level_sizes: List[torch.Tensor] = []
        matches = match_ops = matches_valid = None
        lv = 0
        for ip, ins in enumerate(plan.instrs):
            if ins.op == INI:
                env[ins.target] = starts.masked_fill(~valid, sentinel)
            elif ins.op == DBQ:
                ids = env[ins.operands[0]]
                env[ins.target] = fetch(ids, ins.adj_type, ins.adj_dir,
                                        ins.adj_op, env.get(OP_VAR))
            elif ins.op == INT:
                sets = [env[v] for v in ins.operands]
                flagged = [s for s in sets if isinstance(s, tuple)]
                plain = [s for s in sets if not isinstance(s, tuple)]
                if flagged:
                    # the delta candidate set: flag-aware filtering keeps
                    # values and signs aligned (Delta-ENU consumes both)
                    assert len(flagged) == 1
                    vals, signs = flagged[0]
                    for other in plain:
                        vals = isect(vals, other)
                    if ins.filters:
                        vals = _apply_filters(vals, ins.filters, env,
                                              sentinel)
                    signs = signs.masked_fill(vals == sentinel, 0)
                    env[ins.target] = (vals, signs)
                else:
                    res = plain[0]
                    for other in plain[1:]:
                        res = isect(res, other)
                    if ins.filters:
                        res = _apply_filters(res, ins.filters, env, sentinel)
                    env[ins.target] = resort(res)
            elif ins.op in (ENU, DENU):
                extra = None
                if ins.op == DENU:
                    cand, signs = env[ins.operands[0]]
                    extra = {OP_VAR: signs}
                else:
                    cand = env[ins.operands[0]]
                plain_env = {v: a for v, a in env.items()
                             if not isinstance(a, tuple)}
                env, valid, ov = _expand(
                    plain_env, valid, cand, ins.target, caps[lv],
                    live[ip + 1], sentinel, compaction=compaction,
                    extra_cols=extra)
                overflow = overflow + ov
                level_sizes.append(valid.sum())
                lv += 1
            elif ins.op == INS:
                fv = env[ins.operands[0]]
                rows = env[ins.operands[1]]
                hit = (rows == fv[:, None]).any(dim=1)
                valid = valid & hit & (fv != sentinel)
            elif ins.op == RES:
                opsign = env[OP_VAR]
                count_plus = count_plus + (valid & (opsign > 0)).sum()
                count_minus = count_minus + (valid & (opsign < 0)).sum()
                if collect_matches:
                    matches = torch.stack([env[v] for v in ins.report],
                                          dim=1)
                    match_ops = opsign
                    matches_valid = valid
        return SBenuEnumResult(count_plus=count_plus,
                               count_minus=count_minus,
                               overflow=overflow,
                               level_sizes=tuple(level_sizes),
                               matches=matches, match_ops=match_ops,
                               matches_valid=matches_valid)

    return run_instrs


def build_sbenu_enumerator(plan: Plan, sentinel: int, caps: Sequence[int],
                           collect_matches: bool = False,
                           intersect_impl: str = "auto",
                           compaction: str = "cumsum"
                           ) -> Callable[..., SBenuEnumResult]:
    """An incremental plan as a function of ``(snap: DeviceSnapshot,
    starts int32[B], starts_valid bool[B])`` on tensors of one device.

    ``caps[i]`` is the child-frontier capacity of the i-th expansion level
    (DENU or ENU). A result with ``overflow > 0`` must be discarded and
    re-chunked by the driver.
    """
    run_instrs = build_sbenu_instr_runner(
        plan, sentinel, caps, collect_matches=collect_matches,
        intersect_impl=intersect_impl, compaction=compaction)

    def run(snap: DeviceSnapshot, starts: torch.Tensor,
            starts_valid: torch.Tensor) -> SBenuEnumResult:
        n = snap.n
        assert n == sentinel, "snapshot/plan sentinel mismatch"
        snap = device_put_snapshot(snap, starts.device)
        rows_total = n + 1
        stacked = {"out": snap.stacked_out, "in": snap.stacked_in}
        prev = {"out": snap.prev_out, "in": snap.prev_in}
        cur = {"out": snap.cur_out, "in": snap.cur_in}
        delta = {"out": (snap.delta_out, snap.delta_out_sign),
                 "in": (snap.delta_in, snap.delta_in_sign)}

        def gather(block: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
            return block.index_select(0, ids.clamp(0, n))

        def gather_prev(direction: str, ids: torch.Tensor) -> torch.Tensor:
            return gather(prev[direction], ids)

        def gather_cur(direction: str, ids: torch.Tensor) -> torch.Tensor:
            return gather(cur[direction], ids)

        def gather_delta(direction: str, ids: torch.Tensor) -> FlaggedRows:
            dvals, dsigns = delta[direction]
            return gather(dvals, ids), gather(dsigns, ids)

        def gather_opsel(direction: str, ids: torch.Tensor,
                         opsign: torch.Tensor) -> torch.Tensor:
            side = torch.where(opsign > 0, rows_total, 0)
            return stacked[direction].index_select(0, ids.clamp(0, n) + side)

        fetch = make_typed_fetch(sentinel, _resort_fn(
            _resolve_intersect_impl(intersect_impl, starts.device.type)
            == "binary"), gather_prev, gather_cur, gather_delta,
            gather_opsel)
        return run_instrs(fetch, starts, starts_valid)

    return run


def build_sbenu_multi_enumerator(plans: Sequence[Plan], sentinel: int,
                                 caps_list: Sequence[Sequence[int]],
                                 collect_matches: bool = False,
                                 intersect_impl: str = "auto",
                                 compaction: str = "cumsum"
                                 ) -> Callable[..., SBenuEnumResult]:
    """Every incremental plan ΔP_i over the same start chunk as ONE call.

    Counts and overflow are summed; collected matches are concatenated
    (each plan's matches are disjoint by Theorem 5). The caller reads the
    sums back in one device->host copy.
    """
    runs = [build_sbenu_enumerator(p, sentinel, c,
                                   collect_matches=collect_matches,
                                   intersect_impl=intersect_impl,
                                   compaction=compaction)
            for p, c in zip(plans, caps_list)]

    def run(snap: DeviceSnapshot, starts: torch.Tensor,
            starts_valid: torch.Tensor) -> SBenuEnumResult:
        snap = device_put_snapshot(snap, starts.device)
        rs = [r(snap, starts, starts_valid) for r in runs]
        matches = match_ops = matches_valid = None
        if collect_matches:
            matches = torch.cat([r.matches for r in rs], dim=0)
            match_ops = torch.cat([r.match_ops for r in rs], dim=0)
            matches_valid = torch.cat([r.matches_valid for r in rs], dim=0)
        return SBenuEnumResult(
            count_plus=sum(r.count_plus for r in rs),
            count_minus=sum(r.count_minus for r in rs),
            overflow=sum(r.overflow for r in rs),
            level_sizes=tuple(s for r in rs for s in r.level_sizes),
            matches=matches, match_ops=match_ops,
            matches_valid=matches_valid)

    return run
