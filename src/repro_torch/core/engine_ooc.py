"""Out-of-core executor: the frontier engine behind a row cache (§6).

Counterpart of ``repro/core/engine_ooc.py``. ``engine_torch`` gathers
adjacency rows from a device-resident ``[N+1, D]`` matrix, which caps the
data graph at the card's memory. This module runs the same plan as a
**pull** program, the paper's §6 implementation model vectorized:

* the padded adjacency lives in host-RAM shards
  (:class:`~repro_torch.graph.hoststore.HostRowStore`); device memory holds
  only a bounded row cache
  (:class:`~repro_torch.distributed.rowcache.DeviceRowCache`: pinned
  hot-by-degree rows + an LRU slab);
* the plan is split into **segments at DBQ boundaries**. Everything
  between two DBQs (INT / TRC / ENU / RES) runs eagerly as one plain
  function; at each boundary the frontier's id column comes to the host
  (one ``.cpu()``, which also carries the running overflow so an
  overflowing chunk stops there), the cache dedups it and gathers only
  the *cold* rows from the host shards. Communication (PCIe here, network
  in the paper) therefore scales with distinct cold rows per level, never
  with partial matches;
* results equal ``engine_torch``'s: the segments run the same primitives
  (``_expand``, ``_apply_filters``, ``_vcbc_row_counts``) on the same
  schedule, and the cache serves exact rows at any capacity.

The reference compiles each segment with ``jax.jit``; the port has
nothing to compile. The executor backend (``core/executor.py``,
``oocache``) hides part of the per-level host sync by prefetching the next
chunk's start rows while the current chunk computes.

Intersections go through :func:`repro_torch.kernels.ops.intersect_padded`
(the hand-written ``sorted_intersect`` on a CUDA tensor). The fused
gather+intersect does not apply here: rows arrive through the host cache,
not a device-resident adjacency, so there is no device gather to fuse
away — the cache's per-level dedup plays the equivalent bytes-saving role
on the PCIe boundary. Counts are int64.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..distributed.rowcache import DeviceRowCache
from ..kernels import ops as kops
from .engine_torch import (_apply_filters, _expand, _liveness,
                           _vcbc_row_counts, check_jit_supported)
from .instructions import DBQ, ENU, INI, INT, RES, TRC, Instr, Plan, Var

#: one plan segment: (dbq heading the segment or None, [(instr, plan index)],
#: dbq level tag, index of the segment's first ENU within the plan's ENUs)
Segment = Tuple[Optional[Instr], List[Tuple[Instr, int]], int, int]


class OocChunk(NamedTuple):
    """One chunk's result, as host values. The first four fields are the
    reference's ``run_chunk`` tuple."""

    count: int
    overflow: int
    matches: Optional[np.ndarray]          # int32[k, n] valid rows
    matches_valid: Optional[np.ndarray]    # bool[cap] of the RES frontier
    level_sizes: Optional[List[int]]       # occupancy after each ENU


def split_segments(plan: Plan) -> List[Segment]:
    """Cut ``plan.instrs`` at every DBQ (each cut = one host round-trip)."""
    segs: List[Segment] = []
    head: Optional[Instr] = None
    body: List[Tuple[Instr, int]] = []
    level = -1
    n_levels = 0
    enu_base = 0
    enu_seen = 0
    for ip, ins in enumerate(plan.instrs):
        if ins.op == DBQ:
            segs.append((head, body, level, enu_base))
            head, body = ins, []
            level = n_levels
            n_levels += 1
            enu_base = enu_seen
        else:
            body.append((ins, ip))
            enu_seen += ins.op == ENU
    segs.append((head, body, level, enu_base))
    return segs


class OocEngine:
    """Execute one BENU plan with all row fetches pulled through ``cache``.

    Shapes follow ``engine_torch``: frontiers are ``[B]`` (or ``[cap]``)
    columns of int32 vertex ids (``sentinel = N`` marks holes), adjacency
    sets are ``[B, D]`` padded rows on the cache's device. ``caps[i]``
    bounds the i-th ENU's child frontier; overflow > 0 invalidates the
    chunk (the driver re-splits it).
    """

    def __init__(self, plan: Plan, cache: DeviceRowCache,
                 collect_matches: bool = False,
                 intersect_impl: str = "auto",
                 compaction: str = "cumsum"):
        self.plan = plan
        self.cache = cache
        self.sentinel = cache.n
        self.has_universe = check_jit_supported(plan)
        if collect_matches and plan.vcbc:
            raise ValueError("cannot collect raw matches from a VCBC plan")
        self._collect = collect_matches
        self._intersect = intersect_impl
        self._compaction = compaction
        self._live = _liveness(plan, collect_matches)
        self.segments = split_segments(plan)

    # ------------------------------------------------------------ segments
    def _segment(self, k: int, caps: Tuple[int, ...],
                 env: Dict[Var, torch.Tensor], st: Dict[str, object],
                 starts: torch.Tensor,
                 universe_chunk: Optional[torch.Tensor]) -> None:
        """Run segment ``k``'s body on ``env`` and the chunk state ``st``
        (valid, count, overflow, level_sizes, matches) in place."""
        _, body, _, enu_i = self.segments[k]
        plan, sentinel = self.plan, self.sentinel

        def isect(a, b):
            return kops.intersect_padded(a, b, sentinel,
                                         impl=self._intersect)

        for ins, ip in body:
            valid = st["valid"]
            if ins.op == INI:
                env[ins.target] = starts.masked_fill(~valid, sentinel)
            elif ins.op in (INT, TRC):
                if ins.op == TRC:
                    sets = [env[ins.operands[2]], env[ins.operands[3]]]
                else:
                    sets = []
                    for v in ins.operands:
                        if v[0] == "VG":
                            sets.append(universe_chunk[None, :].expand(
                                valid.shape[0],
                                universe_chunk.shape[0]).contiguous())
                        else:
                            sets.append(env[v])
                res = sets[0]
                for other in sets[1:]:
                    res = isect(res, other)
                if ins.filters:
                    res = _apply_filters(res, ins.filters, env, sentinel)
                env[ins.target] = res
            elif ins.op == ENU:
                cand = env[ins.operands[0]]
                new_env, valid, ov = _expand(
                    env, valid, cand, ins.target, caps[enu_i],
                    self._live[ip + 1], sentinel,
                    compaction=self._compaction)
                if ins.target not in self._live[ip + 1]:
                    del new_env[ins.target]     # read by no later instruction
                env.clear()
                env.update(new_env)
                st["valid"] = valid
                st["overflow"] = st["overflow"] + ov
                st["level_sizes"].append(valid.sum())
                enu_i += 1
            elif ins.op == RES:
                if plan.vcbc:
                    st["count"] = st["count"] + _vcbc_row_counts(
                        plan, env, valid, sentinel, ins.report).sum()
                else:
                    st["count"] = st["count"] + valid.sum()
                    if self._collect:
                        st["matches"] = torch.stack(
                            [env[v] for v in ins.report], dim=1)
                        st["matches_valid"] = valid

    # ----------------------------------------------------------- execution
    def run_chunk(self, starts: np.ndarray, starts_valid: np.ndarray,
                  universe_chunk: Optional[np.ndarray],
                  caps: Sequence[int]) -> OocChunk:
        """One fixed-shape chunk; returns an :class:`OocChunk` of host ints
        and numpy arrays.

        Each segment boundary costs one device->host sync (the frontier's
        id column, with the running overflow) and at most one
        host->device block (the level's cold rows). A chunk whose running
        overflow turns non-zero stops at the next boundary: the driver
        discards its result anyway, and skipping the remaining levels
        keeps garbage rows out of the cache stats.
        """
        caps = tuple(int(c) for c in caps)
        dev = self.cache.device
        starts_t = torch.from_numpy(np.asarray(starts, np.int32)).to(dev)
        valid = torch.from_numpy(np.asarray(starts_valid, bool)).to(dev)
        uni = (torch.from_numpy(np.asarray(universe_chunk, np.int32)).to(dev)
               if universe_chunk is not None else None)
        if self.has_universe and uni is None:
            raise ValueError("plan consumes V(G): pass universe_chunk")
        zero = torch.zeros((), dtype=torch.int64, device=dev)
        st: Dict[str, object] = dict(valid=valid, count=zero, overflow=zero,
                                     level_sizes=[], matches=None,
                                     matches_valid=None)
        env: Dict[Var, torch.Tensor] = {}
        for k, (dbq, _, level, _) in enumerate(self.segments):
            if dbq is not None:
                ids = env[dbq.operands[0]]
                head = torch.cat([st["overflow"].view(1),
                                  ids.to(torch.int64)]).cpu().numpy()
                if head[0] > 0:
                    return OocChunk(0, int(head[0]), None, None, None)
                env[dbq.target] = self.cache.lookup(head[1:], level=level)
            self._segment(k, caps, env, st, starts_t, uni)
        head = torch.stack([st["count"], st["overflow"],
                            *st["level_sizes"]]).cpu().tolist()
        count, overflow, levels = head[0], head[1], head[2:]
        out_matches = mv = None
        if st["matches_valid"] is not None:
            mv = st["matches_valid"].cpu().numpy()
            if self._collect and overflow == 0:
                out_matches = st["matches"][st["matches_valid"]].cpu().numpy()
        return OocChunk(count, overflow, out_matches, mv, levels)
