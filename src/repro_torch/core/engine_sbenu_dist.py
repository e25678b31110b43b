"""Distributed S-BENU over torch.distributed: one process per shard.

Counterpart of ``repro/core/engine_sbenu_dist.py``. ``engine_dist`` maps
the paper's static deployment (Fig. 7) onto a process group; this module
does the same for the *streaming* half (§5, Alg. 4). The six-block dual
snapshot of :mod:`repro_torch.graph.dynamic` is row-block partitioned
over the ranks (owner of vertex v's rows = ``v // rows_per_shard``)
exactly the way ``DistBackend`` shards static adjacency rows, with the
``hot`` highest-id rows of every block replicated:

    worker machine         -> one rank (NCCL between cards, gloo between
                              CPU processes)
    two-form vertex value  -> the rank's rows of all six blocks
                              (prev/cur/delta x out/in), resident across
                              time steps (graph/dynamic.py
                              ShardedDeviceSnapshotStore)
    typed on-demand DBQ    -> batched request/response all_to_all_single
                              against the owning rank of the addressed
                              block; the flagged delta row moves as ONE
                              joint (values ++ signs) exchange
    LRU DB cache           -> per-level id dedup + replicated hot rows
    ΔR_t^± result sets     -> per-rank counts (and optionally match rows),
                              gathered to every rank by the backend
    skew / stragglers      -> the same round-robin frontier rebalancer as
                              the static engine, after every Delta-ENU /
                              ENU expansion

Communication happens only at typed-DBQ boundaries (plus the opt-in
rebalance exchange and the backend's final gathers): frontier expansion,
INS probes and intersections are rank-local. The instruction loop is
:func:`~repro_torch.core.engine_sbenu_torch.build_sbenu_instr_runner`;
only the three gathers behind the typed-DBQ selector differ.
"""

from __future__ import annotations

from typing import Callable, List, Sequence, Tuple

import torch

from ..distributed.rowstore import make_distributed_fetch
from ..graph.dynamic import SnapshotShardSpec
from .engine_dist import _rebalancer
from .engine_sbenu_torch import (FlaggedRows, _resolve_intersect_impl,
                                 _resort_fn, build_sbenu_instr_runner,
                                 make_typed_fetch)
from .instructions import Plan

#: positional order of the rank's value blocks / their replicated hot
#: slices in the step signature (the keys of
#: ShardedDeviceSnapshotStore.step_sharded())
BLOCK_ORDER = ("prev_out", "cur_out", "prev_in", "cur_in",
               "delta_joint_out", "delta_joint_in")


def build_sbenu_dist_step(plans: Sequence[Plan], sentinel: int,
                          spec: SnapshotShardSpec, group,
                          caps_list: Sequence[Sequence[int]], req_cap: int,
                          rebalance: bool = False,
                          collect_matches: bool = False,
                          intersect_impl: str = "auto",
                          compaction: str = "cumsum") -> Callable:
    """This rank's streaming enumeration step, all ΔP_i plans in one call.

    Returns ``step(*blocks, *hot_blocks, starts, starts_valid)`` (block
    order :data:`BLOCK_ORDER`; ``starts``/``starts_valid`` the rank's
    ``[B/S]`` slice of the global batch) producing this rank's
    ``(count_plus, count_minus, overflow, cold, drops, level_sizes)``
    plus, when ``collect_matches``, ``(matches [M, n], match_ops [M],
    matches_valid [M])`` where M sums the last-level capacities over
    plans.

    ``caps_list[i]`` are the *per-rank* frontier capacities of plan i;
    with ``rebalance`` they must be divisible by the number of ranks (the
    driver's ``cap_multiple`` contract).
    """
    post = _rebalancer(group, spec.n_shards) if rebalance else None
    runners = [build_sbenu_instr_runner(p, sentinel, c,
                                        collect_matches=collect_matches,
                                        intersect_impl=intersect_impl,
                                        compaction=compaction,
                                        post_expand=post)
               for p, c in zip(plans, caps_list)]
    row_fetch = make_distributed_fetch(spec, group, req_cap)

    def step(prev_out, cur_out, prev_in, cur_in, dj_out, dj_in,
             h_prev_out, h_cur_out, h_prev_in, h_cur_in, h_dj_out,
             h_dj_in, starts, starts_valid):
        fetch_stats: List[Tuple[torch.Tensor, torch.Tensor]] = []

        def served(local: torch.Tensor, hot: torch.Tensor,
                   ids: torch.Tensor) -> torch.Tensor:
            rows, n_cold, drops = row_fetch(ids, local, hot)
            fetch_stats.append((n_cold, drops))
            return rows

        prev = {"out": (prev_out, h_prev_out), "in": (prev_in, h_prev_in)}
        cur = {"out": (cur_out, h_cur_out), "in": (cur_in, h_cur_in)}
        dj = {"out": (dj_out, h_dj_out), "in": (dj_in, h_dj_in)}

        def gather_prev(di: str, ids: torch.Tensor) -> torch.Tensor:
            return served(*prev[di], ids)

        def gather_cur(di: str, ids: torch.Tensor) -> torch.Tensor:
            return served(*cur[di], ids)

        def gather_delta(di: str, ids: torch.Tensor) -> FlaggedRows:
            joint = served(*dj[di], ids)
            dd = joint.shape[1] // 2
            vals = joint[:, :dd].contiguous()
            # rows the fetch filled whole (invalid/hot-miss/dropped ids)
            # carry the sentinel in the sign half too; flag holes are 0
            return vals, joint[:, dd:].masked_fill(vals == sentinel, 0)

        resort = _resort_fn(_resolve_intersect_impl(
            intersect_impl, starts.device.type) == "binary")
        fetch = make_typed_fetch(sentinel, resort, gather_prev, gather_cur,
                                 gather_delta)
        rs = [r(fetch, starts, starts_valid) for r in runners]
        zero = torch.zeros((), dtype=torch.int64, device=starts.device)
        outs = (sum((r.count_plus for r in rs), zero),
                sum((r.count_minus for r in rs), zero),
                sum((r.overflow for r in rs), zero),
                sum((c for c, _ in fetch_stats), zero),
                sum((d for _, d in fetch_stats), zero),
                tuple(s for r in rs for s in r.level_sizes))
        if collect_matches:
            outs += (torch.cat([r.matches for r in rs], dim=0),
                     torch.cat([r.match_ops for r in rs], dim=0),
                     torch.cat([r.matches_valid for r in rs], dim=0))
        return outs

    return step
