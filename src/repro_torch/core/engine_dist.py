"""Distributed BENU over torch.distributed: one process per shard.

Counterpart of ``repro/core/engine_dist.py``. The paper's deployment
(Fig. 7) is: data graph in a distributed KV store; local search tasks
fanned out over workers; tasks query the store on demand. The mapping:

    worker machine      -> one rank of a process group (NCCL between
                           cards, gloo between CPU processes)
    HBase region        -> the rank's block of DistributedRowStore rows
    task queue          -> the rank's slice of every global start batch
    on-demand DBQ       -> batched request/response all_to_all_single
                           (see distributed/rowstore.py)
    LRU DB cache        -> per-level id dedup + replicated hot rows
    task splitting      -> fixed frontier capacities + overflow retries
    skew / stragglers   -> opt-in frontier **rebalancing**: after each ENU
                           the compacted child frontier is striped
                           round-robin over the ranks with one
                           all_to_all_single per frontier column, so the
                           per-rank load equalizes to ±S rows.

Every rank runs the same instruction schedule on the same shapes
(lockstep SPMD), so the collectives match up: there is no
data-dependent branch between two collectives. The driver's decisions
(split, escalate) come from a chunk result gathered to every rank, so
every rank takes the same one.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..distributed.rowstore import RowStoreSpec, make_distributed_fetch
from ..graph.storage import Graph
from .engine_torch import build_enumerator, check_jit_supported
from .instructions import Plan


def enumeration_mesh(group=None):
    """The process group the engines run over: ``group``, or the default
    (world) group the caller initialised. Raises when no process group is
    initialised — a world of one is never made behind the caller's back."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "no torch.distributed process group is initialised: call "
            "torch.distributed.init_process_group first (NCCL with one card "
            "a rank, or gloo with device='cpu')")
    return group if group is not None else dist.group.WORLD


def check_group_device(group, device: torch.device) -> None:
    """The group's backend must carry tensors of ``device``: NCCL for
    CUDA tensors, gloo for CPU tensors. Anything else raises."""
    backend = str(dist.get_backend(group))
    want = {"cuda": "nccl", "cpu": "gloo"}.get(device.type)
    if want is None or want not in backend:
        raise ValueError(f"a {backend!r} process group cannot carry "
                         f"{device.type} tensors (NCCL carries CUDA "
                         "tensors, gloo CPU tensors)")


def rank_device(group, device=None) -> torch.device:
    """This rank's device: ``device``, or ``cuda:<local rank>`` (one card
    a rank), checked against the group's backend."""
    if device is None or torch.device(device) == torch.device("cuda"):
        n_cards = torch.cuda.device_count()
        if n_cards == 0:
            raise RuntimeError("no CUDA device is available; pass "
                               "device='cpu' with a gloo process group")
        local = int(os.environ.get("LOCAL_RANK",
                                   dist.get_rank(group) % n_cards))
        device = torch.device("cuda", local)
    device = torch.device(device)
    check_group_device(group, device)
    return device


@dataclass
class DistEnumStats:
    count: int
    per_shard_counts: np.ndarray
    per_shard_level_sizes: np.ndarray      # [levels, S]
    cold_rows_fetched: int                 # distinct rows that crossed wire
    request_drops: int
    overflow: int
    chunks_retried: int


def _rebalancer(group, n_shards: int):
    """Round-robin stripe exchange: child i -> shard (i mod S)."""

    def shuf(x: torch.Tensor) -> torch.Tensor:
        # true round-robin: child i -> shard (i mod S); a compacted
        # (valid-first) frontier therefore spreads evenly
        cap = x.shape[0]
        w = cap // n_shards
        xs = x.reshape((w, n_shards) + x.shape[1:]).transpose(0, 1)
        xs = xs.contiguous()
        out = torch.empty_like(xs)
        dist.all_to_all_single(out, xs, group=group)
        return out.transpose(0, 1).reshape(x.shape)

    def post_expand(env: Dict, valid: torch.Tensor):
        assert valid.shape[0] % n_shards == 0, \
            "cap must be divisible by the number of ranks"
        return {k: shuf(v) for k, v in env.items()}, shuf(valid)

    return post_expand


def build_distributed_step(plan: Plan,
                           spec: RowStoreSpec,
                           group,
                           caps: Sequence[int],
                           req_cap: int,
                           rebalance: bool = False,
                           intersect_impl: str = "auto",
                           compaction: str = "cumsum") -> Callable:
    """This rank's enumeration step.

    Returns ``step(local_shard, hot_rows, starts, starts_valid[, uni]) ->
    (count, overflow, cold, drops, level_sizes)``, tensors on the rank's
    device: ``local_shard`` int32[rps, D] is the rank's block of rows,
    ``hot_rows`` the replicated ``[hot+1, D]`` rows, ``starts`` /
    ``starts_valid`` the rank's ``[B/S]`` slice of the global batch and
    ``uni`` the (replicated) universe chunk of detached-vertex plans.
    This is the port's ``build_enumerator`` with the distributed fetch
    (never fused: rows arrive by all_to_all) and the rebalancer hook.
    """
    has_universe = check_jit_supported(plan)
    dist_fetch = make_distributed_fetch(spec, group, req_cap)
    post = _rebalancer(group, spec.n_shards) if rebalance else None

    def step(local_shard, hot_rows, starts, starts_valid, uni=None):
        fetch_stats: List[Tuple[torch.Tensor, torch.Tensor]] = []

        def fetch(ids: torch.Tensor) -> torch.Tensor:
            rows, n_cold, drops = dist_fetch(ids, local_shard, hot_rows)
            fetch_stats.append((n_cold, drops))
            return rows

        run = build_enumerator(plan, spec.n, caps, fetch,
                               intersect_impl=intersect_impl,
                               post_expand=post, compaction=compaction)
        res = run(starts, starts_valid, uni) if has_universe else \
            run(starts, starts_valid)
        zero = torch.zeros((), dtype=torch.int64, device=starts.device)
        cold = sum((c for c, _ in fetch_stats), zero)
        drops = sum((d for _, d in fetch_stats), zero)
        return res.count, res.overflow, cold, drops, res.level_sizes

    return step


def enumerate_distributed(plan: Plan, graph: Graph, group=None,
                          batch_per_shard: int = 64,
                          caps: Optional[Sequence[int]] = None,
                          req_cap: Optional[int] = None,
                          hot: int = 0,
                          rebalance: bool = False,
                          universe_chunk: int = 1024,
                          intersect_impl: str = "auto",
                          max_retries: int = 6,
                          adaptive_split: bool = True,
                          device=None) -> DistEnumStats:
    """Enumerate ``plan`` over ``graph`` on every rank of ``group`` (the
    initialised world by default). Every rank calls this with the same
    arguments and gets the same result.

    Thin wrapper over the unified Executor API (core/executor.py): the
    shared adaptive driver re-chunks overflowing global batches (keeping
    rank-divisible shapes) before escalating capacities / request
    budgets — exact in all cases. ``cold_rows_fetched`` is the paper's
    "network communication cost" metric for Fig. 10-style experiments.
    """
    from .executor import DistBackend, ExecutorConfig, drive
    group = enumeration_mesh(group)
    S = dist.get_world_size(group)
    backend = DistBackend(group=group, hot=hot, rebalance=rebalance,
                          req_cap=req_cap, device=device)
    cfg = ExecutorConfig(batch=S * batch_per_shard, caps=caps,
                         universe_chunk=universe_chunk,
                         intersect_impl=intersect_impl,
                         max_retries=max_retries,
                         adaptive_split=adaptive_split)
    st = drive(backend, plan, graph, cfg)
    return DistEnumStats(
        count=st.count,
        per_shard_counts=st.extras["per_shard_counts"],
        per_shard_level_sizes=st.extras["per_shard_level_sizes"],
        cold_rows_fetched=st.extras["cold_rows_fetched"],
        request_drops=st.drops_seen,
        overflow=0, chunks_retried=st.chunks_retried + st.chunks_split)
