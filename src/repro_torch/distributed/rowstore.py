"""The paper's distributed KV row store over torch.distributed.

Counterpart of ``repro/distributed/rowstore.py``. The padded adjacency
rows are block-partitioned over the ranks of a process group (one process
per shard: NCCL between cards, gloo between CPU processes), and a DBQ
over a batch of vertex ids is a **batched request/response exchange**:

    1. dedup the local id batch into exactly ``B`` sorted slots padded
       with the sentinel (sort, mark the first of each run, compact) —
       the vectorized analogue of the paper's per-task DB cache: within
       a frontier level each distinct row crosses the wire at most once;
    2. route ids to their owner shard (block partition: owner =
       id // rps) through one ``all_to_all_single`` of an ``[S, R]``
       request matrix (R = the static per-peer capacity);
    3. owners gather their local rows and send the ``[S, R, D]``
       responses back through a second ``all_to_all_single``.

Communication per level scales with the distinct cold ids times the row
bytes, never with the partial matches.

**Hot-row replication**: vertices are relabeled by ascending degree at
load time, so ids ``>= n - hot`` are the highest-degree vertices. Their
rows are replicated on every rank and served locally, which removes both
the traffic and the skew a hub vertex puts on its owner shard.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..graph.storage import Graph, padded_width


@dataclass
class RowStoreSpec:
    """Static layout of a distributed row store."""

    n: int                 # real vertices; sentinel value
    d: int                 # padded row width
    n_shards: int
    rows_per_shard: int    # ceil((n+1) / n_shards), block partition
    hot: int = 0           # top-`hot` ids replicated everywhere
    req_cap: int = 0       # per-peer request capacity R (0 = B)

    @property
    def n_padded(self) -> int:
        return self.n_shards * self.rows_per_shard


def build_row_shards(graph: Graph, n_shards: int, rank: int, hot: int = 0,
                     lane: int = 128, d_max: Optional[int] = None,
                     device=None
                     ) -> Tuple[torch.Tensor, torch.Tensor, RowStoreSpec]:
    """``(local_shard [rps, D], hot_rows [hot+1, D], spec)`` of ``rank``.

    Row ``n`` (the sentinel row, all holes) and the padding rows past it
    are stored like any other row, so gathers with invalid ids round-trip
    safely. Only this rank's block and the replicated top-``hot`` rows
    (plus the sentinel row) are built, each once on the host, and put on
    ``device``: no process holds the whole padded store.
    """
    n = graph.n
    d = padded_width(int(graph.deg.max()) if n else 0, d_max=d_max,
                     lane=lane, strict=True)
    rps = -(-(n + 1) // n_shards)
    hot = min(hot, n)

    def rows_for(lo: int, count: int) -> torch.Tensor:
        block = np.full((count, d), n, np.int32)
        for v in range(lo, min(lo + count, n)):
            a = graph.adj[v]
            block[v - lo, :len(a)] = a
        return torch.from_numpy(block).to(device)

    local = rows_for(rank * rps, rps)
    # relabeling is ascending-degree, so the hot set is ids [n-hot, n]
    hot_rows = rows_for(n - hot, hot + 1)
    spec = RowStoreSpec(n=n, d=d, n_shards=n_shards, rows_per_shard=rps,
                        hot=hot)
    return local, hot_rows, spec


def dedup_fixed(ids: torch.Tensor, sentinel: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(uids, inv)``: the sorted distinct values of ``ids`` in exactly
    ``len(ids)`` slots, padded with ``sentinel`` (the largest id, so the
    padding stays at the end), and each id's slot in ``uids``."""
    srt = torch.sort(ids).values
    first = torch.ones_like(srt, dtype=torch.bool)
    first[1:] = srt[1:] != srt[:-1]
    pos = torch.cumsum(first, 0) - 1
    uids = torch.full_like(srt, sentinel)
    # every member of a run writes the same value into the run's slot
    uids.scatter_(0, pos, srt)
    return uids, torch.searchsorted(uids, ids)


def make_distributed_fetch(spec, group, req_cap: int):
    """Build ``fetch(ids, local_shard, hot_rows) -> (rows, n_cold, drops)``
    for this rank of ``group``.

    ``req_cap`` (R) is the static per-peer request budget. ``drops``
    counts requests beyond R (the driver treats drops > 0 like frontier
    overflow and retries with a larger R). Every rank must call the fetch
    the same number of times with the same ``B``: each call is two
    collectives.

    ``spec`` is duck-typed (``n`` / ``n_shards`` / ``rows_per_shard`` /
    ``hot``): the row width comes from ``local_shard`` at call time, so one
    fetch serves stores of any width sharing a layout — the streaming
    engine reuses it for all six snapshot blocks
    (:class:`~repro_torch.graph.dynamic.SnapshotShardSpec`).
    """
    S = spec.n_shards
    rps = spec.rows_per_shard
    sent = spec.n
    hot_lo = spec.n - spec.hot  # ids >= hot_lo are replicated
    rank = dist.get_rank(group)
    R = req_cap

    def fetch(ids: torch.Tensor, local_shard: torch.Tensor,
              hot_rows: torch.Tensor):
        B = ids.shape[0]
        dev = ids.device
        is_hot = ids >= hot_lo                    # includes sentinel ids
        uids, inv = dedup_fixed(ids.masked_fill(is_hot, sent), sent)
        owner = (uids // rps).clamp(0, S - 1).long()
        # slot of each unique id within its owner group (owners ascend)
        slot = torch.arange(B, device=dev) - torch.searchsorted(owner, owner)
        want = uids != sent
        ok = want & (slot < R)
        drops = (want & ~ok).sum()
        n_cold = want.sum()
        # -- request matrix [S, R]; refused requests land in slot S*R
        src = owner * R + slot
        reqs = torch.full((S * R + 1,), sent, dtype=ids.dtype, device=dev)
        reqs.scatter_(0, src.masked_fill(~ok, S * R), uids)
        reqs = reqs[:S * R]
        recv = torch.empty_like(reqs)
        dist.all_to_all_single(recv, reqs, group=group)   # ids to serve
        # -- serve from the local block
        lid = recv - rank * rps
        lval = (lid >= 0) & (lid < rps) & (recv != sent)
        lrows = local_shard.index_select(0, lid.clamp(0, rps - 1))
        lrows.masked_fill_(~lval[:, None], sent)          # [S*R, D]
        # -- route responses back (same slots)
        resp = torch.empty_like(lrows)
        dist.all_to_all_single(resp, lrows, group=group)
        # -- un-dedup straight from the response rows
        out = resp.index_select(0, src.clamp(0, S * R - 1)[inv])
        out.masked_fill_(~ok[inv][:, None], sent)
        if spec.hot:                              # hot rows served locally
            hidx = (ids - hot_lo).clamp(0, hot_rows.shape[0] - 1)
            out = torch.where(is_hot[:, None], hot_rows.index_select(0, hidx),
                              out)
        out.masked_fill_((ids >= sent)[:, None], sent)
        return out, n_cold, drops

    return fetch
