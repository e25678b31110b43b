"""EmbeddingBag: multi-hot gather-reduce over large sparse tables.

Counterpart of ``repro/layers/embedding_bag.py``, with its names and
semantics: ids are clipped to the table (an id past either end reads the
first or the last row), a ``pad_id`` reads as a zero row, a row whose
segment id lies outside ``[0, num_segments)`` is dropped (as
``jax.ops.segment_*`` drops it), and bags are reduced by sum, mean (over
the non-pad ids, at least one) or max (pads excluded; an empty bag is
0). The reference's ``jnp.take`` +
``jax.ops.segment_sum`` become a row gather and ``index_add_`` (max:
``scatter_reduce_`` with ``amax``); the fixed-width bags of BST's user
profile reduce over a dense axis, with no scatter at all.
"""

from __future__ import annotations

from typing import Optional

import torch

from .common import NO_SHARD, ShardCtx


def embedding_lookup(table: torch.Tensor, ids: torch.Tensor,
                     pad_id: Optional[int] = None) -> torch.Tensor:
    """Row gather ``table[clip(ids)]`` -> ``[*ids.shape, dim]``; with
    ``pad_id`` the rows of that id are zero."""
    ids_c = ids.long().clamp(0, table.shape[0] - 1)
    out = lookup_sharded(table, ids_c) \
        if type(table).__name__ == "DTensor" else table[ids_c]
    if pad_id is not None:
        out = torch.where((ids == pad_id)[..., None], 0.0, out)
    return out


def lookup_sharded(table, ids):
    """``table[ids]`` for a DTensor table whose rows may be sharded (a
    dry-run's row-sharded tables): each rank reads the ids that fall in
    its block of rows, zeros elsewhere, and the result is a partial sum
    over the mesh dims that shard the rows (vocab-parallel embedding).
    The ids are gathered over those dims and keep their layout over the
    others."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh = table.device_mesh
    rows = {i for i, p in enumerate(table.placements)
            if isinstance(p, Shard) and p.dim == 0}
    ids_pl = [Replicate() if i in rows or p.is_partial() else p
              for i, p in enumerate(ids.placements)]
    # the local table's gradient: its block of rows, a partial sum over
    # the mesh dims whose ranks read other ids
    tab = table.redistribute(mesh, [p if i in rows else Replicate()
                                    for i, p in enumerate(table.placements)]
                             ).to_local(grad_placements=[
                                 Shard(0) if i in rows else
                                 Partial() if isinstance(p, Shard) else
                                 Replicate() for i, p in enumerate(ids_pl)])
    idx = ids.redistribute(mesh, ids_pl).to_local()
    # this rank's first row: its coordinate along the row-sharding dims
    coord, first, n_loc = mesh.get_coordinate(), 0, tab.shape[0]
    for i in sorted(rows):
        first = first * mesh.shape[i] + coord[i]
    idx = idx - first * n_loc
    hit = (idx >= 0) & (idx < n_loc)
    out = tab[idx.clamp(0, n_loc - 1)] * hit[..., None].to(tab.dtype)
    return DTensor.from_local(out, mesh, [Partial() if i in rows else p
                                          for i, p in enumerate(ids_pl)],
                              run_check=False)


def embedding_bag(table: torch.Tensor, ids: torch.Tensor,
                  segment_ids: torch.Tensor, num_segments: int,
                  mode: str = "sum", pad_id: Optional[int] = None,
                  weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Ragged bag-reduce: rows ``table[ids]`` (times ``weights``) reduced
    per ``segment_ids``. ids, segment_ids: int [L] (flattened ragged bags);
    returns ``[num_segments, dim]``. ``mode``: sum | mean | max. Rows
    whose segment id is outside ``[0, num_segments)`` are dropped before
    the scatter."""
    seg = segment_ids.long()
    keep = (seg >= 0) & (seg < num_segments)
    ids, seg = ids[keep], seg[keep]
    if weights is not None:
        weights = weights[keep]
    rows = embedding_lookup(table, ids, pad_id=pad_id)
    if weights is not None:
        rows = rows * weights[..., None]
    d = rows.shape[-1]
    if mode == "max":
        if pad_id is not None:
            rows = torch.where((ids == pad_id)[..., None], -torch.inf, rows)
        out = torch.full((num_segments, d), -torch.inf, dtype=rows.dtype,
                         device=rows.device)
        out.scatter_reduce_(0, seg[:, None].expand(-1, d), rows, "amax")
        return torch.where(torch.isfinite(out), out, 0.0)
    out = torch.zeros((num_segments, d), dtype=rows.dtype,
                      device=rows.device).index_add_(0, seg, rows)
    if mode == "mean":
        valid = torch.ones(ids.shape, dtype=torch.float32, device=ids.device)
        if pad_id is not None:
            valid = torch.where(ids == pad_id, 0.0, valid)
        cnt = torch.zeros(num_segments, dtype=torch.float32,
                          device=ids.device).index_add_(0, seg, valid)
        out = out / cnt.clamp(min=1.0)[..., None]
    return out


def embedding_bag_fixed(table: torch.Tensor, ids: torch.Tensor,
                        mode: str = "mean", pad_id: Optional[int] = None,
                        ctx: ShardCtx = NO_SHARD) -> torch.Tensor:
    """Dense-rectangular bags: ids ``[B, L]`` -> ``[B, dim]``, the sum
    (``mode="sum"``) or else the mean over the non-pad ids. Under a mesh
    the looked-up rows (a partial sum over the ranks that split the
    table's rows) are summed once, laid over ``ctx.dp``, and the bags
    reduced on whole rows."""
    if ctx.mesh is not None and type(table).__name__ == "DTensor":
        rows = ctx.shard(embedding_lookup(table, ids), ctx.dp, None, None)
        if pad_id is not None:
            rows = torch.where((ids == pad_id)[..., None], 0.0, rows)
    else:
        rows = embedding_lookup(table, ids, pad_id=pad_id)   # [B, L, d]
    s = rows.sum(dim=1)
    if mode == "sum":
        return s
    valid = torch.ones(ids.shape, dtype=torch.float32, device=ids.device) \
        if pad_id is None else (ids != pad_id).float()
    return s / valid.sum(dim=1).clamp(min=1.0)[..., None]
