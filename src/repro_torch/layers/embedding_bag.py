"""EmbeddingBag: multi-hot gather-reduce over large sparse tables.

Counterpart of ``repro/layers/embedding_bag.py``, with its names and
semantics: ids are clipped to the table (an id past either end reads the
first or the last row), a ``pad_id`` reads as a zero row, and bags are
reduced by sum, mean (over the non-pad ids, at least one) or max (pads
excluded; an empty bag is 0). The reference's ``jnp.take`` +
``jax.ops.segment_sum`` become a row gather and ``index_add_`` (max:
``scatter_reduce_`` with ``amax``); the fixed-width bags of BST's user
profile reduce over a dense axis, with no scatter at all.
"""

from __future__ import annotations

from typing import Optional

import torch


def embedding_lookup(table: torch.Tensor, ids: torch.Tensor,
                     pad_id: Optional[int] = None) -> torch.Tensor:
    """Row gather ``table[clip(ids)]`` -> ``[*ids.shape, dim]``; with
    ``pad_id`` the rows of that id are zero."""
    out = table[ids.long().clamp(0, table.shape[0] - 1)]
    if pad_id is not None:
        out = torch.where((ids == pad_id)[..., None], 0.0, out)
    return out


def embedding_bag(table: torch.Tensor, ids: torch.Tensor,
                  segment_ids: torch.Tensor, num_segments: int,
                  mode: str = "sum", pad_id: Optional[int] = None,
                  weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Ragged bag-reduce: rows ``table[ids]`` (times ``weights``) reduced
    per ``segment_ids``. ids, segment_ids: int [L] (flattened ragged bags);
    returns ``[num_segments, dim]``. ``mode``: sum | mean | max."""
    rows = embedding_lookup(table, ids, pad_id=pad_id)
    if weights is not None:
        rows = rows * weights[..., None]
    seg = segment_ids.long()
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
                        mode: str = "mean",
                        pad_id: Optional[int] = None) -> torch.Tensor:
    """Dense-rectangular bags: ids ``[B, L]`` -> ``[B, dim]``, the sum
    (``mode="sum"``) or else the mean over the non-pad ids."""
    rows = embedding_lookup(table, ids, pad_id=pad_id)       # [B, L, d]
    s = rows.sum(dim=1)
    if mode == "sum":
        return s
    valid = torch.ones(ids.shape, dtype=torch.float32, device=ids.device) \
        if pad_id is None else (ids != pad_id).float()
    return s / valid.sum(dim=1).clamp(min=1.0)[..., None]
