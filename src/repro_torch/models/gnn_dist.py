"""Explicit 1D-distributed message passing for full-batch-large graphs.

Counterpart of ``repro/models/gnn_dist.py`` (``build_dist_loss``) over
torch.distributed, one process per shard, as ``core/engine_dist.py`` runs
the enumeration. The reference's ``("data", "model")`` mesh becomes a
:class:`Grid` of two process subgroups: rank ``r`` sits at ``(r //
n_model, r % n_model)``, as device ``r`` of a mesh of shape ``(n_data,
n_model)`` does.

Layout (the reference's):
    node tensors   block-partitioned over "model": [N/S, d] per rank,
                   replicated across "data"
    edge tensors   sharded over every rank: [E/(D*S)] per rank (rank r
                   holds shard r), global node ids

The layer bodies are ``models/gnn.py``'s; :class:`GridAggregation` gives
them the grid's gathers and reductions. Per layer each rank:
    1. all-gathers the node blocks over "model"  -> h_full [N, d]
    2. gathers h_full[src] for its edge shard and computes messages
    3. sums them by destination into a transient [N, d] partial
    4. reduce-scatters it over "model" and sums it over "data"
       -> the aggregated node block [N/S, d]
    (max and min: an all-reduce MAX / MIN over every rank, then the own
    block's slice)

Gradients flow through the collectives as ``autograd.Function``s, each
backward the transpose of its forward (all-gather <-> reduce-scatter, a
sum <-> a sum). The loss every rank returns has the global value; its
backward gives this rank's share of each parameter's gradient, and the
sum of the shares over the ranks (:func:`reduce_grads`) is the gradient
of the global loss, equal to the single-device ``gnn_loss``'s.

Max and min follow the single-device math: the backward assembles the
whole ``[N, d]`` cotangent (summed over "data", gathered over "model"),
routes it to the local messages equal to the result, and splits it by the
number of tied messages over every rank. The reference's ``_diff_preduce``
(``repro/models/gnn_dist.py:64-91``) routes only the cotangent of a
rank's own node block, so a max won by another rank's edges gets no
gradient there, and PNA's gradients over more than one device differ
from the single-device loss's (ROADMAP.md, limits of the reference).

Each process group's backend fixes its collectives: NCCL reduce-scatters
and all-gathers into one tensor; gloo, which has no reduce-scatter, sums
with an all-reduce and slices, and all-gathers into a list.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property
from typing import Callable, Dict, Mapping, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .gnn import GNN, Aggregation, GNNConfig, GraphIndex, graph_index, \
    in_degree, masked_loss_sum, node_states


@dataclass
class Grid:
    """This rank's place in the ``(n_data, n_model)`` grid and its two
    subgroups (``data``: the ranks holding the same node block; ``model``:
    the ranks sharing one data index), beside the whole ``group`` (the
    default group)."""

    n_data: int
    n_model: int
    data_index: int
    model_index: int
    group: object
    data: object
    model: object


def make_grid(n_data: int, n_model: int) -> Grid:
    """Split the default group into the grid's subgroups. Every rank
    must call it, with the same arguments:
    ``torch.distributed.new_group`` is collective."""
    world = dist.get_world_size()
    if world != n_data * n_model:
        raise ValueError(f"a ({n_data}, {n_model}) grid needs "
                         f"{n_data * n_model} ranks; the world has {world}")
    data_index, model_index = divmod(dist.get_rank(), n_model)
    mine = {}
    for a in range(n_data):
        g = dist.new_group([a * n_model + j for j in range(n_model)])
        if a == data_index:
            mine["model"] = g
    for j in range(n_model):
        g = dist.new_group([a * n_model + j for a in range(n_data)])
        if j == model_index:
            mine["data"] = g
    return Grid(n_data, n_model, data_index, model_index, dist.group.WORLD,
                **mine)


# --------------------------------------------------------------------------
# Collectives, plain and differentiable
# --------------------------------------------------------------------------


def _gloo(group) -> bool:
    return "gloo" in str(dist.get_backend(group))


def all_gather_tiled(x: torch.Tensor, group) -> torch.Tensor:
    """The group's blocks ``x [b, ...]`` stacked along dim 0, in rank
    order."""
    s = dist.get_world_size(group)
    x = x.contiguous()
    out = x.new_empty((s * x.shape[0],) + tuple(x.shape[1:]))
    if _gloo(group):
        dist.all_gather(list(out.chunk(s)), x, group=group)
    else:
        dist.all_gather_into_tensor(out, x, group=group)
    return out


def reduce_scatter_tiled(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of the group's ``x [s * b, ...]``, this rank's block
    ``[b, ...]``."""
    s = dist.get_world_size(group)
    x = x.contiguous()
    if _gloo(group):
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y.chunk(s)[dist.get_rank(group)].clone()
    out = x.new_empty((x.shape[0] // s,) + tuple(x.shape[1:]))
    dist.reduce_scatter_tensor(out, x, group=group)
    return out


def all_reduce(x: torch.Tensor, group, op=dist.ReduceOp.SUM
               ) -> torch.Tensor:
    y = x.clone()
    dist.all_reduce(y, op=op, group=group)
    return y


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_gather_tiled(x, group)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter_tiled(g, ctx.group), None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return reduce_scatter_tiled(x, group)

    @staticmethod
    def backward(ctx, g):
        return all_gather_tiled(g, ctx.group), None


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


class _SumReplicated(torch.autograd.Function):
    """A sum over the group whose result every rank holds as one
    replicated value (the loss): backward passes the cotangent through,
    so each rank differentiates its own share."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _BlockExtremum(torch.autograd.Function):
    """The max or min over every rank's ``[N, d]`` segment partial, this
    rank's node block of it. Backward: the whole cotangent, split evenly
    among the tied messages of every rank, as the single-device
    ``scatter_max`` splits it."""

    @staticmethod
    def forward(ctx, msg, seg, how, grid):
        full = all_reduce(seg.reduce(msg, how), grid.group,
                          dist.ReduceOp.MAX if how == "max"
                          else dist.ReduceOp.MIN)
        ctx.seg, ctx.grid = seg, grid
        ctx.save_for_backward(msg, full)
        nloc = full.shape[0] // grid.n_model
        return full[grid.model_index * nloc:
                    (grid.model_index + 1) * nloc].clone()

    @staticmethod
    def backward(ctx, g_blk):
        msg, full = ctx.saved_tensors
        seg, grid = ctx.seg, ctx.grid
        g = all_gather_tiled(all_reduce(g_blk.float(), grid.data),
                             grid.model)
        tie = msg == seg.gather(full)
        cnt = all_reduce(seg.reduce(tie.float(), "sum"), grid.group)
        share = seg.gather(g / cnt.clamp(min=1.0))
        return torch.where(tie, share.to(msg.dtype), 0.0), None, None, None


class GridAggregation(Aggregation):
    """The layer bodies' :class:`~repro_torch.models.gnn.Aggregation` on
    the grid: node state is this rank's block, gathered over "model"
    before the edges read it; a sum is this rank's edge shard's ``[N,
    ...]`` partial, reduce-scattered over "model" and summed over "data";
    max and min are :class:`_BlockExtremum`; the degree is summed as the
    messages are."""

    def __init__(self, ix: GraphIndex, grid: Grid):
        super().__init__(ix)
        self.grid = grid

    def nodes(self, t_blk: torch.Tensor) -> torch.Tensor:
        return _AllGather.apply(t_blk, self.grid.model)

    def sum(self, msg: torch.Tensor) -> torch.Tensor:
        return _AllReduceSum.apply(
            _ReduceScatter.apply(super().sum(msg), self.grid.model),
            self.grid.data)

    def _extremum(self, msg, how):
        return _BlockExtremum.apply(msg, self.ix.dst, how, self.grid)

    @cached_property
    def deg(self) -> torch.Tensor:
        ix, grid = self.ix, self.grid
        with torch.no_grad():
            d = in_degree(ix.dst, ix.n, ix.emask)[:, None]
            d = reduce_scatter_tiled(d, grid.model)
            return all_reduce(d, grid.data).clamp(min=1.0)


# --------------------------------------------------------------------------
# The loss
# --------------------------------------------------------------------------


def shard_batch(batch: Mapping[str, np.ndarray], grid: Grid
                ) -> Dict[str, np.ndarray]:
    """This rank's part of a global batch, as the reference's
    ``batch_spec_for`` shards it: the leaves named ``edge*`` split into
    ``n_data * n_model`` shards (this rank's), the node leaves into
    ``n_model`` blocks (its model index's)."""
    out = {}
    rank = grid.data_index * grid.n_model + grid.model_index
    for k, v in batch.items():
        parts, i = (grid.n_data * grid.n_model, rank) \
            if k.startswith("edge") else (grid.n_model, grid.model_index)
        if v.shape[0] % parts:
            raise ValueError(f"{k}{v.shape}: {v.shape[0]} rows do not split "
                             f"into {parts} equal parts")
        b = v.shape[0] // parts
        out[k] = v[i * b:(i + 1) * b]
    return out


def reduce_grads(grid: Grid) -> Callable[[Dict[str, torch.Tensor]],
                                         Dict[str, torch.Tensor]]:
    """The gradient reduction of a training step over the grid: each
    parameter's shares summed over every rank."""
    def reduce(grads):
        return {k: all_reduce(g, grid.group) for k, g in grads.items()}
    return reduce


def build_dist_loss(cfg: GNNConfig, n_total: int, grid: Grid
                    ) -> Callable[[GNN, Mapping[str, torch.Tensor]],
                                  Tuple[torch.Tensor, Dict]]:
    """``loss_fn(model, local_batch) -> (loss, {"loss"})`` over ``grid``:
    ``local_batch`` is this rank's :func:`shard_batch` of a graph of
    ``n_total`` nodes (node blocks of ``n_total / n_model`` rows; edge
    endpoints are global ids, ``n_total`` for padding); ``model`` is
    replicated. Node classification and regression (the reference's
    loss has no graph pooling)."""
    if cfg.task == "graph_class":
        raise ValueError("the distributed loss has no graph pooling "
                         "(node_class and node_reg only)")
    if n_total % grid.n_model:
        raise ValueError(f"{n_total} nodes do not split into "
                         f"{grid.n_model} blocks")

    def loss_fn(model: GNN, batch: Mapping[str, torch.Tensor]):
        ix = graph_index(batch["edge_src"], batch["edge_dst"], n_total)
        out = model.dec(node_states(model, batch, GridAggregation(ix, grid)))
        num = masked_loss_sum(out, batch, cfg.task)
        with torch.no_grad():
            den = all_reduce(batch["loss_mask"].float().sum(),
                             grid.model).clamp(min=1.0)
        # the data replicas of a block each hold the same num: a share each
        loss = _SumReplicated.apply(num / den / grid.n_data, grid.group)
        return loss, {"loss": loss}

    return loss_fn
