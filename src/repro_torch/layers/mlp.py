"""Dense FFN blocks: SwiGLU (LLaMA-style gated) MLP and the plain tower.

Counterpart of ``repro/layers/mlp.py``: :class:`SwiGLU` of
``swiglu_params`` / ``swiglu``, :class:`MLP` of ``mlp_params`` /
``mlp_apply`` (the recsys and GNN towers; EGNN's silu towers pass
``act``). Weights keep the reference's ``[in, out]`` layout (``x @ w``)
and names, so the JAX package's arrays carry across as they are.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .common import (NO_SHARD, ShardCtx, dense_init, sum_grad_over,
                     sum_partials_over, swish)


class SwiGLU(nn.Module):
    def __init__(self, d_model: int, d_ff: int, dtype: torch.dtype,
                 gen: torch.Generator):
        super().__init__()
        self.w_gate = nn.Parameter(dense_init(gen, (d_model, d_ff), dtype))
        self.w_up = nn.Parameter(dense_init(gen, (d_model, d_ff), dtype))
        self.w_down = nn.Parameter(dense_init(gen, (d_ff, d_model), dtype))

    def forward(self, x: torch.Tensor,
                ctx: ShardCtx = NO_SHARD) -> torch.Tensor:
        w = ctx.weight
        h = swish(x @ w(self.w_gate)) * (x @ w(self.w_up))
        h = ctx.shard(h, ctx.dp, None, ctx.tp)
        return ctx.shard(h @ w(self.w_down), ctx.dp, None, None)


class MLP(nn.Module):
    """Plain tower over ``sizes = [in, h1, ..., out]``: ``w{i} [a, b]``
    (LeCun-normal) and ``b{i} [b]`` (init 0), the reference's names.
    ``forward`` applies ``act`` (ReLU unless given, as the reference's
    ``mlp_apply``) after every layer but the last, and after the last too
    with ``final_act``."""

    def __init__(self, sizes: Sequence[int], dtype: torch.dtype,
                 gen: torch.Generator):
        super().__init__()
        self.n_layers = len(sizes) - 1
        for i, (a, b) in enumerate(zip(sizes[:-1], sizes[1:])):
            setattr(self, f"w{i}", nn.Parameter(dense_init(gen, (a, b),
                                                           dtype)))
            setattr(self, f"b{i}", nn.Parameter(torch.zeros(
                b, dtype=dtype, device=gen.device)))

    def forward(self, x: torch.Tensor, final_act: bool = False,
                act: Callable[[torch.Tensor], torch.Tensor] = F.relu,
                ctx: ShardCtx = NO_SHARD) -> torch.Tensor:
        if ctx.mesh is not None and type(x).__name__ == "DTensor":
            return self._forward_sharded(x, final_act, act, ctx)
        for i in range(self.n_layers):
            x = x @ getattr(self, f"w{i}") + getattr(self, f"b{i}")
            if i < self.n_layers - 1 or final_act:
                x = act(x)
        return x

    def _forward_sharded(self, x, final_act: bool, act, ctx: ShardCtx):
        """The tower over a mesh on local blocks, as the reference's
        layout has it: x's rows over ``ctx.dp`` (replicated over ``tp``,
        whose ranks compute the same rows); a layer whose weight is split
        over tp on its output is column parallel (this rank's block of
        the width), the next layer then contracts its block of the width
        (row parallel: a partial sum, all-reduced over tp, the bias added
        after). Every weight's gradient is a partial sum over the dp
        dims, and the rank's block where tp splits it."""
        from torch.distributed.tensor import (DTensor, Partial, Replicate,
                                              Shard)
        mesh, tpd = ctx.mesh, set(ctx.tp_dims())
        x = ctx.shard(x, ctx.dp, None)
        rows = x.placements
        dpd = {j for j, p in enumerate(rows) if isinstance(p, Shard)}

        def local(p, block_dim):
            pl = [Shard(block_dim) if j in tpd and block_dim is not None
                  else Replicate() for j in range(mesh.ndim)]
            grad = [Partial() if j in dpd else q for j, q in enumerate(pl)]
            return p.redistribute(mesh, pl).to_local(grad_placements=grad)

        # a first column-parallel layer reads the rank's block of the
        # weight: x's gradient is then a partial sum over tp, summed here
        # (once, on the tower's input)
        h = x.to_local()
        if self._col_parallel(0, tpd):
            h = sum_grad_over(h, mesh, tuple(tpd))
        split = False                     # h's width: this rank's block
        for i in range(self.n_layers):
            w, b = getattr(self, f"w{i}"), getattr(self, f"b{i}")
            if split:                     # row parallel
                h = sum_partials_over(h @ local(w, 0), mesh, tuple(tpd))
                h = h + local(b, None)
                split = False
            elif self._col_parallel(i, tpd):
                h = h @ local(w, 1) + local(b, 0)
                split = True
            else:
                h = h @ local(w, None) + local(b, None)
            if i < self.n_layers - 1 or final_act:
                h = act(h)
        if split:                         # a last column-parallel layer
            h = DTensor.from_local(h, mesh, [
                Shard(h.ndim - 1) if j in tpd else p
                for j, p in enumerate(rows)], run_check=False)
            return ctx.shard(h, ctx.dp, None)
        return DTensor.from_local(h, mesh, rows, run_check=False)

    def _col_parallel(self, i: int, tpd) -> bool:
        """Layer ``i``'s weight is split over tp on its output dim."""
        from torch.distributed.tensor import Shard
        w = getattr(self, f"w{i}")
        return type(w).__name__ == "DTensor" and any(
            isinstance(p, Shard) and p.dim == 1
            for j, p in enumerate(w.placements) if j in tpd)
