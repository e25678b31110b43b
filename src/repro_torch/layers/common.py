"""Shared layer utilities: the sharding context, init helpers, RMSNorm,
layernorm, swish and the softmax cross entropy.

Counterpart of ``repro/layers/common.py``. Sharding is expressed through
a :class:`ShardCtx`: a no-op without a mesh (every single-card path), and
with a ``DeviceMesh`` a ``redistribute`` of a ``DTensor`` to the
placements its axes name (the counterpart of
``with_sharding_constraint``; the dry-run's programs). Init draws from an
explicit ``torch.Generator`` on the parameter's device.

Axis conventions (see launch/mesh.py):
    dp axes   batch-parallel axes ("data", plus "pod" when multi-pod)
    tp axis   "model" (tensor/TP, experts, vocab, KV-sequence in decode)
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Optional, Sequence, Tuple, Union

import torch
from torch import nn

from ..kernels import ops as kops

Axis = Union[None, str, Tuple[str, ...]]


@dataclass(frozen=True)
class ShardCtx:
    """Mesh + axis naming used by model code for activation layouts."""

    mesh: Any = None       # a torch DeviceMesh, or None
    dp: Axis = None        # batch axes, e.g. ("pod", "data") or "data"
    tp: Axis = None        # model axis
    #: the batch's real rows when it was padded to a multiple of the dp
    #: ranks (the rows past them are padding); None: every row is real
    rows: Optional[int] = None

    def shard(self, x: torch.Tensor, *axes: Axis) -> torch.Tensor:
        """``x`` laid out as ``axes`` (one entry per dim): a no-op without
        a mesh or on a plain tensor; a ``DTensor`` is redistributed. An
        axis that does not divide its dim is dropped (GSPMD would pad; a
        DTensor's views and their backward need even shards)."""
        if self.mesh is None or not _is_dtensor(x):
            return x
        want = self.placements(x, *axes)
        if tuple(x.placements) == tuple(want):
            return x
        return x.redistribute(self.mesh, want)

    def placements(self, x: torch.Tensor, *axes: Axis) -> list:
        """The placements :meth:`shard` lays ``x`` out in (no data
        moved)."""
        from ..launch.shardings import mesh_shape, placements, sanitize_one
        return placements(sanitize_one(axes, x.shape, mesh_shape(self.mesh),
                                       rehome=False), self.mesh)

    def split_heads(self, x: torch.Tensor, h: int, d: int) -> torch.Tensor:
        """``[B, T, h * d] -> [B, T, h, d]``. With a mesh the flattened
        dim is first laid out over ``tp`` when ``tp`` divides ``h`` and
        replicated otherwise, since a view cannot split an uneven
        shard; then each rank splits its own block (the same placements:
        a block of the width is a block of heads), so that the gradient's
        merge is a plain reshape of the local block (DTensor's view
        refuses the kernels' strided gradients)."""
        b, t = x.shape[0], x.shape[1]
        if self.mesh is None or not _is_dtensor(x):
            return x.reshape(b, t, h, d)
        from torch.distributed.tensor import DTensor
        from ..launch.shardings import axis_size, mesh_shape
        tp_ok = h % axis_size(self.tp, mesh_shape(self.mesh)) == 0
        x = self.shard(x, self.dp, None, self.tp if tp_ok else None)
        loc = x.to_local()
        return DTensor.from_local(
            loc.reshape(loc.shape[0], t, -1, d), x.device_mesh, x.placements,
            run_check=False, shape=(b, t, h, d),
            stride=(t * h * d, h * d, d, 1))

    def weight(self, w: torch.Tensor) -> torch.Tensor:
        """A parameter in the layout the products take it in: gathered
        over the dp axes (FSDP's all-gather; its gradient comes back as a
        reduce-scatter), kept as it is over ``tp``. Without a mesh, or on a
        plain tensor, ``w`` itself. (Left to itself, DTensor may rather
        move the activations and contract a dp-sharded weight dim.)"""
        if self.mesh is None or not _is_dtensor(w):
            return w
        from torch.distributed.tensor import Replicate
        tpd = self.tp_dims()
        want = [p if j in tpd else Replicate()
                for j, p in enumerate(w.placements)]
        if want == list(w.placements):
            return w
        return w.redistribute(self.mesh, want)

    def tp_dims(self) -> Tuple[int, ...]:
        """The mesh dims of the ``tp`` axes."""
        names = list(self.mesh.mesh_dim_names)
        return tuple(names.index(a) for a in (
            (self.tp,) if isinstance(self.tp, str) else self.tp or ()))

    def tp_block(self) -> Tuple[int, int]:
        """``(n_tp, i)``: the size of the ``tp`` axes and this rank's index
        along them (major to minor)."""
        coord = self.mesh.get_coordinate()
        n, i = 1, 0
        for j in self.tp_dims():
            n, i = n * self.mesh.shape[j], i * self.mesh.shape[j] + coord[j]
        return n, i

    @property
    def dp_size(self) -> int:
        if self.mesh is None or self.dp is None:
            return 1
        from ..launch.shardings import axis_size, mesh_shape
        return axis_size(self.dp, mesh_shape(self.mesh))


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    """``[B, T, H, d] -> [B, T, H * d]``. A DTensor is laid out over its
    batch dim alone and reshaped on its local shard, so that its gradient
    comes back in that layout: DTensor's own view cannot merge heads it
    holds in a kernel's strided output, nor split a gradient whose width
    is sharded over a mesh dim that does not divide the heads."""
    b, t = x.shape[0], x.shape[1]
    if not _is_dtensor(x):
        return x.reshape(b, t, -1)
    from torch.distributed.tensor import DTensor, Replicate, Shard
    pl = [p if isinstance(p, Shard) and p.dim == 0 else Replicate()
          for p in x.placements]
    loc = x.redistribute(x.device_mesh, pl).to_local()
    width = x.shape[2] * x.shape[3]
    return DTensor.from_local(loc.reshape(loc.shape[0], t, width),
                              x.device_mesh, pl, run_check=False,
                              shape=(b, t, width), stride=(t * width, width,
                                                            1))


def all_reduce_over(x: torch.Tensor, mesh, dims) -> torch.Tensor:
    """``x`` (a local tensor) summed over the ranks of the mesh dims
    ``dims``."""
    import torch.distributed._functional_collectives as funcol
    for i in dims:
        x = funcol.wait_tensor(funcol.all_reduce(x, "sum", (mesh, i)))
    return x


# Collectives on local tensors with their gradients stated: the mesh-only
# code of the layers runs its products on local blocks and calls these
# where ranks meet.


class _AllReduce(torch.autograd.Function):
    """A sum over the ranks of the mesh dims ``dims`` in the forward
    (``fwd``; else the identity) and in the backward (``bwd``)."""

    @staticmethod
    def forward(ctx, x, mesh, dims, fwd, bwd):
        ctx.args = (mesh, dims, bwd)
        return all_reduce_over(x, mesh, dims) if fwd else x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        mesh, dims, bwd = ctx.args
        return (all_reduce_over(g, mesh, dims) if bwd else g), None, None, \
            None, None


def sum_partials_over(x: torch.Tensor, mesh, dims) -> torch.Tensor:
    """The sum of partial products ``x`` over the ranks of the mesh dims
    ``dims``, where every rank then computes alike from the sum and holds
    its whole gradient: each rank's part takes that gradient as it is (an
    identity backward)."""
    return _AllReduce.apply(x, mesh, tuple(dims), True, False)


def sum_grad_over(x: torch.Tensor, mesh, dims) -> torch.Tensor:
    """Identity; the gradient is summed over the ranks of the mesh dims
    ``dims`` (each holds only its own part of it)."""
    return _AllReduce.apply(x, mesh, tuple(dims), False, True)


def row_offset(placements, mesh, n_rows: int) -> int:
    """The global index of the first of a rank's ``n_rows`` local rows
    (dim 0) of a tensor laid out as ``placements`` (even shards, in
    mesh-dim order)."""
    from torch.distributed.tensor import Shard
    coord = mesh.get_coordinate()
    idx = 0
    for j, p in enumerate(placements):
        if isinstance(p, Shard) and p.dim == 0:
            idx = idx * mesh.shape[j] + coord[j]
    return idx * n_rows


def _is_dtensor(x: Any) -> bool:
    return type(x).__name__ == "DTensor"      # no import on the hot path


NO_SHARD = ShardCtx()


def dense_init(gen: torch.Generator, shape: Sequence[int],
               dtype: torch.dtype = torch.float32,
               scale: Optional[float] = None) -> torch.Tensor:
    """LeCun-normal (fan-in) init, drawn in f32 on ``gen``'s device."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    s = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    return (torch.randn(tuple(shape), generator=gen, device=gen.device)
            * s).to(dtype)


def embed_init(gen: torch.Generator, shape: Sequence[int],
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return (torch.randn(tuple(shape), generator=gen, device=gen.device)
            * 0.02).to(dtype)


def rmsnorm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-6,
            impl: str = "auto") -> torch.Tensor:
    return kops.rmsnorm(x, gamma, eps=eps, impl=impl)


def layernorm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis in f32 (biased variance), cast once to
    x's dtype."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    out = (xf - mu) * torch.rsqrt(var + eps) * gamma + beta
    return out.to(x.dtype)


def swish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def _sharded_token_losses(logits: torch.Tensor, labels: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each position's ``lse - logit[label]`` and its ``lse`` (DTensors
    laid out as the logits' rows) of f32 DTensor logits ``[..., V]``, on
    each rank's local block: where the vocab is split over mesh dims, the
    row max, the sum of exponentials and the label's logit are each one
    all-reduce over them (the sums' gradients whole on every rank, as
    every rank then computes alike from them), and nothing of the logits'
    size moves, forward or backward."""
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh, pl = logits.device_mesh, logits.placements
    last = logits.ndim - 1
    vdims = tuple(i for i, p in enumerate(pl)
                  if isinstance(p, Shard) and p.dim == last)
    rows = [Replicate() if i in vdims else p for i, p in enumerate(pl)]
    lg = logits.to_local()
    lab = labels.redistribute(mesh, rows).to_local().long()
    first = 0
    for i in vdims:                     # this rank's first vocab id
        first = first * mesh.shape[i] + mesh.get_coordinate()[i]
    n = lg.shape[-1]
    m = lg.detach().amax(dim=-1)
    for i in vdims:
        m = funcol.wait_tensor(funcol.all_reduce(m, "max", (mesh, i)))
    se = sum_partials_over((lg - m[..., None]).exp().sum(dim=-1), mesh,
                           vdims)
    lse = se.log() + m
    idx = lab - first * n
    hit = (idx >= 0) & (idx < n)
    ll = torch.gather(lg, -1, idx.clamp(0, n - 1)[..., None])[..., 0]
    ll = sum_partials_over(torch.where(hit, ll, 0.0), mesh, vdims)

    def whole(t):
        return DTensor.from_local(t, mesh, rows, run_check=False)
    return whole(lse - ll), whole(lse)


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          z_loss: float = 0.0) -> torch.Tensor:
    """Mean cross entropy over all positions, in f32: ``logsumexp`` minus
    the label's logit (the softmax is never materialised), plus
    ``z_loss * mean(lse^2)`` when ``z_loss`` is set. logits [..., V],
    labels [...] integer ids."""
    logits = logits.float()
    if _is_dtensor(logits):
        tok, lse = _sharded_token_losses(logits, labels)
    else:
        lse = torch.logsumexp(logits, dim=-1)
        ll = torch.gather(logits, -1, labels[..., None].long())[..., 0]
        tok = lse - ll
    loss = tok.mean()
    if z_loss:
        loss = loss + z_loss * (lse ** 2).mean()
    return loss


class RMSNorm(nn.Module):
    """RMSNorm over the last axis with gain ``weight`` (init 1)."""

    def __init__(self, d: int, eps: float = 1e-6,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(d, dtype=dtype, device=device))

    def forward(self, x: torch.Tensor, impl: str = "auto") -> torch.Tensor:
        return rmsnorm(x, self.weight, self.eps, impl=impl)
