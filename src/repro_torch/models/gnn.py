"""The four GNN architectures over sorted-segment message passing.

Counterpart of ``repro/models/gnn.py``, with its config, parameter names
and loss:

    gin-tu          GIN (sum aggregator, learnable eps), 5 x 64
    pna             Principal Neighbourhood Aggregation: {mean,max,min,std}
                    x {identity, amplification, attenuation}, 4 x 75
    egnn            E(n)-equivariant GNN (scalar-distance messages +
                    coordinate updates), 4 x 64
    meshgraphnet    encode-process-decode with edge+node MLP blocks, 15 x 128

All message passing is ``gather(src) -> edge compute -> segment reduce
(dst)``. An endpoint equal to ``n`` is padding, as in the reference: a
gather of it reads a zero row and a message to it lands in a segment that
is dropped. The reference's ``jax.ops.segment_*`` become reductions over
*sorted* segments, with no scatter at all: :func:`graph_index` sorts a
batch's edges by destination once (stable), drops the edges whose
destination is ``n`` (they reach no node, so they change neither the
loss nor any gradient) and keeps the sorted order of the sources beside
it. Then

* a sum over destinations is ``torch.segment_reduce`` over contiguous
  runs, and its backward a gather;
* a gather's backward is the same segment sum keyed by the gathered
  index (the sources permuted into their sorted order once a call);
* max and min split the cotangent evenly among tied messages, as
  ``jax.ops.segment_max`` / ``segment_min`` do.

Every sum runs in a fixed order with no atomics and no run of equal
indices walked serially, which keeps a step deterministic on the card
(``torch.use_deterministic_algorithms``) at no cost: ``index_add_`` and
``index_put_(accumulate=True)`` walk each run of one index serially there.

No TPU kernel is on this path: the reference runs its segment sums and
matrix products outside any ``pl.pallas_call``, so they stay plain
PyTorch here. Parameters of layer ``i`` are ``layers.{i}.*`` (the
reference stacks them into ``[n_layers, ...]`` leaves;
:func:`repro_torch.convert.gnn_state_dict_from_numpy` splits them).

    >>> cfg = GNNConfig("gin-smoke", "gin", n_layers=2, d_hidden=16,
    ...                 d_feat=8, n_out=3)
    >>> model = init_gnn_params(cfg, seed=0, device="cpu")
    >>> sum(p.numel() for p in model.parameters()) == cfg.n_params
    True
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from functools import cached_property
from typing import Any, Dict, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..core.engine_torch import resolve_device
from ..layers.common import layernorm
from ..layers.mlp import MLP


@dataclass(frozen=True)
class GNNConfig:
    """The reference's ``GNNConfig`` with a torch ``dtype``. Its
    ``shard_nodes`` (a sharding constraint of the multi-device mesh; the
    port's node partition is :mod:`repro_torch.models.gnn_dist`) and
    ``mlp_layers`` (read by nothing there) are left out."""

    name: str
    kind: str                  # gin | pna | egnn | mgn
    n_layers: int
    d_hidden: int
    d_feat: int
    n_out: int                 # classes or regression dims
    task: str = "node_class"   # node_class | graph_class | node_reg
    d_edge: int = 0            # mgn edge-feature dim
    dtype: Any = torch.float32
    remat: bool = False        # recompute layer internals in backward

    @property
    def n_params(self) -> int:
        """Counted exactly from the layout :class:`GNN` builds."""
        d = self.d_hidden

        def tower(sizes):
            return sum(a * b + b for a, b in zip(sizes[:-1], sizes[1:]))

        layer = sum(tower(s) for s in layer_towers(self).values()) \
            + 2 * d * len(LAYER_NORMS.get(self.kind, ())) \
            + (self.kind == "gin")
        enc_e = tower([self.d_edge, d, d]) if self.kind == "mgn" else 0
        return (tower([self.d_feat, d, d]) + self.n_layers * layer + enc_e
                + tower([d, d, self.n_out]))


def layer_towers(cfg: GNNConfig) -> Dict[str, Tuple[int, ...]]:
    """The MLP towers of one layer of ``cfg.kind``, by name: the sizes the
    reference's ``init_gnn_params`` gives them."""
    d = cfg.d_hidden
    towers = {"gin": {"mlp": (d, d, d)},
              "pna": {"pre": (2 * d, d), "post": (13 * d, d)},
              "egnn": {"phi_e": (2 * d + 1, d, d), "phi_x": (d, d, 1),
                       "phi_h": (2 * d, d, d)},
              "mgn": {"edge_mlp": (3 * d, d, d), "node_mlp": (2 * d, d, d)}}
    if cfg.kind not in towers:
        raise ValueError(f"unknown GNN kind {cfg.kind!r}")
    return towers[cfg.kind]


#: the LayerNorms of one layer, by kind (a gain ``g`` and a bias ``b``)
LAYER_NORMS = {"gin": ("ln",), "mgn": ("edge_ln", "node_ln")}


# --------------------------------------------------------------------------
# Message-passing primitives over sorted segments
# --------------------------------------------------------------------------


class Segments:
    """The segments of an index array over ``n`` nodes, built once and
    read by every sum, gather and extremum keyed by it.

    ``idx`` (clipped to ``[0, n]``, as the reference clips) in its own
    order; ``order``, the stable argsort that puts it in ascending order
    (None when it already is); ``ptr [n + 1]``, segment ``v`` being sorted
    positions ``ptr[v]:ptr[v + 1]``. Entries equal to ``n`` sort last,
    past ``ptr[n]``, in no segment: they are dropped. Building it reads
    ``ptr[n]`` back to the host."""

    def __init__(self, idx: torch.Tensor, n: int, presorted: bool = False):
        self.n = n
        self.idx = idx.long().clamp(0, n)
        if presorted:
            self.order, keys = None, self.idx
        else:
            keys, self.order = torch.sort(self.idx, stable=True)
        self.ptr = torch.searchsorted(
            keys, torch.arange(n + 1, device=keys.device))
        self.n_valid = int(self.ptr[n])
        # gathers read row min(idx, n - 1) and zero the padded entries
        self.pad = None if self.n_valid == self.idx.shape[0] else \
            (self.idx == n)[:, None]
        self.safe_idx = self.idx.clamp(max=max(n - 1, 0))

    def reduce(self, x: torch.Tensor, how: str) -> torch.Tensor:
        """``x [E, ...]`` (in ``idx``'s order) reduced by segment ->
        ``[n, ...]``: ``how`` is ``sum`` (empty segments 0), ``max`` or
        ``min`` (empty segments -inf / +inf)."""
        xs = x[:self.n_valid] if self.order is None else \
            x.index_select(0, self.order[:self.n_valid])
        init = {"sum": 0.0, "max": -math.inf, "min": math.inf}[how]
        return torch.segment_reduce(xs, how, offsets=self.ptr, axis=0,
                                    initial=init)

    def gather(self, h: torch.Tensor) -> torch.Tensor:
        """``h [n, ...]`` at ``idx`` -> ``[E, ...]``; a zero row where the
        entry is ``n``."""
        out = h.index_select(0, self.safe_idx)
        if self.pad is not None:
            out = out.masked_fill(self.pad.view((-1,) + (1,) * (h.dim() - 1)),
                                  0)
        return out


class _Gather(torch.autograd.Function):
    """``h[idx]`` with a zero row at ``n``; backward: the segment sum of
    the cotangent keyed by ``idx`` (no scatter)."""

    @staticmethod
    def forward(ctx, h, seg):
        ctx.seg = seg
        return seg.gather(h)

    @staticmethod
    def backward(ctx, g):
        return ctx.seg.reduce(g, "sum"), None


class _ScatterSum(torch.autograd.Function):
    """Segment sum keyed by ``idx``; backward: a gather of the
    cotangent."""

    @staticmethod
    def forward(ctx, msg, seg):
        ctx.seg = seg
        return seg.reduce(msg, "sum")

    @staticmethod
    def backward(ctx, g):
        return ctx.seg.gather(g), None


class _ScatterExtremum(torch.autograd.Function):
    """Segment max or min keyed by ``idx``; backward: the cotangent of a
    segment split evenly among its messages equal to the result, as
    ``jax.ops.segment_max`` / ``segment_min`` split it."""

    @staticmethod
    def forward(ctx, msg, seg, how):
        out = seg.reduce(msg, how)
        ctx.seg = seg
        ctx.save_for_backward(msg, out)
        return out

    @staticmethod
    def backward(ctx, g):
        msg, out = ctx.saved_tensors
        seg = ctx.seg
        tie = msg == seg.gather(out)
        share = g.float() / seg.reduce(tie.float(), "sum").clamp(min=1.0)
        return torch.where(tie, seg.gather(share).to(g.dtype), 0.0), \
            None, None


def _segments(idx, n: int) -> Segments:
    return idx if isinstance(idx, Segments) else Segments(idx, n)


def gather_src(h: torch.Tensor, src, n: int) -> torch.Tensor:
    """h: [N, d]; src: [E] index (or its :class:`Segments`) with sentinel
    ``n`` -> zeros row."""
    return _Gather.apply(h, _segments(src, n))


def scatter_sum(msg: torch.Tensor, dst, n: int) -> torch.Tensor:
    return _ScatterSum.apply(msg, _segments(dst, n))


def scatter_max(msg: torch.Tensor, dst, n: int) -> torch.Tensor:
    """Segment max; a segment that got nothing (-inf) is 0."""
    out = _ScatterExtremum.apply(msg, _segments(dst, n), "max")
    return torch.where(torch.isfinite(out), out, 0.0)


def scatter_min(msg: torch.Tensor, dst, n: int) -> torch.Tensor:
    """Segment min; a segment that got nothing (+inf) is 0."""
    out = _ScatterExtremum.apply(msg, _segments(dst, n), "min")
    return torch.where(torch.isfinite(out), out, 0.0)


def in_degree(dst, n: int, emask: torch.Tensor) -> torch.Tensor:
    """The f32 count of ``emask``'s edges into each node, [N]."""
    return _segments(dst, n).reduce(emask.float(), "sum")


@dataclass
class GraphIndex:
    """A batch's edges sorted once by destination: ``keep`` (positions in
    the batch's edge arrays of the edges whose destination is a node,
    stably sorted by it), the :class:`Segments` of their sources and
    destinations, and ``emask`` (their source is a node: the reference's
    ``e_src < n``)."""

    n: int
    keep: torch.Tensor
    src: Segments
    dst: Segments
    emask: torch.Tensor


def graph_index(edge_src: torch.Tensor, edge_dst: torch.Tensor,
                n: int) -> GraphIndex:
    """Sort the edges by destination (stable) and drop those into ``n``.
    Build it once a batch: every layer, its backward and the pooling
    read it."""
    dst, keep = torch.sort(edge_dst.long().clamp(0, n), stable=True)
    m = int(torch.searchsorted(dst, torch.tensor([n], device=dst.device)))
    keep, dst = keep[:m], dst[:m]
    src = edge_src.long().clamp(0, n).index_select(0, keep)
    return GraphIndex(n=n, keep=keep, src=Segments(src, n),
                      dst=Segments(dst, n, presorted=True), emask=src < n)


class Aggregation:
    """How a layer body reads node state and reduces its messages over a
    batch's :class:`GraphIndex`. Here the node tensors are whole and the
    reductions are the segment primitives above;
    :class:`repro_torch.models.gnn_dist.GridAggregation` holds node blocks
    and sums its partials over a process grid."""

    def __init__(self, ix: GraphIndex):
        self.ix = ix

    def nodes(self, t: torch.Tensor) -> torch.Tensor:
        """The node rows that the edges' ids index (``t`` itself here)."""
        return t

    def at_src(self, t_full: torch.Tensor) -> torch.Tensor:
        return gather_src(t_full, self.ix.src, self.ix.n)

    def at_dst(self, t_full: torch.Tensor) -> torch.Tensor:
        return gather_src(t_full, self.ix.dst, self.ix.n)

    def sum(self, msg: torch.Tensor) -> torch.Tensor:
        return scatter_sum(msg, self.ix.dst, self.ix.n)

    def extremum(self, msg: torch.Tensor, how: str) -> torch.Tensor:
        """The max or min of ``msg`` by destination; 0 where a node got
        nothing."""
        out = self._extremum(msg, how)
        return torch.where(torch.isfinite(out), out, 0.0)

    def _extremum(self, msg, how):
        return _ScatterExtremum.apply(msg, self.ix.dst, how)

    @cached_property
    def deg(self) -> torch.Tensor:
        """The f32 in-degree, at least 1, ``[N, 1]``."""
        ix = self.ix
        with torch.no_grad():
            return in_degree(ix.dst, ix.n, ix.emask).clamp(min=1.0)[:, None]


# --------------------------------------------------------------------------
# Parameters
# --------------------------------------------------------------------------


class LayerNorm(nn.Module):
    """The reference's ``{"g", "b"}`` LayerNorm leaves (init 1 and 0)."""

    def __init__(self, d: int, dtype: torch.dtype, device):
        super().__init__()
        self.g = nn.Parameter(torch.ones(d, dtype=dtype, device=device))
        self.b = nn.Parameter(torch.zeros(d, dtype=dtype, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layernorm(x, self.g, self.b)


class GNNLayer(nn.Module):
    """One message-passing layer: the towers of :func:`layer_towers`, the
    LayerNorms of :data:`LAYER_NORMS` and, for GIN, the scalar ``eps``
    (init 0)."""

    def __init__(self, cfg: GNNConfig, gen: torch.Generator):
        super().__init__()
        dt, dev = cfg.dtype, gen.device
        for name, sizes in layer_towers(cfg).items():
            setattr(self, name, MLP(sizes, dt, gen))
        if cfg.kind == "gin":
            self.eps = nn.Parameter(torch.zeros((), dtype=dt, device=dev))
        for name in LAYER_NORMS.get(cfg.kind, ()):
            setattr(self, name, LayerNorm(cfg.d_hidden, dt, dev))


class GNN(nn.Module):
    """``enc [d_feat, d, d]``, ``layers``, ``enc_e [d_edge, d, d]``
    (MeshGraphNet) and ``dec [d, d, n_out]``, drawn from ``gen`` on its
    device in ``cfg.dtype``."""

    def __init__(self, cfg: GNNConfig, gen: torch.Generator):
        super().__init__()
        self.cfg = cfg
        d, dt = cfg.d_hidden, cfg.dtype
        self.enc = MLP([cfg.d_feat, d, d], dt, gen)
        self.layers = nn.ModuleList(GNNLayer(cfg, gen)
                                    for _ in range(cfg.n_layers))
        if cfg.kind == "mgn":
            self.enc_e = MLP([cfg.d_edge, d, d], dt, gen)
        self.dec = MLP([d, d, cfg.n_out], dt, gen)


def init_gnn_params(cfg: GNNConfig, seed: int = 0, device=None) -> GNN:
    """A :class:`GNN` drawn from ``torch.Generator(device)`` seeded with
    ``seed``, on the card unless ``device`` says otherwise."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return GNN(cfg, gen)


def gnn_decay_mask(params: Mapping[str, torch.Tensor]) -> Dict[str, bool]:
    """Which of the named parameters AdamW decays: the reference's ``ndim
    >= 2`` on its own leaf, where each layer's tensors are stacked into
    one ``[n_layers, ...]`` leaf, so a ``layers.<i>.`` tensor has one
    dimension more there (its LayerNorm gains and MLP biases are
    decayed, its ``eps`` is not); the encoders' and decoder's biases are
    not."""
    return {name: t.ndim + name.startswith("layers.") >= 2
            for name, t in params.items()}


# --------------------------------------------------------------------------
# Layer bodies
# --------------------------------------------------------------------------


def _gin_layer(lp: GNNLayer, h, agg: Aggregation):
    s = agg.sum(agg.at_src(agg.nodes(h)))
    out = lp.mlp((1.0 + lp.eps) * h + s, final_act=True)
    # GIN-TU uses BatchNorm between layers; LayerNorm is the reference's
    # distribution-friendly substitute (no cross-device batch stats)
    return lp.ln(out)


def _pna_layer(lp: GNNLayer, h, agg: Aggregation, delta: float = 2.0):
    em, dt, deg = agg.ix.emask[:, None], h.dtype, agg.deg
    hp = agg.nodes(h)
    m = torch.where(em, lp.pre(torch.cat([agg.at_src(hp), agg.at_dst(hp)],
                                         dim=-1)), 0.0)
    # the moments and the degree arithmetic are at least f32 and each
    # aggregate is cast back to the state's dtype, as the reference's
    # distributed loss casts it (bf16 moments would make sq - mean^2 of
    # an in-degree-1 node nonzero, where sqrt's slope is 5,000)
    m32 = m.to(torch.promote_types(dt, torch.float32))
    mean = agg.sum(m32) / deg
    mx = agg.extremum(torch.where(em, m, -math.inf), "max")
    mn = agg.extremum(torch.where(em, m, math.inf), "min")
    sq = agg.sum(m32 * m32) / deg
    # jnp.maximum's tie rule (1/2 : 1/2; clamp passes it whole). A tie,
    # sq == mean^2 (in-degree 1, equal messages), is where d(sq -
    # mean^2)/dm is 0, so the rule changes no gradient
    var = sq - mean * mean
    std = torch.sqrt(torch.maximum(var, torch.zeros_like(var)) + 1e-8).to(dt)
    mean = mean.to(dt)
    logd = torch.log(deg + 1.0).to(dt)
    scaled = []
    for a in (mean, mx, mn, std):
        scaled += [a, a * logd / delta, a * delta / logd]
    return h + lp.post(torch.cat([h] + scaled, dim=-1))


def _egnn_layer(lp: GNNLayer, h, x, agg: Aggregation):
    em = agg.ix.emask[:, None]
    hp, xp = agg.nodes(h), agg.nodes(x)
    diff = agg.at_dst(xp) - agg.at_src(xp)
    r2 = torch.sum(diff * diff, dim=-1, keepdim=True)
    m = lp.phi_e(torch.cat([agg.at_dst(hp), agg.at_src(hp), r2], dim=-1),
                 final_act=True, act=F.silu)
    m = torch.where(em, m, 0.0)
    w = lp.phi_x(m, act=F.silu)                                  # [E, 1]
    x_new = (x + agg.sum(diff * w) / agg.deg).to(x.dtype)
    h_new = h + lp.phi_h(torch.cat([h, agg.sum(m)], dim=-1), act=F.silu)
    return h_new, x_new


def _mgn_layer(lp: GNNLayer, h, e_feat, agg: Aggregation):
    hp = agg.nodes(h)
    e_new = lp.edge_ln(lp.edge_mlp(torch.cat(
        [e_feat, agg.at_src(hp), agg.at_dst(hp)], dim=-1))) + e_feat
    e_new = torch.where(agg.ix.emask[:, None], e_new, 0.0)
    h_new = lp.node_ln(lp.node_mlp(torch.cat([h, agg.sum(e_new)], dim=-1))) \
        + h
    return h_new, e_new


_BODIES = {"gin": _gin_layer, "pna": _pna_layer, "egnn": _egnn_layer,
           "mgn": _mgn_layer}


# --------------------------------------------------------------------------
# Forward + loss
# --------------------------------------------------------------------------


def node_states(model: GNN, batch: Mapping[str, torch.Tensor],
                agg: Aggregation) -> torch.Tensor:
    """The encoder and every layer: the node states ``[N, d]`` the
    decoder reads (a block of them under a grid's ``agg``). With
    ``cfg.remat`` each layer runs under ``torch.utils.checkpoint``."""
    cfg, ix = model.cfg, agg.ix
    h = model.enc(batch["x"].to(cfg.dtype), final_act=True)
    h = h * batch["node_mask"][:, None].to(h.dtype)
    body = _BODIES[cfg.kind]

    def run(lp, *carry):
        if cfg.remat:
            return checkpoint(body, lp, *carry, agg, use_reentrant=False)
        return body(lp, *carry, agg)

    if cfg.kind in ("egnn", "mgn"):
        if cfg.kind == "egnn":
            other = batch["pos"].to(cfg.dtype)
        else:
            ef = model.enc_e(batch["edge_attr"].index_select(0, ix.keep)
                             .to(cfg.dtype), final_act=True)
            other = torch.where(ix.emask[:, None], ef, 0.0)
        for lp in model.layers:
            h, other = run(lp, h, other)
    else:
        for lp in model.layers:
            h = run(lp, h)
    return h


def gnn_forward(model: GNN, batch: Mapping[str, torch.Tensor],
                index: Optional[GraphIndex] = None) -> torch.Tensor:
    """Node outputs ``[N, n_out]`` (``graph_class``: ``[G, n_out]``, sum
    pooling by ``graph_ids`` over ``G = len(loss_mask)`` graphs).
    ``index``: the batch's :func:`graph_index`, built here when None (a
    caller whose batch repeats every step builds it once)."""
    n = batch["x"].shape[0]
    ix = index if index is not None else \
        graph_index(batch["edge_src"], batch["edge_dst"], n)
    h = node_states(model, batch, Aggregation(ix))
    if model.cfg.task == "graph_class":
        ng = batch["loss_mask"].shape[0]
        h = scatter_sum(h, batch["graph_ids"], ng)
    return model.dec(h)


def masked_loss_sum(out: torch.Tensor, batch: Mapping[str, torch.Tensor],
                    task: str) -> torch.Tensor:
    """The f32 sum of the losses of the rows ``loss_mask`` keeps: cross
    entropy (``node_class``, ``graph_class``) or the squared error summed
    over the outputs (``node_reg``)."""
    out, mask = out.float(), batch["loss_mask"].float()
    if task == "node_reg":
        return torch.sum((out - batch["targets"]) ** 2 * mask[:, None])
    lse = torch.logsumexp(out, dim=-1)
    ll = torch.gather(out, -1, batch["labels"].long()[:, None])[:, 0]
    return torch.sum((lse - ll) * mask)


def gnn_loss(model: GNN, batch: Mapping[str, torch.Tensor],
             index: Optional[GraphIndex] = None
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Masked f32 cross entropy and accuracy (``node_class``,
    ``graph_class``), or masked MSE (``node_reg``): ``(loss, {"loss",
    "acc"})`` / ``(loss, {"loss"})``."""
    out = gnn_forward(model, batch, index)
    mask = batch["loss_mask"].float()
    den = mask.sum().clamp(min=1.0)
    loss = masked_loss_sum(out, batch, model.cfg.task) / den
    if model.cfg.task == "node_reg":
        return loss, {"loss": loss}
    acc = torch.sum((out.float().argmax(-1) == batch["labels"].long())
                    * mask) / den
    return loss, {"loss": loss, "acc": acc}
