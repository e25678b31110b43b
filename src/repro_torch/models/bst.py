"""Behavior Sequence Transformer (BST, Alibaba, arXiv:1905.06874).

Counterpart of ``repro/models/bst.py``, with its config, parameter layout
and step functions. A CTR model: the user's last ``seq_len`` item ids and
the target item are embedded (item table + learned positions), run
through ``n_blocks`` post-LN transformer encoder blocks (8 heads), then
flattened beside the user profile (a multi-hot bag reduced by
:func:`~repro_torch.layers.embedding_bag.embedding_bag_fixed`, mean over
the non-pad ids) and scored by a 1024-512-256 ReLU MLP.

    user_tower     the history's item rows and the profile bag
    bst_scores     CTR logits [B]
    bst_loss       stable BCE of the logits in f32 and the accuracy
    bst_serve      sigmoid CTR per (user, target) row
    bst_retrieval  one user against C candidate items: the candidates are
                   the batch axis of the encoder (the history broadcast to
                   each), as the reference factors it; ``chunk`` runs them
                   that many at a time, which gives the same scores with a
                   bounded peak (the block's ``[C, 8, 21, 21]`` f32 scores
                   are 14 GiB at C = 10^6)

No kernel is written for BST: at ``d_head = 32 / 8 = 4`` attention is a
few einsums over 21 positions, which the reference also computes outside
any Pallas kernel, so plain ``torch`` matrix products stay. Parameters
are f32, as the reference's config; the parameters of block ``i`` are
``blocks.{i}.*`` (the reference stacks them into ``[n_blocks, ...]``
leaves; ``repro_torch.convert.bst_state_dict_from_numpy`` splits them).

    >>> from repro_torch.configs import get_config
    >>> cfg = get_config("bst").smoke().model_cfg
    >>> model = init_bst_params(cfg, seed=0, device="cpu")
    >>> import torch
    >>> bst_scores(model, torch.ones((2, 20), dtype=torch.long),
    ...            torch.ones(2, dtype=torch.long),
    ...            torch.zeros((2, 8), dtype=torch.long)).shape
    torch.Size([2])
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..core.engine_torch import resolve_device
from ..layers.common import NO_SHARD, ShardCtx, _is_dtensor, dense_init, \
    embed_init, layernorm
from ..layers.embedding_bag import embedding_bag_fixed, embedding_lookup
from ..layers.mlp import MLP


@dataclass(frozen=True)
class BSTConfig:
    name: str = "bst"
    n_items: int = 1_000_000
    n_user_feats: int = 100_000        # multi-hot profile vocab
    user_feat_len: int = 32            # multi-hot bag width
    embed_dim: int = 32
    seq_len: int = 20
    n_blocks: int = 1
    n_heads: int = 8
    d_ff_mult: int = 4
    mlp_sizes: Tuple[int, ...] = (1024, 512, 256)
    dropout: float = 0.0               # inference/benchmark profile
    dtype: Any = torch.float32

    @property
    def d_head(self) -> int:
        return self.embed_dim // self.n_heads

    @property
    def concat_dim(self) -> int:
        # (seq + target) flattened transformer output + user-profile bag
        return (self.seq_len + 1) * self.embed_dim + self.embed_dim

    @property
    def n_params(self) -> int:
        d, f = self.embed_dim, self.embed_dim * self.d_ff_mult
        block = 4 * d * d + 2 * d * f + 4 * d
        sizes = [self.concat_dim, *self.mlp_sizes, 1]
        mlp = sum(a * b + b for a, b in zip(sizes[:-1], sizes[1:]))
        return ((self.n_items + self.seq_len + 1 + self.n_user_feats) * d
                + self.n_blocks * block + mlp)


class EncoderBlock(nn.Module):
    """Post-LN encoder block over the short ``seq_len + 1`` axis: ``wq``,
    ``wk``, ``wv``, ``wo [d, d]``, ``ff1 [d, d * mult]``, ``ff2``, and the
    two layernorms' ``ln*_g`` (init 1) and ``ln*_b`` (init 0)."""

    def __init__(self, cfg: BSTConfig, gen: torch.Generator):
        super().__init__()
        d, dt, dev = cfg.embed_dim, cfg.dtype, gen.device
        self.n_heads = cfg.n_heads
        for name in ("wq", "wk", "wv", "wo"):
            setattr(self, name, nn.Parameter(dense_init(gen, (d, d), dt)))
        self.ff1 = nn.Parameter(dense_init(gen, (d, d * cfg.d_ff_mult), dt))
        self.ff2 = nn.Parameter(dense_init(gen, (d * cfg.d_ff_mult, d), dt))
        for i in (1, 2):
            setattr(self, f"ln{i}_g", nn.Parameter(
                torch.ones(d, dtype=dt, device=dev)))
            setattr(self, f"ln{i}_b", nn.Parameter(
                torch.zeros(d, dtype=dt, device=dev)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [B, T, d] -> [B, T, d]; the softmax in f32."""
        b, t, d = x.shape
        h = self.n_heads
        dh = d // h
        q = (x @ self.wq).reshape(b, t, h, dh)
        k = (x @ self.wk).reshape(b, t, h, dh)
        v = (x @ self.wv).reshape(b, t, h, dh)
        s = torch.einsum("bqhd,bkhd->bhqk", q, k) * (dh ** -0.5)
        p = torch.softmax(s.float(), dim=-1).to(x.dtype)
        o = torch.einsum("bhqk,bkhd->bqhd", p, v).reshape(b, t, d)
        x = layernorm(x + o @ self.wo, self.ln1_g, self.ln1_b)
        f = F.relu(x @ self.ff1) @ self.ff2
        return layernorm(x + f, self.ln2_g, self.ln2_b)


class BST(nn.Module):
    """``item_emb [n_items, d]``, ``pos_emb [seq_len + 1, d]``, ``user_emb
    [n_user_feats, d]`` (all ``0.02 * N(0, 1)``), ``blocks`` and the ``mlp``
    tower ``[concat_dim, *mlp_sizes, 1]``, drawn from ``gen`` on its
    device in ``cfg.dtype``."""

    def __init__(self, cfg: BSTConfig, gen: torch.Generator):
        super().__init__()
        self.cfg = cfg
        d, dt = cfg.embed_dim, cfg.dtype
        self.item_emb = nn.Parameter(embed_init(gen, (cfg.n_items, d), dt))
        self.pos_emb = nn.Parameter(embed_init(gen, (cfg.seq_len + 1, d),
                                               dt))
        self.user_emb = nn.Parameter(embed_init(gen, (cfg.n_user_feats, d),
                                                dt))
        self.blocks = nn.ModuleList(EncoderBlock(cfg, gen)
                                    for _ in range(cfg.n_blocks))
        self.mlp = MLP([cfg.concat_dim, *cfg.mlp_sizes, 1], dt, gen)


def init_bst_params(cfg: BSTConfig, seed: int = 0, device=None) -> BST:
    """A :class:`BST` drawn from ``torch.Generator(device)`` seeded with
    ``seed``, on the card unless ``device`` says otherwise."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return BST(cfg, gen)


def user_tower(model: BST, hist: torch.Tensor, user_feats: torch.Tensor,
               ctx: ShardCtx = NO_SHARD
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """hist [B, L] item ids; user_feats [B, W] multi-hot (pad 0) ->
    (the history's rows [B, L, d], the profile bag [B, d])."""
    e_hist = ctx.shard(embedding_lookup(model.item_emb, hist), ctx.dp,
                       None, None)
    e_user = embedding_bag_fixed(model.user_emb, user_feats, mode="mean",
                                 pad_id=0, ctx=ctx)
    return e_hist, e_user


def encode(model: BST, seq: torch.Tensor,
           ctx: ShardCtx = NO_SHARD) -> torch.Tensor:
    """The encoder blocks over ``seq [B, T, d]``. Under a mesh they run on
    local blocks, as the reference's layout has them: each rank its rows
    over ``ctx.dp`` (replicated over the other axes, where every rank
    computes the same rows) with the blocks' weights whole; a weight's
    gradient is a partial sum over the dp dims. (Left to DTensor, the
    replicated rows would be split over the other axes.)"""
    if ctx.mesh is None or not _is_dtensor(seq):
        for block in model.blocks:
            seq = block(seq)
        return seq
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.func import functional_call
    seq = ctx.shard(seq, ctx.dp, None, None)
    mesh, pl = ctx.mesh, seq.placements
    whole = [Replicate()] * mesh.ndim
    grad = [Partial() if isinstance(p, Shard) else Replicate() for p in pl]
    x = seq.to_local()
    for block in model.blocks:
        x = functional_call(block, {
            k: p.redistribute(mesh, whole).to_local(grad_placements=grad)
            for k, p in block.named_parameters()}, (x,))
    return DTensor.from_local(x, mesh, pl, run_check=False)


def bst_scores(model: BST, hist: torch.Tensor, target: torch.Tensor,
               user_feats: torch.Tensor,
               ctx: ShardCtx = NO_SHARD) -> torch.Tensor:
    """CTR logits [B]. hist [B, L]; target [B]; user_feats [B, W]."""
    b = hist.shape[0]
    e_hist, e_user = user_tower(model, hist, user_feats, ctx)
    e_tgt = ctx.shard(embedding_lookup(model.item_emb, target), ctx.dp,
                      None)[:, None, :]
    seq = encode(model, torch.cat([e_hist, e_tgt], dim=1)
                 + model.pos_emb[None], ctx)
    feats = ctx.shard(torch.cat([seq.reshape(b, -1), e_user], dim=-1),
                      ctx.dp, None)
    return model.mlp(feats, ctx=ctx)[..., 0]


def bst_loss(model: BST, batch: Mapping[str, torch.Tensor],
             ctx: ShardCtx = NO_SHARD
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Mean binary cross entropy of the logits against ``batch["label"]``
    in f32, in the stable form ``max(z, 0) - z y + log1p(exp(-|z|))``, and
    the accuracy of ``z > 0``: ``(loss, {"loss", "acc"})``."""
    logits = bst_scores(model, batch["hist"], batch["target"],
                        batch["user_feats"], ctx)
    labels = batch["label"].float()
    lf = logits.float()
    loss = (lf.clamp(min=0) - lf * labels
            + torch.log1p(torch.exp(-lf.abs()))).mean()
    acc = ((lf > 0) == (labels > 0.5)).float().mean()
    return loss, {"loss": loss, "acc": acc}


def bst_serve(model: BST, batch: Mapping[str, torch.Tensor],
              ctx: ShardCtx = NO_SHARD) -> torch.Tensor:
    """Online or bulk scoring: the sigmoid CTR of each (user, target)
    row, [B]."""
    return torch.sigmoid(bst_scores(model, batch["hist"], batch["target"],
                                    batch["user_feats"], ctx))


def bst_retrieval(model: BST, hist: torch.Tensor, user_feats: torch.Tensor,
                  cand_ids: torch.Tensor, chunk: Optional[int] = None,
                  ctx: ShardCtx = NO_SHARD) -> torch.Tensor:
    """One user (hist [1, L], user_feats [1, W]) against ``cand_ids`` [C]
    -> logits [C]. Each candidate is a row of the encoder's batch: the
    history (with its positions) broadcast beside the candidate at position
    L, through the first block, then the MLP with the user's bag, as the
    reference evaluates it (BST has one block). ``chunk``: candidates per
    pass (all at once when None); each row's score depends on its own
    candidate only. Under ``ctx`` the candidates lie over every mesh
    axis."""
    cfg = model.cfg
    L, d = cfg.seq_len, cfg.embed_dim
    e_hist, e_user = user_tower(model, hist, user_feats, ctx)
    cand_axis = tuple(a for ax in (ctx.dp, ctx.tp) if ax is not None
                      for a in ((ax,) if isinstance(ax, str) else ax)) \
        or None
    hist_tokens = (e_hist + model.pos_emb[None, :L])[0]      # [L, d]
    block = model.blocks[0]
    n = cand_ids.shape[0]
    step = n if chunk is None else chunk
    out = []
    for c0 in range(0, n, max(step, 1)):
        ids = cand_ids[c0:c0 + step]
        c = ids.shape[0]
        e_cand = ctx.shard(embedding_lookup(model.item_emb, ids)
                           + model.pos_emb[L], cand_axis, None)
        # (under a mesh the broadcast history takes the candidates' layout,
        # a local slice, rather than the candidates being gathered)
        seqs = torch.cat([ctx.shard(hist_tokens.expand(c, L, d), cand_axis,
                                    None, None), e_cand[:, None]],
                         dim=1)                              # [c, L+1, d]
        flat = block(seqs).reshape(c, -1)
        feats = torch.cat([flat, e_user.expand(c, d)], dim=-1)
        out.append(model.mlp(feats)[..., 0])
    return torch.cat(out) if out else cand_ids.new_zeros(0, dtype=cfg.dtype)


def bst_decay_mask(params: Mapping[str, torch.Tensor]) -> Dict[str, bool]:
    """Which of the named parameters AdamW decays: the reference's
    ``ndim >= 2`` on its own leaf, where each block's tensors are stacked
    into one ``[n_blocks, ...]`` leaf, so a ``blocks.<i>.`` tensor has one
    dimension more there (its layernorm gains and biases are decayed);
    the MLP's biases are not."""
    return {name: t.ndim + name.startswith("blocks.") >= 2
            for name, t in params.items()}
