"""Attention layers: GQA (optional QKV bias) and MLA (DeepSeek-V2), with
prefill and KV-cache decode paths.

Counterpart of ``repro/layers/attention.py``. Layouts as in the
reference: activations ``[B, T, H, d]``, caches ``[B, S, Hkv, d]`` (GQA)
or ``[B, S, r]`` + ``[B, S, rope]`` (MLA).

* ``full_attention`` sends the full-sequence pass to the flash kernel
  (``kernels/ops.flash_attention``) with the **unexpanded** K and V: the
  kernel maps each q head to its KV head itself. The reference expands KV
  first (``_expand_kv``); the results are the same. q, k and v go in as
  ``[B, H, T, d]`` views of the ``[B, T, H, d]`` activations, uncopied.
* ``decode_attention`` stays plain torch, as the reference's is plain jnp:
  q heads are grouped against the unexpanded cache.
* MLA prefill expands the latent ``c_kv`` into per-head K (``[k_nope,
  k_rope]``, 192 wide at full width) and V (128 wide) and goes through the
  same flash kernel, which takes q and k wider than v. MLA decode stays
  plain torch in f32, as the reference's is plain jnp: the scores are
  taken in the latent space (matrix absorption), so the cache holds
  ``c_kv`` and ``k_rope`` only.
* The cache is updated in place (the reference returns new arrays), which
  saves a copy of the cache per step; a write past the cache's end raises
  where the reference's ``dynamic_update_slice`` clamps its start.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ..kernels import ops as kops
from .common import NO_SHARD, ShardCtx, _is_dtensor, dense_init, \
    merge_heads, rmsnorm, row_offset
from .rope import apply_rope

NEG_INF = -1e30


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, length: int,
                     scale: Optional[float] = None, group=None,
                     offset: int = 0) -> torch.Tensor:
    """Single-step GQA decode. q: [B, 1, Hq, d]; caches [B, S, Hkv, d];
    ``length``: number of valid cache entries. q head ``i`` reads KV head
    ``i // (Hq // Hkv)``; entries at or past ``length`` are masked with the
    finite ``NEG_INF``. With ``group`` (a sequence-sharded cache) the
    caches are this rank's block, which starts at position ``offset``,
    and the softmax and the context are combined across the group's
    ranks (:func:`_decode_softmax`)."""
    b, _, hq, d = q.shape
    s_max, hkv = k_cache.shape[1], k_cache.shape[2]
    g = hq // hkv
    if scale is None:
        scale = d ** -0.5
    qg = q.reshape(b, 1, hkv, g, d).float()
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k_cache.float()) * scale
    kpos = torch.arange(s_max, device=q.device)
    s = s.masked_fill(kpos >= length - offset, NEG_INF)
    p = _decode_softmax(s, group)
    out = _sum_over(torch.einsum("bkgqs,bskd->bqkgd", p, v_cache.float()),
                    group)
    return out.reshape(b, 1, hq, d).to(q.dtype)


def full_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   causal: bool = True, impl: str = "auto",
                   scale: Optional[float] = None) -> torch.Tensor:
    """q: [B, T, Hq, dqk]; k: [B, T, Hkv, dqk]; v: [B, T, Hkv, dv] ->
    [B, T, Hq, dv] through the flash op (``impl``: auto | cuda | ref) on
    head-major views, not copies: the kernel reads the strided views and
    writes its output in q's layout, so the result is a ``[B, T, Hq, dv]``
    tensor in memory."""
    out = kops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                               v.transpose(1, 2), causal=causal,
                               scale=scale, impl=impl)
    return out.transpose(1, 2)


def heads_block(x: torch.Tensor, h: int, d: int,
                ctx: ShardCtx) -> torch.Tensor:
    """This rank's heads of a DTensor ``x [B, T, h * d]`` as a local
    ``[b, T, hl, d]`` block, the heads laid over ``tp`` as GSPMD lays them
    out: ``h`` padded with zero heads to ``hl * n_tp`` (``hl =
    ceil(h / n_tp)``), rank ``i`` of tp holding heads ``[i * hl, (i + 1)
    * hl)``. When ``n_tp`` divides ``h`` that is x's local block over tp;
    else x is gathered whole over tp, and the block's gradient is a
    partial sum over tp (each rank's part is its own heads')."""
    n_tp, i = ctx.tp_block()
    hl = -(-h // n_tp)
    if h % n_tp == 0:
        loc = ctx.shard(x, ctx.dp, None, ctx.tp).to_local()
        return loc.view(loc.shape[0], loc.shape[1], hl, d)
    loc = _whole_over_tp(x, ctx)
    b, t = loc.shape[0], loc.shape[1]
    lo, hi = min(i * hl, h), min((i + 1) * hl, h)
    blk = loc.view(b, t, h, d)[:, :, lo:hi]
    if hi - lo < hl:
        blk = torch.cat([blk, blk.new_zeros((b, t, hl - (hi - lo), d))],
                        dim=2)
    return blk


def _whole_over_tp(x: torch.Tensor, ctx: ShardCtx) -> torch.Tensor:
    """The local rows of a DTensor ``x`` over ``ctx.dp``, whole over tp
    (gathered), for a rank that uses only part of them: the gradient is a
    partial sum over tp."""
    from torch.distributed.tensor import Partial
    x = ctx.shard(x, ctx.dp, None, None)
    tpd = ctx.tp_dims()
    return x.to_local(grad_placements=[
        Partial() if j in tpd else p for j, p in enumerate(x.placements)])


def kv_block(x: torch.Tensor, kvh: int, h: int, d: int,
             ctx: ShardCtx) -> torch.Tensor:
    """The kv heads ``x [B, T, kvh * d]`` that this rank's q heads
    (:func:`heads_block` of ``h`` heads) read, local. When ``n_tp``
    divides both head counts the rank's kv block serves its q block (the
    group ``h // kvh`` unchanged); else each local q head gets its own kv
    head (group 1), as the reference expands the kv heads to ``h`` before
    they are laid over tp (a padded head reads the last kv head: its q is
    zero)."""
    n_tp, i = ctx.tp_block()
    if h % n_tp == 0 and kvh % n_tp == 0:
        return heads_block(x, kvh, d, ctx)
    loc = _whole_over_tp(x, ctx)
    whole = loc.view(loc.shape[0], loc.shape[1], kvh, d)
    hl, g = -(-h // n_tp), h // kvh
    idx = torch.tensor([min(j, h - 1) // g for j in range(i * hl,
                                                           (i + 1) * hl)],
                       device=whole.device)
    return whole.index_select(2, idx)


def merge_heads_block(o: torch.Tensor, h: int, ctx: ShardCtx,
                      like: torch.Tensor) -> torch.Tensor:
    """The inverse of :func:`heads_block`: this rank's heads ``o [b, T,
    hl, dv]`` -> the DTensor ``[B, T, h * dv]`` laid over ``ctx.dp`` on
    its rows (as ``like``) and over ``tp`` on its width (the layout the
    output projection contracts: a block of heads when ``n_tp`` divides
    ``h``; else the padded heads gathered over tp, the padding cut, and
    the width split evenly again)."""
    from torch.distributed.tensor import DTensor, Shard
    n_tp, _ = ctx.tp_block()
    b, t, hl, dv = o.shape
    mesh, tpd = ctx.mesh, ctx.tp_dims()
    rows = ctx.placements(like, ctx.dp, None, None)
    wide = [Shard(2) if j in tpd else p for j, p in enumerate(rows)]
    flat = DTensor.from_local(o.reshape(b, t, hl * dv), mesh, wide,
                              run_check=False)
    if h % n_tp == 0:
        return flat
    whole = flat.redistribute(mesh, rows).to_local()[..., :h * dv]
    out = DTensor.from_local(whole, mesh, rows, run_check=False)
    return ctx.shard(out, ctx.dp, None, ctx.tp)


def _decode_softmax(s: torch.Tensor, group=None) -> torch.Tensor:
    """``softmax(s)`` over the last (key) axis. With ``group`` the keys
    are split across its ranks (a sequence-sharded cache): the partial
    max and sum of exponentials are all-reduced (flash-decode's combine),
    and each rank keeps the probabilities of its own keys."""
    if group is None:
        return torch.softmax(s, dim=-1)
    import torch.distributed._functional_collectives as funcol
    m = funcol.all_reduce(s.amax(dim=-1, keepdim=True), "max", group)
    e = torch.exp(s - m)
    return e / funcol.all_reduce(e.sum(dim=-1, keepdim=True), "sum", group)


def _sum_over(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over ``group``'s ranks (``x`` itself without one)."""
    if group is None:
        return x
    import torch.distributed._functional_collectives as funcol
    return funcol.all_reduce(x, "sum", group)


def _seq_sharded(t: torch.Tensor):
    """For a cache DTensor ``t`` ``[B, S, ...]`` whose sequence axis may
    be sharded: ``(the batch placements, the group of the sequence's
    ranks or None, this rank's first position)``."""
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate, Shard
    mesh = t.device_mesh
    seq = [i for i, p in enumerate(t.placements)
           if isinstance(p, Shard) and p.dim == 1]
    batch = [p if isinstance(p, Shard) and p.dim == 0 else Replicate()
             for p in t.placements]
    if not seq:
        group = None
    elif len(seq) == mesh.ndim:
        group = dist.group.WORLD
    elif len(seq) == 1:
        group = (mesh, seq[0])
    else:
        raise ValueError(f"cache placements {t.placements}: the sequence "
                         "must lie over one mesh axis or over all")
    # this rank's block of the (evenly split) sequence: its coordinate
    # along the sequence's mesh dims, major first
    coord, block = mesh.get_coordinate(), 0
    for i in seq:
        block = block * mesh.shape[i] + coord[i]
    return batch, group, block * t.to_local().shape[1]


def _write_local(cache_local: torch.Tensor, new: torch.Tensor,
                 pos: int) -> None:
    """Write the new entry at ``pos`` of this rank's block of the
    sequence, when it falls there."""
    if 0 <= pos < cache_local.shape[1]:
        cache_local[:, pos:pos + new.shape[1]] = new


def init_gqa_cache(b: int, s_max: int, n_kv: int, d_head: int,
                   dtype: torch.dtype, device=None) -> Dict:
    return {"k": torch.zeros((b, s_max, n_kv, d_head), dtype=dtype,
                             device=device),
            "v": torch.zeros((b, s_max, n_kv, d_head), dtype=dtype,
                             device=device),
            "length": 0}


class GQAAttention(nn.Module):
    """Grouped-query attention: ``wq [D, Hq*dh]``, ``wk``/``wv
    [D, Hkv*dh]``, ``wo [Hq*dh, D]`` in the reference's ``[in, out]``
    layout, plus ``bq``/``bk``/``bv`` (init 0) with QKV bias."""

    def __init__(self, d_model: int, n_heads: int, n_kv: int, d_head: int,
                 qkv_bias: bool, dtype: torch.dtype, gen: torch.Generator,
                 rope_theta: float = 10000.0):
        super().__init__()
        if n_heads % n_kv:
            raise ValueError(f"n_heads={n_heads} is not a multiple of "
                             f"n_kv={n_kv}")
        self.n_heads, self.n_kv, self.d_head = n_heads, n_kv, d_head
        self.rope_theta = rope_theta
        self.wq = nn.Parameter(dense_init(gen, (d_model, n_heads * d_head),
                                          dtype))
        self.wk = nn.Parameter(dense_init(gen, (d_model, n_kv * d_head),
                                          dtype))
        self.wv = nn.Parameter(dense_init(gen, (d_model, n_kv * d_head),
                                          dtype))
        self.wo = nn.Parameter(dense_init(gen, (n_heads * d_head, d_model),
                                          dtype))
        if qkv_bias:
            dev = gen.device
            self.bq = nn.Parameter(torch.zeros(n_heads * d_head, dtype=dtype,
                                               device=dev))
            self.bk = nn.Parameter(torch.zeros(n_kv * d_head, dtype=dtype,
                                               device=dev))
            self.bv = nn.Parameter(torch.zeros(n_kv * d_head, dtype=dtype,
                                               device=dev))
        else:
            self.bq = self.bk = self.bv = None

    def forward(self, x: torch.Tensor, positions: torch.Tensor,
                cache: Optional[Dict] = None, attn_impl: str = "auto",
                norm_impl: str = "auto", ctx: ShardCtx = NO_SHARD
                ) -> Tuple[torch.Tensor, Optional[Dict]]:
        """x: [B, T, D]. With ``cache`` (decode): T == 1 and the cache
        ``{k, v, length}`` is written in place; returns (out [B, T, D],
        the cache or None). ``norm_impl`` is MLA's (GQA has no norm)."""
        b, t, _ = x.shape
        h, kvh, dh = self.n_heads, self.n_kv, self.d_head
        w = ctx.weight
        q, k, v = x @ w(self.wq), x @ w(self.wk), x @ w(self.wv)
        if self.bq is not None:
            q, k, v = q + self.bq, k + self.bk, v + self.bv
        if cache is None and ctx.mesh is not None and _is_dtensor(q):
            out = self._attend_sharded(q, k, v, positions, attn_impl, ctx)
            return ctx.shard(out @ w(self.wo), ctx.dp, None, None), None
        q = ctx.shard(ctx.split_heads(q, h, dh), ctx.dp, None, ctx.tp, None)
        q = apply_rope(q, positions, self.rope_theta)
        k = apply_rope(ctx.split_heads(k, kvh, dh), positions,
                       self.rope_theta)
        v = ctx.split_heads(v, kvh, dh)

        if cache is not None and ctx.mesh is not None \
                and _is_dtensor(cache["k"]):
            out = self._decode_sharded(q, k, v, cache, ctx)
        elif cache is not None:
            length = cache["length"]
            s_max = cache["k"].shape[1]
            if length + t > s_max:
                raise ValueError(f"KV cache full: {length} + {t} tokens > "
                                 f"{s_max} slots")
            cache["k"][:, length:length + t] = k
            cache["v"][:, length:length + t] = v
            cache["length"] = length + t
            out = decode_attention(q, cache["k"], cache["v"], length + t)
        else:
            out = full_attention(q, k, v, causal=True, impl=attn_impl)
        out = merge_heads(out) @ w(self.wo)
        return ctx.shard(out, ctx.dp, None, None), cache

    def _attend_sharded(self, q, k, v, positions, attn_impl: str,
                        ctx: ShardCtx) -> torch.Tensor:
        """Causal attention over a mesh on this rank's heads (q, k, v the
        projections ``[B, T, width]``, DTensors): the heads over tp as
        GSPMD lays them out (:func:`heads_block`, :func:`kv_block`),
        RoPE and the flash op on the local blocks, the result laid out
        for the output projection (:func:`merge_heads_block`)."""
        h, kvh, dh = self.n_heads, self.n_kv, self.d_head
        ql = heads_block(q, h, dh, ctx)
        kl, vl = (kv_block(x, kvh, h, dh, ctx) for x in (k, v))
        first = row_offset(ctx.placements(q, ctx.dp, None, None), ctx.mesh,
                           ql.shape[0])
        pos = positions[first:first + ql.shape[0]]
        ql = apply_rope(ql, pos, self.rope_theta)
        kl = apply_rope(kl, pos, self.rope_theta)
        out = full_attention(ql, kl, vl, causal=True, impl=attn_impl)
        return merge_heads_block(out, h, ctx, q)

    def _decode_sharded(self, q, k, v, cache: Dict, ctx: ShardCtx):
        """:func:`decode_attention` on this rank's block of a cache whose
        sequence is sharded (decode_32k: over ``tp``; long_500k: over
        every axis), the softmax combined across the sequence's ranks.
        q, k, v and the output carry the cache's batch layout."""
        from torch.distributed.tensor import DTensor
        batch, group, first = _seq_sharded(cache["k"])
        mesh = ctx.mesh
        ql, kl, vl = (x.redistribute(mesh, batch).to_local()
                      for x in (q, k, v))
        kc, vc = cache["k"].to_local(), cache["v"].to_local()
        length = cache["length"]
        _write_local(kc, kl, length - first)
        _write_local(vc, vl, length - first)
        cache["length"] = length + 1
        out = decode_attention(ql, kc, vc, length + 1, group=group,
                               offset=first)
        return DTensor.from_local(out, mesh, batch, run_check=False)


# --------------------------------------------------------------------------
# MLA attention layer (DeepSeek-V2-Lite: no q compression)
# --------------------------------------------------------------------------


def mla_decode_attention(q_nope: torch.Tensor, q_rope: torch.Tensor,
                         ckv_cache: torch.Tensor, krope_cache: torch.Tensor,
                         wk_b: torch.Tensor, wv_b: torch.Tensor,
                         length: int, scale: float, group=None,
                         offset: int = 0) -> torch.Tensor:
    """Absorbed MLA decode in f32. q_nope [B, T, H, nope], q_rope
    [B, T, H, rope]; caches ``c_kv`` [B, S, r] and ``k_rope`` [B, S, rope];
    wk_b [r, H, nope], wv_b [r, H, v]. q_nope is taken into the latent
    space by wk_b, scored against ``c_kv`` (plus the rope part against
    ``k_rope``), and the latent context is expanded by wv_b. Entries at
    or past ``length`` are masked with ``NEG_INF``. ``group`` and
    ``offset`` as :func:`decode_attention`'s (the latent context is
    combined before the expansion). -> [B, T, H, v] f32."""
    q_lat = torch.einsum("bthn,rhn->bthr", q_nope.float(), wk_b.float())
    ckv = ckv_cache.float()
    s = torch.einsum("bthr,bsr->bhts", q_lat, ckv)
    s = s + torch.einsum("bthc,bsc->bhts", q_rope.float(),
                         krope_cache.float())
    s = s * scale
    kpos = torch.arange(ckv.shape[1], device=ckv.device)
    s = s.masked_fill(kpos >= length - offset, NEG_INF)
    p = _decode_softmax(s, group)
    ctx = _sum_over(torch.einsum("bhts,bsr->bthr", p, ckv), group)
    return torch.einsum("bthr,rhv->bthv", ctx, wv_b.float())


def init_mla_cache(b: int, s_max: int, kv_lora: int, qk_rope: int,
                   dtype: torch.dtype, device=None) -> Dict:
    return {"c_kv": torch.zeros((b, s_max, kv_lora), dtype=dtype,
                                device=device),
            "k_rope": torch.zeros((b, s_max, qk_rope), dtype=dtype,
                                  device=device),
            "length": 0}


class MLAAttention(nn.Module):
    """Multi-head latent attention: ``wq [D, H*(nope+rope)]``, ``wkv_a
    [D, r+rope]``, ``wkv_b [r, H*(nope+v)]``, ``wo [H*v, D]`` and the
    latent norm's gain ``norm_ckv [r]`` (init 1), in the reference's
    layout (``mla_params``)."""

    def __init__(self, d_model: int, n_heads: int, kv_lora: int,
                 qk_nope: int, qk_rope: int, v_dim: int, dtype: torch.dtype,
                 gen: torch.Generator, rope_theta: float = 10000.0):
        super().__init__()
        self.n_heads, self.kv_lora = n_heads, kv_lora
        self.qk_nope, self.qk_rope, self.v_dim = qk_nope, qk_rope, v_dim
        self.rope_theta = rope_theta
        self.wq = nn.Parameter(dense_init(
            gen, (d_model, n_heads * (qk_nope + qk_rope)), dtype))
        self.wkv_a = nn.Parameter(dense_init(gen, (d_model, kv_lora + qk_rope),
                                             dtype))
        self.wkv_b = nn.Parameter(dense_init(
            gen, (kv_lora, n_heads * (qk_nope + v_dim)), dtype))
        self.wo = nn.Parameter(dense_init(gen, (n_heads * v_dim, d_model),
                                          dtype))
        self.norm_ckv = nn.Parameter(torch.ones(kv_lora, dtype=dtype,
                                                device=gen.device))

    def forward(self, x: torch.Tensor, positions: torch.Tensor,
                cache: Optional[Dict] = None, attn_impl: str = "auto",
                norm_impl: str = "auto", ctx: ShardCtx = NO_SHARD
                ) -> Tuple[torch.Tensor, Optional[Dict]]:
        """x: [B, T, D]. Without ``cache``: the expanded prefill through
        the flash op (q and k ``nope + rope`` wide, v ``v`` wide, scale
        ``(nope + rope) ** -0.5``). With ``cache`` (decode): ``{c_kv,
        k_rope, length}`` written in place and the absorbed decode.
        Returns (out [B, T, D], the cache or None)."""
        b, t, _ = x.shape
        h, r = self.n_heads, self.kv_lora
        nope, rope_d, vd = self.qk_nope, self.qk_rope, self.v_dim
        scale = (nope + rope_d) ** -0.5
        w = ctx.weight
        q = (x @ w(self.wq)).reshape(b, t, h, nope + rope_d)
        q_nope = q[..., :nope]
        q_rope = apply_rope(q[..., nope:], positions, self.rope_theta)
        kv_a = x @ w(self.wkv_a)                          # [B, T, r + rope]
        # the norm kernel takes contiguous rows: the latent part of each
        # row of kv_a is copied out here ([B, T, r])
        c_kv = rmsnorm(kv_a[..., :r].contiguous(), self.norm_ckv,
                       impl=norm_impl)
        k_rope = apply_rope(kv_a[..., None, r:], positions,
                            self.rope_theta)              # [B, T, 1, rope]
        wkv_b = self.wkv_b.view(r, h, nope + vd)

        if cache is not None and ctx.mesh is not None \
                and _is_dtensor(cache["c_kv"]):
            out = self._decode_sharded(q_nope, q_rope, c_kv, k_rope, wkv_b,
                                       cache, scale, ctx).to(x.dtype)
        elif cache is not None:
            length = cache["length"]
            s_max = cache["c_kv"].shape[1]
            if length + t > s_max:
                raise ValueError(f"KV cache full: {length} + {t} tokens > "
                                 f"{s_max} slots")
            cache["c_kv"][:, length:length + t] = c_kv
            cache["k_rope"][:, length:length + t] = k_rope[:, :, 0]
            cache["length"] = length + t
            out = mla_decode_attention(
                q_nope, q_rope, cache["c_kv"], cache["k_rope"],
                wkv_b[..., :nope], wkv_b[..., nope:], length + t,
                scale).to(x.dtype)
        else:
            kv = (c_kv @ self.wkv_b).view(b, t, h, nope + vd)
            k = torch.cat([kv[..., :nope],
                           k_rope.expand(b, t, h, rope_d)], dim=-1)
            qq = ctx.shard(torch.cat([q_nope, q_rope], dim=-1), ctx.dp, None,
                           ctx.tp, None)
            # v is a view of kv, read in place by the kernel
            out = full_attention(qq, k, kv[..., nope:], causal=True,
                                 impl=attn_impl, scale=scale)
        out = merge_heads(out) @ w(self.wo)
        return ctx.shard(out, ctx.dp, None, None), cache

    def _decode_sharded(self, q_nope, q_rope, c_kv, k_rope, wkv_b,
                        cache: Dict, scale: float, ctx: ShardCtx):
        """:func:`mla_decode_attention` on this rank's block of a cache
        whose sequence is sharded, the softmax and the latent context
        combined across the sequence's ranks. -> [B, T, H, v] f32 in the
        cache's batch layout."""
        from torch.distributed.tensor import DTensor, Replicate
        batch, group, first = _seq_sharded(cache["c_kv"])
        mesh = ctx.mesh
        qn, qr, ck, kr = (x.redistribute(mesh, batch).to_local()
                          for x in (q_nope, q_rope, c_kv, k_rope))
        w = wkv_b.redistribute(mesh, [Replicate()] * mesh.ndim).to_local()
        ckv, krc = cache["c_kv"].to_local(), cache["k_rope"].to_local()
        length = cache["length"]
        _write_local(ckv, ck, length - first)
        _write_local(krc, kr[:, :, 0], length - first)
        cache["length"] = length + 1
        out = mla_decode_attention(qn, qr, ckv, krc, w[..., :self.qk_nope],
                                   w[..., self.qk_nope:], length + 1, scale,
                                   group=group, offset=first)
        return DTensor.from_local(out, mesh, batch, run_check=False)
