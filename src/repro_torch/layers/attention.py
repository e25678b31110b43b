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
from .common import dense_init, rmsnorm
from .rope import apply_rope

NEG_INF = -1e30


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, length: int,
                     scale: Optional[float] = None) -> torch.Tensor:
    """Single-step GQA decode. q: [B, 1, Hq, d]; caches [B, S, Hkv, d];
    ``length``: number of valid cache entries. q head ``i`` reads KV head
    ``i // (Hq // Hkv)``; entries at or past ``length`` are masked with the
    finite ``NEG_INF``."""
    b, _, hq, d = q.shape
    s_max, hkv = k_cache.shape[1], k_cache.shape[2]
    g = hq // hkv
    if scale is None:
        scale = d ** -0.5
    qg = q.reshape(b, 1, hkv, g, d).float()
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k_cache.float()) * scale
    kpos = torch.arange(s_max, device=q.device)
    s = s.masked_fill(kpos >= length, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", p, v_cache.float())
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
                norm_impl: str = "auto"
                ) -> Tuple[torch.Tensor, Optional[Dict]]:
        """x: [B, T, D]. With ``cache`` (decode): T == 1 and the cache
        ``{k, v, length}`` is written in place; returns (out [B, T, D],
        the cache or None). ``norm_impl`` is MLA's (GQA has no norm)."""
        b, t, _ = x.shape
        h, kvh, dh = self.n_heads, self.n_kv, self.d_head
        q, k, v = x @ self.wq, x @ self.wk, x @ self.wv
        if self.bq is not None:
            q, k, v = q + self.bq, k + self.bk, v + self.bv
        q = apply_rope(q.reshape(b, t, h, dh), positions, self.rope_theta)
        k = apply_rope(k.reshape(b, t, kvh, dh), positions, self.rope_theta)
        v = v.reshape(b, t, kvh, dh)

        if cache is not None:
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
        out = out.reshape(b, t, h * dh) @ self.wo
        return out, cache


# --------------------------------------------------------------------------
# MLA attention layer (DeepSeek-V2-Lite: no q compression)
# --------------------------------------------------------------------------


def mla_decode_attention(q_nope: torch.Tensor, q_rope: torch.Tensor,
                         ckv_cache: torch.Tensor, krope_cache: torch.Tensor,
                         wk_b: torch.Tensor, wv_b: torch.Tensor,
                         length: int, scale: float) -> torch.Tensor:
    """Absorbed MLA decode in f32. q_nope [B, T, H, nope], q_rope
    [B, T, H, rope]; caches ``c_kv`` [B, S, r] and ``k_rope`` [B, S, rope];
    wk_b [r, H, nope], wv_b [r, H, v]. q_nope is taken into the latent
    space by wk_b, scored against ``c_kv`` (plus the rope part against
    ``k_rope``), and the latent context is expanded by wv_b. Entries at
    or past ``length`` are masked with ``NEG_INF``. -> [B, T, H, v] f32."""
    q_lat = torch.einsum("bthn,rhn->bthr", q_nope.float(), wk_b.float())
    ckv = ckv_cache.float()
    s = torch.einsum("bthr,bsr->bhts", q_lat, ckv)
    s = s + torch.einsum("bthc,bsc->bhts", q_rope.float(),
                         krope_cache.float())
    s = s * scale
    kpos = torch.arange(ckv.shape[1], device=ckv.device)
    s = s.masked_fill(kpos >= length, NEG_INF)
    p = torch.softmax(s, dim=-1)
    ctx = torch.einsum("bhts,bsr->bthr", p, ckv)
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
                norm_impl: str = "auto"
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
        q = (x @ self.wq).reshape(b, t, h, nope + rope_d)
        q_nope = q[..., :nope]
        q_rope = apply_rope(q[..., nope:], positions, self.rope_theta)
        kv_a = x @ self.wkv_a                             # [B, T, r + rope]
        # the norm kernel takes contiguous rows: the latent part of each
        # row of kv_a is copied out here ([B, T, r])
        c_kv = rmsnorm(kv_a[..., :r].contiguous(), self.norm_ckv,
                       impl=norm_impl)
        k_rope = apply_rope(kv_a[..., None, r:], positions,
                            self.rope_theta)              # [B, T, 1, rope]
        wkv_b = self.wkv_b.view(r, h, nope + vd)

        if cache is not None:
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
            qq = torch.cat([q_nope, q_rope], dim=-1)
            # v is a view of kv, read in place by the kernel
            out = full_attention(qq, k, kv[..., nope:], causal=True,
                                 impl=attn_impl, scale=scale)
        out = out.reshape(b, t, h * vd) @ self.wo
        return out, cache
