"""GQA attention (optional QKV bias) with prefill and KV-cache decode paths.

Counterpart of the GQA half of ``repro/layers/attention.py`` (MLA comes
with the MoE/MLA slice). Layouts as in the reference: activations
``[B, T, H, d]``, caches ``[B, S, Hkv, d]``.

* ``full_attention`` sends the full-sequence pass to the flash kernel
  (``kernels/ops.flash_attention``) with the **unexpanded** K and V: the
  kernel maps each q head to its KV head itself. The reference expands KV
  first (``_expand_kv``); the results are the same. q, k and v go in as
  ``[B, H, T, d]`` views of the ``[B, T, H, d]`` activations, uncopied.
* ``decode_attention`` stays plain torch, as the reference's is plain jnp:
  q heads are grouped against the unexpanded cache.
* The cache is updated in place (the reference returns new arrays), which
  saves a copy of the cache per step; a write past the cache's end raises
  where the reference's ``dynamic_update_slice`` clamps its start.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ..kernels import ops as kops
from .common import dense_init
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
    """q: [B, T, Hq, d]; k, v: [B, T, Hkv, d] -> [B, T, Hq, d] through the
    flash op (``impl``: auto | cuda | ref) on head-major views, not copies:
    the kernel reads the strided views and writes its output in q's
    layout, so the result is a ``[B, T, Hq, d]`` tensor in memory."""
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
                cache: Optional[Dict] = None, attn_impl: str = "auto"
                ) -> Tuple[torch.Tensor, Optional[Dict]]:
        """x: [B, T, D]. With ``cache`` (decode): T == 1 and the cache
        ``{k, v, length}`` is written in place; returns (out [B, T, D],
        the cache or None)."""
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
