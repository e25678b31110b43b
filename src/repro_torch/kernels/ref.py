"""Plain PyTorch versions of the port's kernels.

These define the semantics the CUDA kernels in ``csrc/`` must reproduce:
bit for bit for the set intersections, within a stated float tolerance
for attention and RMSNorm. The CPU runs them directly, and
``chip_smoke.py`` holds each kernel against them on the card. Counterpart of ``repro/kernels/ref.py``
with the attention and norm oracles beside the padded-set ones.

Padded-set convention
---------------------
A vertex set is an ``int32[D]`` row. Entries equal to the *sentinel* (the
number of real vertices, ``N``) are holes; valid entries are strictly
ascending among themselves. Intersection keeps entries of ``a`` that are
members of ``b`` **in place** (order- and position-preserving), so results
stay valid padded sets without compaction.
"""

from __future__ import annotations

from typing import Optional

import torch

#: the flash kernel's finite mask value (``NEG_INF`` of the Pallas kernel
#: ``src/repro/kernels/flash_attention.py``); never ``-inf``
NEG_INF = -1e30


def sorted_intersect(a: torch.Tensor, b: torch.Tensor,
                     sentinel: int) -> torch.Tensor:
    """Row-wise padded-set intersection ``a ∩ b`` (kept in ``a``'s slots).

    a: int32[..., Da], b: int32[..., Db] padded sets. Returns
    int32[..., Da]. Materializes the ``[..., Da, Db]`` compare.
    """
    member = (a[..., :, None] == b[..., None, :]).any(dim=-1)
    return a.masked_fill(~(member & (a != sentinel)), sentinel)


def sorted_intersect_binary(a: torch.Tensor, b: torch.Tensor,
                            sentinel: int) -> torch.Tensor:
    """Membership by per-row binary search: O(Da log Db).

    Requirement: ``b`` rows must be fully ascending with holes only in the
    tail (fresh DBQ rows are; INT results are not — keep them on the
    ``a`` side, which tolerates interspersed holes).
    """
    idx = torch.searchsorted(b.contiguous(), a.contiguous())
    idx = idx.clamp(0, b.shape[-1] - 1)
    found = torch.gather(b, -1, idx) == a
    return a.masked_fill(~(found & (a != sentinel)), sentinel)


def sorted_intersect_chunked(a: torch.Tensor, b: torch.Tensor,
                             sentinel: int, chunk: int = 128
                             ) -> torch.Tensor:
    """Same semantics in O(Da * chunk) memory per row: a loop over
    ``chunk``-wide slices of ``b`` (the reference's ``lax.scan``)."""
    d = b.shape[-1]
    pad = (-d) % chunk
    if pad:
        b = torch.cat([b, b.new_full(b.shape[:-1] + (pad,), sentinel)],
                      dim=-1)
    member = torch.zeros(a.shape, dtype=torch.bool, device=a.device)
    for k in range(0, b.shape[-1], chunk):
        bk = b[..., k:k + chunk]
        member |= (a[..., :, None] == bk[..., None, :]).any(dim=-1)
    return a.masked_fill(~(member & (a != sentinel)), sentinel)


# --------------------------------------------------------------------------
# flash_attention (plain softmax attention with the kernel's masking)
# --------------------------------------------------------------------------


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, scale: Optional[float] = None
                    ) -> torch.Tensor:
    """Attention in f32. q: [B, Hq, Tq, d]; k, v: [B, Hkv, Tk, d] ->
    [B, Hq, Tq, d] in q's dtype.

    GQA: Hq is a multiple of Hkv and q head ``i`` reads kv head
    ``i // (Hq // Hkv)`` (grouped, the cache is never expanded). Causal
    masking is aligned bottom-right: query ``i`` sees keys
    ``<= i + (Tk - Tq)``. Masked scores are the finite ``NEG_INF``, as in
    the Pallas kernel this replaces, so a row that sees no key at all
    (causal with ``Tk < Tq``) comes out as the mean of V over all Tk
    keys. (``repro.kernels.ref.flash_attention`` masks with ``-inf`` and
    gives NaN there; the port follows the kernel.)
    """
    b, hq, tq, d = q.shape
    hkv, tk = k.shape[1], k.shape[2]
    if hq % hkv:
        raise ValueError(f"Hq={hq} is not a multiple of Hkv={hkv}")
    if scale is None:
        scale = d ** -0.5
    qg = q.float().reshape(b, hkv, hq // hkv, tq, d)
    s = torch.einsum("bkgqd,bksd->bkgqs", qg, k.float()) * scale
    if causal:
        qpos = torch.arange(tq, device=q.device)[:, None] + (tk - tq)
        kpos = torch.arange(tk, device=q.device)[None, :]
        s = s.masked_fill(kpos > qpos, NEG_INF)
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqs,bksd->bkgqd", w, v.float())
    return out.reshape(b, hq, tq, d).to(q.dtype)


# --------------------------------------------------------------------------
# rmsnorm
# --------------------------------------------------------------------------


def rmsnorm(x: torch.Tensor, gamma: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm over the last axis: ``x * rsqrt(mean(x^2) + eps) * gamma``
    in f32, cast once to x's dtype (the normalised x is not rounded before
    the gamma product)."""
    xf = x.float()
    ms = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * gamma.float()).to(x.dtype)
