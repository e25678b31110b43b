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

import math
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


def _causal_mask(tq: int, tk: int, device) -> torch.Tensor:
    """``[Tq, Tk]`` True where query ``i`` must not see key ``j``: the
    causal mask aligned bottom-right (``j > i + (Tk - Tq)``)."""
    qpos = torch.arange(tq, device=device)[:, None] + (tk - tq)
    return torch.arange(tk, device=device)[None, :] > qpos


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, scale: Optional[float] = None,
                    return_lse: bool = False):
    """Attention in f32. q: [B, Hq, Tq, dqk]; k: [B, Hkv, Tk, dqk]; v:
    [B, Hkv, Tk, dv] -> [B, Hq, Tq, dv] in q's dtype (MLA attends with
    ``dqk != dv``); with ``return_lse`` also the row log-sum-exp ``lse``
    [B, Hq, Tq] f32 that the backward reads. ``scale`` defaults to
    ``dqk ** -0.5``.

    GQA: Hq is a multiple of Hkv and q head ``i`` reads kv head
    ``i // (Hq // Hkv)`` (grouped, the cache is never expanded). Causal
    masking is aligned bottom-right: query ``i`` sees keys
    ``<= i + (Tk - Tq)``. Masked scores are the finite ``NEG_INF``, as in
    the Pallas kernel this replaces, so a row that sees no key at all
    (causal with ``Tk < Tq``) comes out as the mean of V over all Tk
    keys. (``repro.kernels.ref.flash_attention`` masks with ``-inf`` and
    gives NaN there; the port follows the kernel.)

    ``lse`` is ``logsumexp`` of the scaled, masked scores. For a row that
    sees no key it is ``log(Tk)``: the log-sum-exp with the masked scores
    read as 0 rather than ``NEG_INF`` (the same softmax, shifted), since
    ``NEG_INF + log(Tk)`` rounds to ``NEG_INF`` in f32 and would lose the
    row's weights ``1 / Tk``. The kernel writes the same value.
    """
    b, hq, tq, d = q.shape
    hkv, tk, dv = k.shape[1], k.shape[2], v.shape[3]
    if hq % hkv:
        raise ValueError(f"Hq={hq} is not a multiple of Hkv={hkv}")
    if scale is None:
        scale = d ** -0.5
    qg = q.float().reshape(b, hkv, hq // hkv, tq, d)
    s = torch.einsum("bkgqd,bksd->bkgqs", qg, k.float()) * scale
    if causal:
        mask = _causal_mask(tq, tk, q.device)
        s = s.masked_fill(mask, NEG_INF)
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqs,bksd->bkgqd", w, v.float())
    out = out.reshape(b, hq, tq, dv).to(q.dtype)
    if not return_lse:
        return out
    lse = torch.logsumexp(s, dim=-1)
    if causal:
        lse = torch.where(mask.all(dim=-1), math.log(tk), lse)
    return out, lse.reshape(b, hq, tq)


def flash_attention_backward(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, out: torch.Tensor,
                             lse: torch.Tensor, dout: torch.Tensor,
                             causal: bool = True,
                             scale: Optional[float] = None):
    """The gradients ``(dq, dk, dv)`` of :func:`flash_attention`, by the
    explicit formulas in f32 (not autograd), each cast to its input's
    dtype:

        P  = exp(scale * q k^T + mask - lse)     (recomputed from lse)
        D  = rowsum(dout * out)
        dS = P * (dout v^T - D), 0 where masked
        dq = scale * dS k,  dk = scale * dS^T q,  dv = P^T dout

    dk and dv sum over the q heads of each kv head's group. A masked
    score has no gradient (the forward replaces it by a constant); a row
    that sees no key has ``lse = log(Tk)`` and reads its masked scores as
    0, so it gives each key ``dv += dout / Tk`` and no dq, dk. v, out and
    dout may be narrower than q and k (``dv != dqk``), as in the forward.
    """
    b, hq, tq, d = q.shape
    hkv, tk, dv = k.shape[1], k.shape[2], v.shape[3]
    g = hq // hkv
    if scale is None:
        scale = d ** -0.5
    qg = q.float().reshape(b, hkv, g, tq, d)
    dog = dout.float().reshape(b, hkv, g, tq, dv)
    kf, vf = k.float(), v.float()
    s = torch.einsum("bkgqd,bksd->bkgqs", qg, kf) * scale
    if causal:
        mask = _causal_mask(tq, tk, q.device)
        none = mask.all(dim=-1, keepdim=True)       # rows that see no key
        s = s.masked_fill(mask, NEG_INF).masked_fill(mask & none, 0.0)
    p = torch.exp(s - lse.float().reshape(b, hkv, g, tq, 1))
    dp = torch.einsum("bkgqd,bksd->bkgqs", dog, vf)
    rows = (dog * out.float().reshape(b, hkv, g, tq, dv)).sum(-1)
    ds = p * (dp - rows[..., None])
    if causal:
        ds = ds.masked_fill(mask, 0.0)
    dq = torch.einsum("bkgqs,bksd->bkgqd", ds, kf) * scale
    dk = torch.einsum("bkgqs,bkgqd->bksd", ds, qg) * scale
    dv = torch.einsum("bkgqs,bkgqd->bksd", p, dog)
    return (dq.reshape(b, hq, tq, d).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


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


def rmsnorm_backward(x: torch.Tensor, gamma: torch.Tensor, g: torch.Tensor,
                     eps: float = 1e-6):
    """The gradients ``(dx, dgamma)`` of :func:`rmsnorm` for the output
    gradient ``g``, by the explicit formulas in f32 (not autograd):

        rstd = rsqrt(mean(x^2) + eps),  xhat = x * rstd
        dx     = rstd * (g*gamma - xhat * mean(g*gamma*xhat))
        dgamma = sum over rows of g * xhat

    each cast once to its input's dtype (x's, gamma's)."""
    xf, gf, gam = x.float(), g.float(), gamma.float()
    rstd = torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    xhat = xf * rstd
    gg = gf * gam
    dx = rstd * (gg - xhat * (gg * xhat).mean(dim=-1, keepdim=True))
    dgamma = (gf * xhat).reshape(-1, x.shape[-1]).sum(dim=0)
    return dx.to(x.dtype), dgamma.to(gamma.dtype)
