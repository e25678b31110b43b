"""Plain PyTorch versions of the set-intersection kernels.

These define the semantics the CUDA kernels in ``csrc/`` must reproduce
bit for bit; the CPU runs them directly, and ``chip_smoke.py`` holds each
kernel against them on the card. Counterpart of ``repro/kernels/ref.py``
(the padded-set half; the attention and norm oracles belong to a later
slice).

Padded-set convention
---------------------
A vertex set is an ``int32[D]`` row. Entries equal to the *sentinel* (the
number of real vertices, ``N``) are holes; valid entries are strictly
ascending among themselves. Intersection keeps entries of ``a`` that are
members of ``b`` **in place** (order- and position-preserving), so results
stay valid padded sets without compaction.
"""

from __future__ import annotations

import torch


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
