"""Public kernel ops with the reference's semantics.

Counterpart of ``repro/kernels/ops.py``: the padded-set intersections,
flash attention and RMSNorm. Impl
resolution lives in :mod:`repro_torch.kernels.dispatch`: explicit
``impl=`` > ``REPRO_TORCH_<OP>_IMPL`` > the operand's device type. On a
CUDA tensor ``auto`` launches the hand-written kernel (or raises); the
plain versions of :mod:`repro_torch.kernels.ref` run there only when an
impl names them. On a CPU tensor ``auto`` picks a plain version, and
``impl="cuda"`` raises.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import dispatch, ref
from . import flash_attention as fa
from . import rmsnorm as rn
from .gather_intersect import gather_intersect_cuda
from .sorted_intersect import sorted_intersect_cuda


def _needs_grad(*tensors: torch.Tensor) -> bool:
    """Autograd records this call: the kernels go through their
    ``torch.autograd.Function`` (forward + backward kernel). Under
    ``inference_mode`` or ``no_grad`` (the serving path) it is False and
    the forward launches alone, with no ``lse``."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def _check_binary_operands(a: torch.Tensor, b: torch.Tensor,
                           sentinel: int) -> None:
    """Loud precondition check for ``impl='binary'``.

    The binary-search probe needs 2-D operands with a shared batch and
    ``b`` rows *fully ascending* with holes only in the tail (fresh DBQ
    rows are; INT results carry in-place holes — keep those on the ``a``
    side). Violations raise a ValueError up front.
    """
    if a.ndim != 2 or b.ndim != 2 or a.shape[0] != b.shape[0]:
        raise ValueError(
            "impl='binary' needs 2-D operands with a shared batch: got "
            f"a{tuple(a.shape)}, b{tuple(b.shape)}; pad/stack rows first "
            "or use impl='ref'")
    if b.numel() and bool((b[:, 1:] < b[:, :-1]).any()):
        raise ValueError(
            "impl='binary' needs b rows fully ascending with holes "
            "only in the tail (sentinel-padded DBQ rows); this b has "
            "out-of-order entries or interspersed holes — resort "
            "(torch.sort(b, dim=-1)) or use impl='ref'/'chunked'")


def intersect_padded(a: torch.Tensor, b: torch.Tensor, sentinel: int,
                     impl: str = "auto") -> torch.Tensor:
    """Row-wise padded-set intersection; see kernels/ref.py for semantics.

    a: int32[B, Da], b: int32[B, Db] (widths may differ) -> int32[B, Da].
    ``impl``: auto | cuda | ref | chunked | binary. ``binary`` needs ``b``
    rows fully ascending (holes only in the tail) and raises ValueError
    otherwise.
    """
    impl = dispatch.resolve_impl("intersect", impl,
                                 platform=a.device.type, width=a.shape[-1])
    if impl == "ref":
        return ref.sorted_intersect(a, b, sentinel)
    if impl == "chunked":
        return ref.sorted_intersect_chunked(a, b, sentinel)
    if impl == "binary":
        _check_binary_operands(a, b, sentinel)
        return ref.sorted_intersect_binary(a, b, sentinel)
    return sorted_intersect_cuda(a, b, sentinel)


def fused_gather_intersect(cand: torch.Tensor, ids: torch.Tensor,
                           rows: torch.Tensor, sentinel: int,
                           impl: str = "auto") -> torch.Tensor:
    """``cand[i] ∩ rows[ids[i]]`` without materializing ``rows[ids]``.

    cand int32[B, Dc] padded sets, ids int32[B] frontier row indices (any
    values — clipped to ``[0, sentinel]``, the all-sentinel row), rows
    int32[N+1, D] padded adjacency whose row N is all-sentinel. Returns
    int32[B, Dc] in ``cand``'s slots, bit-equal to
    ``intersect_padded(cand, rows[clip(ids)], sentinel)``.

    ``impl``: auto | cuda fuse on the card (csrc/gather_intersect.cu);
    ref | chunked | binary gather then intersect with that impl.
    """
    impl = dispatch.resolve_impl("gather_intersect", impl,
                                 platform=cand.device.type,
                                 width=rows.shape[-1])
    ids = ids.clamp(0, sentinel)
    if impl in ("ref", "chunked", "binary"):
        return intersect_padded(cand, rows.index_select(0, ids), sentinel,
                                impl=impl)
    return gather_intersect_cuda(ids, cand, rows, sentinel)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, scale: Optional[float] = None,
                    impl: str = "auto") -> torch.Tensor:
    """q: [B, Hq, Tq, d]; k, v: [B, Hkv, Tk, d] -> [B, Hq, Tq, d].

    ``impl``: auto | cuda (csrc/flash_attention.cu: strided views with a
    contiguous last dimension and 16-byte aligned strides, d <= 128) | ref
    (the plain version; autograd differentiates it). When autograd
    records the call, ``cuda`` goes through ``FlashAttentionFn``, whose
    backward is csrc/flash_attention_bwd.cu. See
    :func:`repro_torch.kernels.ref.flash_attention` for the masking.
    """
    impl = dispatch.resolve_impl("flash_attention", impl,
                                 platform=q.device.type)
    if impl == "ref":
        return ref.flash_attention(q, k, v, causal=causal, scale=scale)
    if _needs_grad(q, k, v):
        return fa.FlashAttentionFn.apply(q, k, v, causal, scale,
                                         fa.CUDA_PAIR)
    return fa.flash_attention_cuda(q, k, v, causal=causal, scale=scale)


def rmsnorm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-6,
            impl: str = "auto") -> torch.Tensor:
    """RMSNorm over the last axis; any leading dims.

    ``impl``: auto | cuda (csrc/rmsnorm.cu, contiguous x; under autograd
    through ``RMSNormFn``, whose backward is csrc/rmsnorm_bwd.cu) | ref
    (the plain version; autograd differentiates it).
    """
    impl = dispatch.resolve_impl("rmsnorm", impl, platform=x.device.type)
    if impl == "ref":
        return ref.rmsnorm(x, gamma, eps)
    shape = x.shape
    rows = x.reshape(-1, shape[-1])
    if _needs_grad(x, gamma):
        return rn.RMSNormFn.apply(rows, gamma, eps, rn.CUDA_PAIR
                                  ).reshape(shape)
    return rn.rmsnorm_cuda(rows, gamma, eps).reshape(shape)
