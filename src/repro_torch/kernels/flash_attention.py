"""CUDA wrapper: flash attention (``csrc/flash_attention.cu``).

Replaces the Pallas TPU kernel ``flash_attention_pallas``
(``src/repro/kernels/flash_attention.py``). At the model's shapes the
work is bound by operations (``4*d`` flops per visible query-key pair).
For bf16 the kernel runs both products on the tensor cores (``wgmma``),
with K and V tiles brought in by TMA into a two-stage ring in shared
memory, one block per (q head, 128-row q tile); f32 inputs keep a scalar
body. It reads each q head's KV head by the GQA map itself and takes
strided ``[B, H, T, d]`` views, so a caller holding ``[B, T, H, d]``
activations passes their transposes without a copy (see the source's
header). Its plain version is :func:`repro_torch.kernels.ref.flash_attention`.

Training adds an optional ``lse`` output of the forward and the backward
kernel ``csrc/flash_attention_bwd.cu`` (the port's own: the Pallas kernel
has no VJP), bound into :class:`FlashAttentionFn`. The backward is bound
by operations too (five products of ``2*d`` flops a visible pair); it
runs its products as f32 FMAs on shared-memory tiles, deterministically
(no atomics: dk and dv sum the GQA group's q heads inside one block).
"""

from __future__ import annotations

import ctypes
from typing import Callable, NamedTuple, Optional, Tuple

import torch

from . import build, ref

#: launches of the forward kernel (``csrc/flash_attention.cu``) by
#: :func:`flash_attention_cuda` and :func:`flash_attention_lse_cuda` since
#: the last reset (callers set it to 0)
launches = 0
#: launches of the backward kernel (``csrc/flash_attention_bwd.cu``) by
#: :func:`flash_attention_bwd_cuda` since the last reset
bwd_launches = 0

#: TMA's alignment, in bytes, of a tensor's base address and of its strides
ALIGN = 16


def view_strides(name: str, t: torch.Tensor) -> Tuple[int, int, int]:
    """Element strides ``(batch, head, row)`` of a ``[B, H, T, d]`` view
    that the kernel can read in place, or ``ValueError``.

    The rules are TMA's: the last dimension has stride 1, the base address
    and every other stride are multiples of 16 bytes. The stride of a
    dimension of size 0 or 1 is never used, so it is not checked (and is
    returned as 16 bytes' worth of elements). Runs on any device.
    """
    if t.ndim != 4:
        raise ValueError(f"{name} must be 4-D [B, H, T, d], got "
                         f"{tuple(t.shape)}")
    if t.shape[3] > 1 and t.stride(3) != 1:
        raise ValueError(f"{name}: the last dimension must have stride 1, "
                         f"got strides {t.stride()}")
    size = t.element_size()
    if t.data_ptr() % ALIGN:
        raise ValueError(f"{name}: base address {t.data_ptr():#x} is not "
                         f"{ALIGN}-byte aligned")
    out = []
    for dim in range(3):
        s = t.stride(dim)
        if t.shape[dim] <= 1:
            s = ALIGN // size
        elif s < 0 or (s * size) % ALIGN:
            raise ValueError(f"{name}: stride {s} of dimension {dim} is not "
                             f"a multiple of {ALIGN} bytes (strides "
                             f"{t.stride()}, {size}-byte elements)")
        out.append(s)
    return out[0], out[1], out[2]


def _check_cuda(name: str, t: torch.Tensor, dtype: torch.dtype) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    build.dtype_code(t.dtype)


def _check_qkv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """The forward's input checks; returns the views' strides."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_cuda(name, t, q.dtype)
    strides = [view_strides(n, t) for n, t in (("q", q), ("k", k),
                                                ("v", v))]
    b, hq, tq, d = q.shape
    hkv = k.shape[1]
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"k{tuple(k.shape)} and v{tuple(v.shape)} must be "
                         f"[B, Hkv, Tk, d] for q{tuple(q.shape)}")
    if hkv == 0 or hq % hkv:
        raise ValueError(f"Hq={hq} is not a multiple of Hkv={hkv}")
    if d > 128 or d % 8:
        raise ValueError(f"d={d}: the kernel takes d <= 128, a multiple "
                         "of 8")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must share one device")
    return strides


def _forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             causal: bool, scale: Optional[float], with_lse: bool):
    global launches
    strides = _check_qkv(q, k, v)
    b, hq, tq, d = q.shape
    hkv, tk = k.shape[1], k.shape[2]
    if scale is None:
        scale = d ** -0.5
    out = torch.empty_like(q)
    lse = torch.empty((b, hq, tq), dtype=torch.float32,
                      device=q.device) if with_lse else None
    if q.numel() == 0:
        return out, lse
    strides.append(view_strides("out", out))
    flat = (ctypes.c_longlong * 12)(*[s for st in strides for s in st])
    lib = build.library("flash_attention")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(), b, hq, hkv, tq, tk, d, flat,
        int(bool(causal)), float(scale), build.dtype_code(q.dtype),
        q.device.index, stream)
    build.check(lib, err, "flash_attention")
    launches += 1
    return out, lse


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool = True,
                         scale: Optional[float] = None) -> torch.Tensor:
    """Attention on the card. q: [B, Hq, Tq, d]; k, v: [B, Hkv, Tk, d];
    CUDA views of one dtype (f32 or bf16) on one device that
    :func:`view_strides` accepts (not copied), with Hq a multiple of Hkv
    and d <= 128 a multiple of 8 -> [B, Hq, Tq, d] in q's dtype, laid out
    as ``torch.empty_like(q)`` lays it out (so a transposed
    ``[B, T, H, d]`` q gives a transposed ``[B, T, H, d]`` output).
    ``scale`` defaults to ``d ** -0.5``. Raises on any other input. The
    serving path: no ``lse`` is written.
    """
    return _forward(q, k, v, causal, scale, with_lse=False)[0]


def flash_attention_lse_cuda(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, causal: bool = True,
                             scale: Optional[float] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`flash_attention_cuda` that also returns the rows'
    log-sum-exp ``lse`` [B, Hq, Tq] f32 (see
    :func:`repro_torch.kernels.ref.flash_attention`), which
    :func:`flash_attention_bwd_cuda` reads. One launch of the same
    kernel."""
    return _forward(q, k, v, causal, scale, with_lse=True)


def flash_attention_bwd_cuda(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, out: torch.Tensor,
                             lse: torch.Tensor, dout: torch.Tensor,
                             causal: bool = True,
                             scale: Optional[float] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """``(dq, dk, dv)`` on the card (``csrc/flash_attention_bwd.cu``) from
    the forward's inputs, its output and ``lse``, and the output's
    gradient ``dout``. q, k, v and out take the forward's rules; ``dout``
    is read in place when :func:`view_strides` accepts it (autograd hands
    it over in out's layout) and made contiguous here otherwise. dq, dk
    and dv are laid out as ``torch.empty_like`` of q, k and v. The
    kernel's plain version is
    :func:`repro_torch.kernels.ref.flash_attention_backward`."""
    global bwd_launches
    strides = _check_qkv(q, k, v)
    b, hq, tq, d = q.shape
    hkv, tk = k.shape[1], k.shape[2]
    for name, t in (("out", out), ("dout", dout)):
        _check_cuda(name, t, q.dtype)
        if t.shape != q.shape:
            raise ValueError(f"{name}{tuple(t.shape)} must have q's shape "
                             f"{tuple(q.shape)}")
    _check_cuda("lse", lse, torch.float32)
    if lse.shape != (b, hq, tq) or not lse.is_contiguous():
        raise ValueError(f"lse must be a contiguous [B, Hq, Tq] = "
                         f"{(b, hq, tq)} f32 tensor, got {tuple(lse.shape)}")
    if scale is None:
        scale = d ** -0.5
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    if q.numel() == 0 or k.numel() == 0:
        # no pair of a query and a key: no gradient reaches q, k or v
        return dq.zero_(), dk.zero_(), dv.zero_()
    try:
        dout_strides = view_strides("dout", dout)
    except ValueError:
        dout = dout.contiguous()
        dout_strides = view_strides("dout", dout)
    strides += [view_strides("out", out), dout_strides]
    strides += [view_strides(n, t) for n, t in (("dq", dq), ("dk", dk),
                                                 ("dv", dv))]
    flat = (ctypes.c_longlong * 24)(*[s for st in strides for s in st])
    scratch = torch.empty((b, hq, tq), dtype=torch.float32, device=q.device)
    lib = build.library("flash_attention_bwd")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.flash_attention_bwd_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        dout.data_ptr(), lse.data_ptr(), scratch.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), b, hq, hkv, tq, tk, d, flat,
        int(bool(causal)), float(scale), build.dtype_code(q.dtype),
        q.device.index, stream)
    build.check(lib, err, "flash_attention_bwd")
    bwd_launches += 1
    return dq, dk, dv


class FlashPair(NamedTuple):
    """A forward that returns ``(out, lse)`` and the backward that reads
    them, with the signatures of :func:`flash_attention_lse_cuda` and
    :func:`flash_attention_bwd_cuda`."""
    forward: Callable
    backward: Callable


#: the kernels: the training path on the card
CUDA_PAIR = FlashPair(flash_attention_lse_cuda, flash_attention_bwd_cuda)
#: the plain versions, for the CPU tests of :class:`FlashAttentionFn`
PLAIN_PAIR = FlashPair(
    lambda q, k, v, causal, scale: ref.flash_attention(
        q, k, v, causal=causal, scale=scale, return_lse=True),
    ref.flash_attention_backward)


class FlashAttentionFn(torch.autograd.Function):
    """Flash attention with a gradient: ``pair.forward`` gives the output
    and ``lse``; q, k, v, the output and ``lse`` are saved, and
    ``pair.backward`` computes dq, dk, dv from them. ``apply(q, k, v,
    causal, scale, pair)``; ``ops.flash_attention`` passes
    :data:`CUDA_PAIR` when an input requires grad on the card."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, pair):
        out, lse = pair.forward(q, k, v, causal, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale, ctx.pair = causal, scale, pair
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = ctx.pair.backward(q, k, v, out, lse, dout,
                                       ctx.causal, ctx.scale)
        return dq, dk, dv, None, None, None
