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
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import build

#: launches of the CUDA kernel by :func:`flash_attention_cuda` since the
#: last reset (callers set it to 0)
launches = 0

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


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool = True,
                         scale: Optional[float] = None) -> torch.Tensor:
    """Attention on the card. q: [B, Hq, Tq, d]; k, v: [B, Hkv, Tk, d];
    CUDA views of one dtype (f32 or bf16) on one device that
    :func:`view_strides` accepts (not copied), with Hq a multiple of Hkv
    and d <= 128 a multiple of 8 -> [B, Hq, Tq, d] in q's dtype, laid out
    as ``torch.empty_like(q)`` lays it out (so a transposed
    ``[B, T, H, d]`` q gives a transposed ``[B, T, H, d]`` output).
    ``scale`` defaults to ``d ** -0.5``. Raises on any other input.
    """
    global launches
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_cuda(name, t, q.dtype)
    strides = [view_strides(n, t) for n, t in (("q", q), ("k", k),
                                                ("v", v))]
    b, hq, tq, d = q.shape
    hkv, tk = k.shape[1], k.shape[2]
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
    if scale is None:
        scale = d ** -0.5
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    strides.append(view_strides("out", out))
    flat = (ctypes.c_longlong * 12)(*[s for st in strides for s in st])
    lib = build.library("flash_attention")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, hq,
        hkv, tq, tk, d, flat, int(bool(causal)), float(scale),
        build.dtype_code(q.dtype), q.device.index, stream)
    build.check(lib, err, "flash_attention")
    launches += 1
    return out
