"""CUDA wrapper: flash attention (``csrc/flash_attention.cu``).

Replaces the Pallas TPU kernel ``flash_attention_pallas``
(``src/repro/kernels/flash_attention.py``). At the model's shapes the
work is bound by operations (``4*d`` flops per visible query-key pair);
this first kernel does them with f32 FMAs on the CUDA cores, one block
per (q head, 64-row q tile) looping over 64-key K/V tiles in shared
memory with an online softmax, and reads each q head's KV head by the
GQA map itself (see the source's header). Its plain version is
:func:`repro_torch.kernels.ref.flash_attention`.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import build
from .rmsnorm import check_float_cuda

#: launches of the CUDA kernel by :func:`flash_attention_cuda` since the
#: last reset (callers set it to 0)
launches = 0


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool = True,
                         scale: Optional[float] = None) -> torch.Tensor:
    """Attention on the card. q: [B, Hq, Tq, d]; k, v: [B, Hkv, Tk, d];
    contiguous CUDA tensors of one dtype (f32 or bf16) on one device, with
    Hq a multiple of Hkv and d <= 128 a multiple of 8 -> [B, Hq, Tq, d] in
    q's dtype. ``scale`` defaults to ``d ** -0.5``. Raises on any other
    input.
    """
    global launches
    for name, t in (("q", q), ("k", k), ("v", v)):
        check_float_cuda(name, t, 4, q.dtype)
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
    lib = build.library("flash_attention")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, hq,
        hkv, tq, tk, d, int(bool(causal)), float(scale),
        build.dtype_code(q.dtype), q.device.index, stream)
    build.check(lib, err, "flash_attention")
    launches += 1
    return out
