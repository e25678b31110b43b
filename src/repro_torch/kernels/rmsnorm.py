"""CUDA wrapper: RMSNorm over the last axis (``csrc/rmsnorm.cu``).

Replaces the Pallas TPU kernel ``rmsnorm_pallas``
(``src/repro/kernels/rmsnorm.py``). The kernel is memory-bound: it reads
``R*d`` elements of x and ``d`` of gamma and writes ``R*d``; one block per
row sums the squares in f32 from 16-byte vector loads and writes
``x * rsqrt(mean(x^2) + eps) * gamma`` cast once to x's dtype (see the
source's header). Its plain version is
:func:`repro_torch.kernels.ref.rmsnorm`.
"""

from __future__ import annotations

import torch

from . import build

#: launches of the CUDA kernel by :func:`rmsnorm_cuda` since the last
#: reset (callers set it to 0)
launches = 0


def check_float_cuda(name: str, t: torch.Tensor, ndim: int,
                     dtype: torch.dtype) -> None:
    """Raise unless ``t`` is a contiguous ``ndim``-D CUDA tensor of
    ``dtype`` (f32 or bf16)."""
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    build.dtype_code(t.dtype)
    if t.ndim != ndim:
        raise ValueError(f"{name} must be {ndim}-D, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def rmsnorm_cuda(x: torch.Tensor, gamma: torch.Tensor,
                 eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm of the rows of x on the card.

    x: [R, d] and gamma: [d], contiguous CUDA tensors of one dtype (f32 or
    bf16) on one device -> [R, d] in x's dtype. Raises on any other input.
    """
    global launches
    check_float_cuda("x", x, 2, x.dtype)
    check_float_cuda("gamma", gamma, 1, x.dtype)
    if gamma.shape[0] != x.shape[1] or gamma.device != x.device:
        raise ValueError(f"gamma{tuple(gamma.shape)} must be [d] on x's "
                         f"device for x{tuple(x.shape)}")
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    lib = build.library("rmsnorm")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.rmsnorm_launch(
        x.data_ptr(), gamma.data_ptr(), out.data_ptr(), x.shape[0],
        x.shape[1], float(eps), build.dtype_code(x.dtype), x.device.index,
        stream)
    build.check(lib, err, "rmsnorm")
    launches += 1
    return out
