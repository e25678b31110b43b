"""CUDA wrapper: RMSNorm over the last axis (``csrc/rmsnorm.cu``).

Replaces the Pallas TPU kernel ``rmsnorm_pallas``
(``src/repro/kernels/rmsnorm.py``). The kernel is memory-bound: it reads
``R*d`` elements of x and ``d`` of gamma and writes ``R*d``, and computes
``x * rsqrt(mean(x^2) + eps) * gamma`` in f32, cast once to x's dtype.
:func:`rmsnorm_plan` picks its body from the shape and the alignment
before the launch:

* ``register``: d a multiple of the 16-byte vector (8 bf16, 4 f32), x and
  gamma 16-byte aligned, the row within ``32 * MAX_WARPS * SLOTS``
  vectors. A group of ``32 * warps`` lanes (the fewest of 1, 2, 4, 8
  warps) owns a row and holds it and gamma in registers, ``SLOTS``
  vectors a lane, so the row is read once; one block per tile of
  ``rows_per_block`` rows. qwen2-0.5b's d = 896 in bf16 is one warp a
  row, 3.5 slots a lane, 8 rows a block; 2048 takes 2 warps and 3072 4;
* ``block``: any other input (d not a multiple of the vector, a view
  that is not 16-byte aligned, d too wide for registers): one block of up
  to ``MAX_THREADS`` threads per row, 16-byte loads where d and the
  alignment allow them, else single elements.

Its plain version is :func:`repro_torch.kernels.ref.rmsnorm`.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from . import build

#: launches of the CUDA kernel by :func:`rmsnorm_cuda` since the last
#: reset (callers set it to 0)
launches = 0
#: the same launches by body (callers set each to 0 with ``launches``)
body_launches = {"register": 0, "block": 0}

#: threads a block, at most (``kMaxThreads`` in the source)
MAX_THREADS = 256
#: register body: 16-byte vectors of a row a lane holds (``kSlots`` in
#: the source), and the most warps a row
SLOTS, MAX_WARPS = 4, 8
#: the body code the C launcher takes
BODY_CODES = {"block": 0, "register": 1}
_ELEM_BYTES = {torch.float32: 4, torch.bfloat16: 2}


class RmsnormPlan(NamedTuple):
    """How one launch covers ``[R, d]``: ``vec`` elements a load (16 bytes'
    worth, or 1), a group of ``warps`` warps a row, ``rows_per_block``
    groups a block, ``grid`` blocks."""
    body: str
    vec: int
    warps: int
    rows_per_block: int
    grid: int

    @property
    def threads(self) -> int:
        return 32 * self.warps * self.rows_per_block


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=512)
def rmsnorm_plan(R: int, d: int, dtype: torch.dtype,
                 aligned: bool) -> RmsnormPlan:
    """The launch plan for x ``[R, d]`` of ``dtype`` (f32 or bf16);
    ``aligned``: x and gamma start on 16-byte boundaries. Runs on any
    device."""
    vec = 16 // _ELEM_BYTES[dtype]
    nvec = d // vec
    if aligned and d % vec == 0 and nvec <= 32 * MAX_WARPS * SLOTS:
        warps = 1
        while 32 * warps * SLOTS < nvec:
            warps *= 2
        rows = max(1, min(MAX_THREADS // (32 * warps), R))
        return RmsnormPlan("register", vec, warps, rows, _ceil_div(R, rows))
    vec = vec if aligned and d % vec == 0 else 1
    threads = min(MAX_THREADS, max(32, _ceil_div(d // vec, 32) * 32))
    return RmsnormPlan("block", vec, threads // 32, 1, R)


@functools.lru_cache(maxsize=None)
def _launcher():
    """The bound C launch function, built and loaded at first use."""
    return build.library("rmsnorm").rmsnorm_launch


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
    R, d = x.shape
    xp, gp = x.data_ptr(), gamma.data_ptr()
    plan = rmsnorm_plan(R, d, x.dtype, xp % 16 == 0 and gp % 16 == 0)
    err = _launcher()(xp, gp, out.data_ptr(), R, d, float(eps),
                      build.dtype_code(x.dtype), BODY_CODES[plan.body],
                      *plan[1:], x.device.index,
                      torch.cuda.current_stream(x.device).cuda_stream)
    build.check(build.library("rmsnorm"), err, "rmsnorm")
    launches += 1
    body_launches[plan.body] += 1
    return out
