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

Training adds the backward kernel ``csrc/rmsnorm_bwd.cu`` (the port's
own: the Pallas kernel has no VJP), bound into :class:`RMSNormFn`. It
recomputes ``rstd`` from x, so the forward stays the serving path's
launch. It is memory-bound too (x, g read and dx written once) and
deterministic: ``dgamma`` is summed by chunks of rows, then over the
chunks in a fixed order (eight runs of consecutive chunks, each in order,
then the runs), with no atomics. Its body follows the forward's plan
(:func:`rmsnorm_plan`; chunks of rows by :func:`bwd_chunks`): on the
register body a group of lanes holds a row of x and g in registers, as
the forward does (gamma in shared memory), each lane keeping its
columns' dgamma over the chunk in registers; any other plan takes a block
per chunk that passes over each row twice.
"""

from __future__ import annotations

import functools
from typing import Callable, NamedTuple

import torch

from . import build, cost, ref
from .library import define, direct

#: launches of the CUDA kernel by :func:`rmsnorm_cuda` since the last
#: reset (callers set it to 0)
launches = 0
#: the same launches by body (callers set each to 0 with ``launches``)
body_launches = {"register": 0, "block": 0}
#: launches of the backward kernel by :func:`rmsnorm_bwd_cuda` since the
#: last reset
bwd_launches = 0
#: the same launches by body (callers set each to 0 with ``bwd_launches``)
bwd_body_launches = {"register": 0, "block": 0}
#: the backward's chunks of rows (each a partial sum of dgamma), at most
BWD_CHUNKS = 1024
#: register body: rows each group of lanes takes in a chunk, at least
BWD_ROWS_PER_GROUP = 8

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


def bwd_chunks(R: int, plan: RmsnormPlan) -> int:
    """The backward's chunks of consecutive rows for ``R >= 1`` rows under
    the forward's ``plan``: at most :data:`BWD_CHUNKS`, each of
    ``ceil(R / chunks)`` rows and none empty. On the register body there
    are at most ``ceil(R / (plan.rows_per_block * BWD_ROWS_PER_GROUP))``
    chunks, so that a lane's dgamma partial covers about
    :data:`BWD_ROWS_PER_GROUP` rows before the block's groups are
    added."""
    least = plan.rows_per_block * BWD_ROWS_PER_GROUP \
        if plan.body == "register" else 1
    return _ceil_div(R, max(least, _ceil_div(R, BWD_CHUNKS)))


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
    The dispatcher op ``repro_torch::rmsnorm`` (launched directly when
    :func:`~repro_torch.kernels.library.direct`).
    """
    if direct(x, gamma):
        return launch_forward(x, gamma, eps)
    _check_device(x)
    return FWD(x, gamma, float(eps))


def launch_forward(x: torch.Tensor, gamma: torch.Tensor,
                   eps: float = 1e-6) -> torch.Tensor:
    """The kernel's launch through ctypes (the CUDA implementation of
    ``repro_torch::rmsnorm``): checks, plans, allocates, launches."""
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


def rmsnorm_bwd_cuda(x: torch.Tensor, gamma: torch.Tensor,
                     g: torch.Tensor, eps: float = 1e-6):
    """``(dx, dgamma)`` of RMSNorm on the card (``csrc/rmsnorm_bwd.cu``)
    for the output gradient ``g``. x: [R, d] and gamma: [d] as
    :func:`rmsnorm_cuda` takes them; ``g`` [R, d] of x's dtype, made
    contiguous here when it is not. dx in x's dtype, dgamma in gamma's.
    The body is the forward's plan for x, g and gamma's alignment. Its
    plain version is :func:`repro_torch.kernels.ref.rmsnorm_backward`.
    The dispatcher op ``repro_torch::rmsnorm_bwd``.
    """
    if direct(x, gamma, g):
        return launch_backward(x, gamma, g, eps)
    _check_device(x)
    return BWD(x, gamma, g, float(eps))


def launch_backward(x: torch.Tensor, gamma: torch.Tensor,
                    g: torch.Tensor, eps: float = 1e-6):
    """The backward kernel's launch through ctypes (the CUDA
    implementation of ``repro_torch::rmsnorm_bwd``)."""
    global bwd_launches
    check_float_cuda("x", x, 2, x.dtype)
    check_float_cuda("gamma", gamma, 1, x.dtype)
    g = g.contiguous()
    check_float_cuda("g", g, 2, x.dtype)
    if gamma.shape[0] != x.shape[1] or g.shape != x.shape or \
            not (gamma.device == g.device == x.device):
        raise ValueError(f"gamma{tuple(gamma.shape)} and g{tuple(g.shape)} "
                         f"must be [d] and [R, d] on x's device for "
                         f"x{tuple(x.shape)}")
    R, d = x.shape
    dx = torch.empty_like(x)
    if x.numel() == 0:
        return dx, torch.zeros_like(gamma)
    dgamma = torch.empty_like(gamma)
    aligned = all(t.data_ptr() % 16 == 0 for t in (x, g, gamma, dx))
    plan = rmsnorm_plan(R, d, x.dtype, aligned)
    chunks = bwd_chunks(R, plan)
    partial = torch.empty((chunks, d), dtype=torch.float32, device=x.device)
    lib = build.library("rmsnorm_bwd")
    err = lib.rmsnorm_bwd_launch(
        x.data_ptr(), gamma.data_ptr(), g.data_ptr(), dx.data_ptr(),
        dgamma.data_ptr(), partial.data_ptr(), R, d, float(eps), chunks,
        BODY_CODES[plan.body], plan.warps, build.dtype_code(x.dtype),
        x.device.index, torch.cuda.current_stream(x.device).cuda_stream)
    build.check(lib, err, "rmsnorm_bwd")
    bwd_launches += 1
    bwd_body_launches[plan.body] += 1
    return dx, dgamma


def _check_device(x: torch.Tensor) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"x must be a CUDA tensor, got {x.device}")


def _rows_rule(n_tensors: int, n_out: int, partial_outs=()):
    """Sharding rule of an op over ``[R, d]`` rows whose first argument
    and outputs are row tensors, the ``gamma`` argument (index 1) is
    replicated: all replicated, or rows sharded (an output in
    ``partial_outs``, a sum over the rows, is then a partial sum)."""
    def rule(*args):
        from torch.distributed.tensor import Partial, Replicate, Shard
        outs = [Partial() if i in partial_outs else Shard(0)
                for i in range(n_out)]
        ins = [Replicate() if i == 1 else Shard(0)
               for i in range(n_tensors)] + [None]
        return [([Replicate()] * n_out, [Replicate()] * n_tensors + [None]),
                (outs, ins)]
    return rule


FWD = define("rmsnorm", "(Tensor x, Tensor gamma, float eps) -> Tensor",
             launch_forward, lambda x, gamma, eps: torch.empty_like(x),
             lambda x, gamma, eps: cost.rmsnorm_bytes(
                 x.shape[0], x.shape[1], x.element_size()),
             sharding=_rows_rule(2, 1))
BWD = define("rmsnorm_bwd",
             "(Tensor x, Tensor gamma, Tensor g, float eps) "
             "-> (Tensor, Tensor)",
             launch_backward,
             lambda x, gamma, g, eps: (torch.empty_like(x),
                                       torch.empty_like(gamma)),
             lambda x, gamma, g, eps: cost.rmsnorm_bwd_bytes(
                 x.shape[0], x.shape[1], x.element_size()),
             sharding=_rows_rule(3, 2, partial_outs=(1,)))


class NormPair(NamedTuple):
    """An RMSNorm forward ``(x, gamma, eps) -> out`` over ``[R, d]`` rows
    and the backward ``(x, gamma, g, eps) -> (dx, dgamma)``."""
    forward: Callable
    backward: Callable


#: the kernels: the training path on the card
CUDA_PAIR = NormPair(rmsnorm_cuda, rmsnorm_bwd_cuda)
#: the plain versions, for the CPU tests of :class:`RMSNormFn`
PLAIN_PAIR = NormPair(ref.rmsnorm, ref.rmsnorm_backward)


class RMSNormFn(torch.autograd.Function):
    """RMSNorm of ``[R, d]`` rows with a gradient: ``pair.forward`` gives
    the output; x and gamma are saved (``rstd`` is recomputed by the
    backward), and ``pair.backward`` computes dx and dgamma.
    ``apply(x, gamma, eps, pair)``; ``ops.rmsnorm`` passes
    :data:`CUDA_PAIR` when an input requires grad on the card."""

    @staticmethod
    def forward(ctx, x, gamma, eps, pair):
        out = pair.forward(x, gamma, eps)
        ctx.save_for_backward(x, gamma)
        ctx.eps, ctx.pair = eps, pair
        return out

    @staticmethod
    def backward(ctx, g):
        x, gamma = ctx.saved_tensors
        dx, dgamma = ctx.pair.backward(x, gamma, g, ctx.eps)
        return dx, dgamma, None, None
