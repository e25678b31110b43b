"""CUDA wrapper: row-wise padded-set intersection (``csrc/sorted_intersect.cu``).

Replaces the Pallas TPU kernel ``sorted_intersect_pallas``
(``src/repro/kernels/sorted_intersect.py``). The kernel is memory-bound:
it reads ``B*(Da+Db)*4`` bytes and writes ``B*Da*4``. One block per row
loads both rows with 16-byte loads before its first barrier, keeps ``b``
as it is when its holes are all in its tail (else compacts it with one
block scan) and looks each ``a`` entry up through a bucket table over
``b``'s staged entries (see the source's header). Its plain version is
:func:`repro_torch.kernels.ref.sorted_intersect`.
"""

from __future__ import annotations

import torch

from . import build, cost
from .library import define, direct

#: launches of the CUDA kernel by :func:`sorted_intersect_cuda` since the
#: last reset (callers set it to 0)
launches = 0

#: the widest ``b`` the kernel stages in shared memory (``kMaxDb``)
MAX_DB = 48 * 1024


def _check_int32_cuda(name: str, t: torch.Tensor, ndim: int) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != torch.int32:
        raise ValueError(f"{name} must be int32, got {t.dtype}")
    if t.ndim != ndim:
        raise ValueError(f"{name} must be {ndim}-D, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def sorted_intersect_cuda(a: torch.Tensor, b: torch.Tensor,
                          sentinel: int) -> torch.Tensor:
    """``a ∩ b`` per row, kept in ``a``'s slots, on the card.

    a: int32[B, Da], b: int32[B, Db] contiguous CUDA padded sets (widths may
    differ, ``Db <= MAX_DB``) -> int32[B, Da]. Raises on any other
    input. The dispatcher op ``repro_torch::sorted_intersect``.
    """
    if direct(a, b):
        return launch(a, b, sentinel)
    if a.device.type != "cuda":
        raise ValueError(f"a must be a CUDA tensor, got {a.device}")
    return OP(a, b, int(sentinel))


def launch(a: torch.Tensor, b: torch.Tensor, sentinel: int) -> torch.Tensor:
    """The kernel's launch through ctypes (the CUDA implementation of
    ``repro_torch::sorted_intersect``)."""
    global launches
    _check_int32_cuda("a", a, 2)
    _check_int32_cuda("b", b, 2)
    if a.shape[0] != b.shape[0] or a.device != b.device:
        raise ValueError(f"a{tuple(a.shape)} and b{tuple(b.shape)} need a "
                         "shared batch on one device")
    if b.shape[1] > MAX_DB:
        raise ValueError(f"Db = {b.shape[1]}: a row of b must fit in shared "
                         f"memory (Db <= {MAX_DB})")
    out = torch.empty_like(a)
    if a.numel() == 0:
        return out
    lib = build.library("sorted_intersect")
    stream = torch.cuda.current_stream(a.device).cuda_stream
    err = lib.sorted_intersect_launch(
        a.data_ptr(), b.data_ptr(), out.data_ptr(), a.shape[0], a.shape[1],
        b.shape[1], sentinel, a.device.index, stream)
    build.check(lib, err, "sorted_intersect")
    launches += 1
    return out


def rows_rule(row_args, replicated_args=(), n_scalars=1):
    """Sharding rule of an op whose outputs and ``row_args`` (argument
    indices) are sharded by rows together, ``replicated_args`` whole on
    every rank, then ``n_scalars`` non-tensor arguments: all
    replicated, or rows sharded."""
    def rule(*args):
        from torch.distributed.tensor import Replicate, Shard
        n = len(row_args) + len(replicated_args)
        ins = [Shard(0) if i in row_args else Replicate() for i in range(n)]
        return [([Replicate()], [Replicate()] * n + [None] * n_scalars),
                ([Shard(0)], ins + [None] * n_scalars)]
    return rule


OP = define("sorted_intersect",
            "(Tensor a, Tensor b, int sentinel) -> Tensor",
            launch, lambda a, b, sentinel: torch.empty_like(a),
            lambda a, b, sentinel: cost.sorted_intersect_bytes(
                a.shape[0], a.shape[1], b.shape[1]),
            sharding=rows_rule((0, 1)))
