"""CUDA wrapper: fused DBQ gather + intersection (``csrc/gather_intersect.cu``).

Replaces the Pallas TPU kernel ``gather_intersect_pallas``
(``src/repro/kernels/gather_intersect.py``). The kernel is memory-bound:
it reads ``B*Dc*4`` candidate bytes, writes ``B*Dc*4``, and reads one
``D*4``-byte adjacency row per valid id, staged in shared memory and
binary-searched; the gathered ``[B, D]`` block is never written (see the
source's header). Its plain version is gather-then-intersect with
:func:`repro_torch.kernels.ref.sorted_intersect`.
"""

from __future__ import annotations

import torch

from . import build, cost
from .library import define, direct
from .sorted_intersect import _check_int32_cuda, rows_rule

#: launches of the CUDA kernel by :func:`gather_intersect_cuda` since the
#: last reset (callers set it to 0)
launches = 0


def gather_intersect_cuda(ids: torch.Tensor, cand: torch.Tensor,
                          adj: torch.Tensor, sentinel: int) -> torch.Tensor:
    """``cand[i] ∩ adj[clip(ids[i], 0, sentinel)]`` per row, on the card.

    ids: int32[B] (any values; clipped in the kernel), cand: int32[B, Dc]
    padded sets, adj: int32[N+1, D] padded adjacency with N = sentinel and
    row N all-sentinel; all contiguous CUDA tensors on one device.
    Returns int32[B, Dc] in ``cand``'s slots. Raises on any other input.
    The dispatcher op ``repro_torch::gather_intersect``.
    """
    if direct(ids, cand, adj):
        return launch(ids, cand, adj, sentinel)
    if cand.device.type != "cuda":
        raise ValueError(f"cand must be a CUDA tensor, got {cand.device}")
    return OP(ids, cand, adj, int(sentinel))


def launch(ids: torch.Tensor, cand: torch.Tensor, adj: torch.Tensor,
           sentinel: int) -> torch.Tensor:
    """The kernel's launch through ctypes (the CUDA implementation of
    ``repro_torch::gather_intersect``)."""
    global launches
    _check_int32_cuda("ids", ids, 1)
    _check_int32_cuda("cand", cand, 2)
    _check_int32_cuda("adj", adj, 2)
    if ids.shape[0] != cand.shape[0]:
        raise ValueError(f"ids{tuple(ids.shape)} and cand"
                         f"{tuple(cand.shape)} need a shared batch")
    if adj.shape[0] != sentinel + 1:
        raise ValueError(f"adj has {adj.shape[0]} rows; needs sentinel + 1 "
                         f"= {sentinel + 1} (row N all-sentinel)")
    if not (ids.device == cand.device == adj.device):
        raise ValueError("ids, cand and adj must share one device")
    out = torch.empty_like(cand)
    if cand.numel() == 0:
        return out
    lib = build.library("gather_intersect")
    stream = torch.cuda.current_stream(cand.device).cuda_stream
    err = lib.gather_intersect_launch(
        ids.data_ptr(), cand.data_ptr(), adj.data_ptr(), out.data_ptr(),
        cand.shape[0], cand.shape[1], adj.shape[1], sentinel,
        cand.device.index, stream)
    build.check(lib, err, "gather_intersect")
    launches += 1
    return out


OP = define("gather_intersect",
            "(Tensor ids, Tensor cand, Tensor adj, int sentinel) -> Tensor",
            launch, lambda ids, cand, adj, sentinel: torch.empty_like(cand),
            lambda ids, cand, adj, sentinel: cost.gather_intersect_bytes(
                cand.shape[0], cand.shape[1], adj.shape[1]),
            sharding=rows_rule((0, 1), (2,)))
