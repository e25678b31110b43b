"""CUDA wrapper: flash attention (``csrc/flash_attention.cu``).

Replaces the Pallas TPU kernel ``flash_attention_pallas``
(``src/repro/kernels/flash_attention.py``). At the model's shapes the
work is bound by operations (``4*d`` flops per visible query-key pair).
For bf16 the kernel runs both products on the tensor cores (``wgmma``),
with K and V tiles brought in by TMA into a two-stage ring in shared
memory, one block per (q head, 128-row q tile); f32 inputs keep a scalar
body. q and k may be wider than v (MLA: ``dqk`` 192, ``dv`` 128). It
reads each q head's KV head by the GQA map itself and takes strided
``[B, H, T, d]`` views, so a caller holding ``[B, T, H, d]`` activations
passes their transposes without a copy (see the source's header). Its
plain version is :func:`repro_torch.kernels.ref.flash_attention`.

Training adds an optional ``lse`` output of the forward and the backward
kernel ``csrc/flash_attention_bwd.cu`` (the port's own: the Pallas kernel
has no VJP), bound into :class:`FlashAttentionFn`. The backward is bound
by operations too (five products of ``2*d`` flops a visible pair). For
bf16 it runs every product on the tensor cores (``wgmma``, P and dS as
bf16 operands, f32 sums) with Q/dO or K/V tiles brought in by TMA: a
dk/dv kernel per 128 keys and a dq kernel per 128 queries that recomputes
S and dP; f32 inputs keep f32 FMAs on shared-memory tiles. Both are
deterministic (no atomics: dk and dv sum the GQA group's q heads inside
one block). The backward takes the forward's widths: q and k may be wider
than v (MLA's (192, 128) runs 32-query steps in the dk/dv kernel and
64-key tiles in the dq kernel; see the source's header).
"""

from __future__ import annotations

import ctypes
from typing import Callable, NamedTuple, Optional, Tuple

import torch

from . import build, cost, ref
from .library import define, direct

#: launches of the forward kernel (``csrc/flash_attention.cu``) by
#: :func:`flash_attention_cuda` and :func:`flash_attention_lse_cuda` since
#: the last reset (callers set it to 0)
launches = 0
#: launches of the backward kernel (``csrc/flash_attention_bwd.cu``) by
#: :func:`flash_attention_bwd_cuda` since the last reset
bwd_launches = 0

#: TMA's alignment, in bytes, of a tensor's base address and of its strides
ALIGN = 16
#: the widest q/k and v rows of the forward and the backward
#: (``csrc/flash_attention.cu``, ``csrc/flash_attention_bwd.cu``: three and
#: two 64-column boxes of the bf16 bodies)
MAX_DQK, MAX_DV = 192, 128
#: the backward's scratch pads each (batch, head)'s rows to a multiple of
#: this (``kLdRows`` in ``csrc/flash_attention_bwd.cu``: its bf16 body
#: copies up to 64 rows of lse and D at a time)
BWD_ROWS = 64


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
    b, hq, tq, dqk = q.shape
    hkv, dv = k.shape[1], v.shape[3]
    if k.shape[:3] != v.shape[:3] or k.shape[0] != b or k.shape[3] != dqk:
        raise ValueError(f"k{tuple(k.shape)} and v{tuple(v.shape)} must be "
                         f"[B, Hkv, Tk, dqk] and [B, Hkv, Tk, dv] for "
                         f"q{tuple(q.shape)}")
    if hkv == 0 or hq % hkv:
        raise ValueError(f"Hq={hq} is not a multiple of Hkv={hkv}")
    if dqk > MAX_DQK or dqk % 8 or dv > MAX_DV or dv % 8 or dv == 0:
        raise ValueError(f"dqk={dqk}, dv={dv}: the kernel takes dqk <= "
                         f"{MAX_DQK} and dv <= {MAX_DV}, each a multiple "
                         "of 8")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must share one device")
    return strides


def empty_like_q(q: torch.Tensor, dv: int) -> torch.Tensor:
    """An uninitialised ``[B, H, T, dv]`` tensor laid out as
    ``torch.empty_like(q)`` would lay out q's shape: its first three
    dimensions in q's memory order (largest stride outermost), the last
    contiguous. So a ``[B, H, T, d]`` view of ``[B, T, H, d]`` memory
    gives a view of ``[B, T, H, dv]`` memory. Runs on any device."""
    if dv == q.shape[3]:
        return torch.empty_like(q)
    order = sorted(range(3), key=lambda i: (-q.stride(i), i)) + [3]
    shape = [q.shape[i] for i in order[:3]] + [dv]
    out = torch.empty(shape, dtype=q.dtype, device=q.device)
    return out.permute([order.index(i) for i in range(4)])


def launch_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   causal: bool, scale: Optional[float], with_lse: bool):
    """The forward kernel's launch through ctypes (the CUDA
    implementation of the ``repro_torch::flash_attention`` ops): checks,
    allocates, launches. Returns ``(out, lse or None)``."""
    global launches
    strides = _check_qkv(q, k, v)
    b, hq, tq, d = q.shape
    hkv, tk, dv = k.shape[1], k.shape[2], v.shape[3]
    if scale is None:
        scale = d ** -0.5
    out = empty_like_q(q, dv)
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
        None if lse is None else lse.data_ptr(), b, hq, hkv, tq, tk, d, dv,
        flat,
        int(bool(causal)), float(scale), build.dtype_code(q.dtype),
        q.device.index, stream)
    build.check(lib, err, "flash_attention")
    launches += 1
    return out, lse


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool = True,
                         scale: Optional[float] = None) -> torch.Tensor:
    """Attention on the card. q: [B, Hq, Tq, dqk]; k: [B, Hkv, Tk, dqk];
    v: [B, Hkv, Tk, dv]; CUDA views of one dtype (f32 or bf16) on one
    device that :func:`view_strides` accepts (not copied), with Hq a
    multiple of Hkv, dqk <= 192 and dv <= 128 each a multiple of 8 ->
    [B, Hq, Tq, dv] in q's dtype, laid out as :func:`empty_like_q` lays
    it out (so a transposed ``[B, T, H, dqk]`` q gives a transposed
    ``[B, T, H, dv]`` output). ``scale`` defaults to ``dqk ** -0.5``.
    Raises on any other input. The serving path: no ``lse`` is written.
    The dispatcher op ``repro_torch::flash_attention`` (launched directly
    when :func:`~repro_torch.kernels.library.direct`).
    """
    if direct(q, k, v):
        return launch_forward(q, k, v, causal, _scale(q, scale), False)[0]
    _check_device(q)
    return FWD(q, k, v, bool(causal), _scale(q, scale))


def flash_attention_lse_cuda(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, causal: bool = True,
                             scale: Optional[float] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`flash_attention_cuda` that also returns the rows'
    log-sum-exp ``lse`` [B, Hq, Tq] f32 (see
    :func:`repro_torch.kernels.ref.flash_attention`), which
    :func:`flash_attention_bwd_cuda` reads. One launch of the same
    kernel (the op ``repro_torch::flash_attention_lse``)."""
    if direct(q, k, v):
        return launch_forward(q, k, v, causal, _scale(q, scale), True)
    _check_device(q)
    return FWD_LSE(q, k, v, bool(causal), _scale(q, scale))


def flash_attention_bwd_cuda(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, out: torch.Tensor,
                             lse: torch.Tensor, dout: torch.Tensor,
                             causal: bool = True,
                             scale: Optional[float] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """``(dq, dk, dv)`` on the card (``csrc/flash_attention_bwd.cu``) from
    the forward's inputs, its output and ``lse``, and the output's
    gradient ``dout``. q, k, v and out take the forward's rules (q and k
    ``dqk <= 192`` wide, v and out ``dv <= 128``: MLA's k is a
    concatenation and its v a strided view of a wider row, both read in
    place); ``dout`` is read in place when :func:`view_strides` accepts it
    (autograd hands it over in out's layout) and made contiguous here
    otherwise, a copy of ``B * Hq * Tq * dv`` elements. dq, dk and dv are
    laid out as ``torch.empty_like`` of q, k and v (dv of MLA's v, a view
    with gaps, is a contiguous tensor of v's shape). The kernel's plain
    version is
    :func:`repro_torch.kernels.ref.flash_attention_backward`. The
    dispatcher op ``repro_torch::flash_attention_bwd``."""
    if direct(q, k, v, out, lse, dout):
        return launch_backward(q, k, v, out, lse, dout, causal,
                               _scale(q, scale))
    _check_device(q)
    return BWD(q, k, v, out, lse, dout, bool(causal), _scale(q, scale))


def launch_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    out: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor,
                    causal: bool = True, scale: Optional[float] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward kernel's launch through ctypes (the CUDA
    implementation of ``repro_torch::flash_attention_bwd``)."""
    global bwd_launches
    strides = _check_qkv(q, k, v)
    b, hq, tq, d = q.shape
    hkv, tk, dv_w = k.shape[1], k.shape[2], v.shape[3]
    for name, t in (("out", out), ("dout", dout)):
        _check_cuda(name, t, q.dtype)
        if t.shape != (b, hq, tq, dv_w):
            raise ValueError(f"{name}{tuple(t.shape)} must be [B, Hq, Tq, "
                             f"dv] = {(b, hq, tq, dv_w)}")
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
    # D (and for bf16 lse * log2(e)) by row, rows padded to BWD_ROWS
    scratch = torch.empty(2 * b * hq * -(-tq // BWD_ROWS) * BWD_ROWS,
                          dtype=torch.float32, device=q.device)
    lib = build.library("flash_attention_bwd")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.flash_attention_bwd_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        dout.data_ptr(), lse.data_ptr(), scratch.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), b, hq, hkv, tq, tk, d, dv_w, flat,
        int(bool(causal)), float(scale), build.dtype_code(q.dtype),
        q.device.index, stream)
    build.check(lib, err, "flash_attention_bwd")
    bwd_launches += 1
    return dq, dk, dv


def _check_device(q: torch.Tensor) -> None:
    if q.device.type != "cuda":
        raise ValueError(f"q must be a CUDA tensor, got {q.device}")


def _scale(q: torch.Tensor, scale: Optional[float]) -> float:
    return float(q.shape[3] ** -0.5 if scale is None else scale)


# --------------------------------------------------------------------------
# The dispatcher ops: fake implementations, counts, sharding rule
# --------------------------------------------------------------------------


def _fake_forward(q, k, v, causal, scale):
    return empty_like_q(q, v.shape[3])


def _fake_forward_lse(q, k, v, causal, scale):
    b, hq, tq, _ = q.shape
    return (empty_like_q(q, v.shape[3]),
            q.new_empty((b, hq, tq), dtype=torch.float32))


def _fake_backward(q, k, v, out, lse, dout, causal, scale):
    return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)


def _dims(q, k, v):
    b, hq, tq, dqk = q.shape
    return b, hq, k.shape[1], tq, k.shape[2], dqk, v.shape[3]


def _fwd_bytes(q, k, v, causal, scale, with_lse=False):
    b, hq, hkv, tq, tk, dqk, dv = _dims(q, k, v)
    return cost.flash_bytes(b, hq, hkv, tq, tk, dqk, dv, q.element_size(),
                            with_lse)


def _fwd_flops(q, k, v, causal, scale, out=None):
    b, hq, hkv, tq, tk, dqk, dv = _dims(q, k, v)
    return cost.flash_flops(b, hq, tq, tk, dqk, dv, causal)


def _bwd_bytes(q, k, v, out, lse, dout, causal, scale):
    b, hq, hkv, tq, tk, dqk, dv = _dims(q, k, v)
    return cost.flash_bwd_bytes(b, hq, hkv, tq, tk, dqk, dv,
                                q.element_size())


def _bwd_flops(q, k, v, o, lse, do, causal, scale, out=None):
    b, hq, hkv, tq, tk, dqk, dv = _dims(q, k, v)
    return cost.flash_bwd_flops(b, hq, tq, tk, dqk, dv, causal)


def placements_for(q, k, mesh_sizes):
    """Per mesh dim, the placement flash attention runs under: the
    batch (dim 0) or the heads (dim 1) where ``q`` is sharded so and,
    for the heads, both ``Hq`` and ``Hkv`` divide over that mesh dim (a
    contiguous block of q heads then reads the matching block of kv
    heads); else replicated. ``q`` / ``k`` are anything with ``.shape``
    and ``.placements``."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for p, n in zip(q.placements, mesh_sizes):
        if isinstance(p, Shard) and p.dim == 0:
            out.append(Shard(0))
        elif isinstance(p, Shard) and p.dim == 1 and q.shape[1] % n == 0 \
                and k.shape[1] % n == 0:
            out.append(Shard(1))
        else:
            out.append(Replicate())
    return out


def _sharding(n_in: int, n_out: int, k_arg: int = 1):
    """The rule of a flash op with ``n_in`` leading tensor arguments
    (then causal, scale) and ``n_out`` outputs: everything replicated,
    over the batch, or over the heads (kept only where every tensor
    divides: DTensor drops a strategy whose shard is uneven)."""
    def rule(*args):
        from torch.distributed.tensor import Replicate, Shard
        q, k = args[0], args[k_arg]
        out = [([Replicate()] * n_out, [Replicate()] * n_in + [None, None]),
               ([Shard(0)] * n_out, [Shard(0)] * n_in + [None, None])]
        if k.shape[1] and q.shape[1] % k.shape[1] == 0:
            heads = [Shard(1)] * n_in
            out.append(([Shard(1)] * n_out, heads + [None, None]))
        return out
    return rule


FWD = define("flash_attention",
             "(Tensor q, Tensor k, Tensor v, bool causal, float scale) "
             "-> Tensor",
             lambda q, k, v, causal, scale: launch_forward(
                 q, k, v, causal, scale, False)[0],
             _fake_forward, _fwd_bytes, _fwd_flops, _sharding(3, 1))
FWD_LSE = define("flash_attention_lse",
                 "(Tensor q, Tensor k, Tensor v, bool causal, float scale) "
                 "-> (Tensor, Tensor)",
                 lambda q, k, v, causal, scale: launch_forward(
                     q, k, v, causal, scale, True),
                 _fake_forward_lse,
                 lambda *a: _fwd_bytes(*a, with_lse=True), _fwd_flops,
                 _sharding(3, 2))
BWD = define("flash_attention_bwd",
             "(Tensor q, Tensor k, Tensor v, Tensor out, Tensor lse, "
             "Tensor dout, bool causal, float scale) "
             "-> (Tensor, Tensor, Tensor)",
             launch_backward, _fake_backward, _bwd_bytes, _bwd_flops,
             _sharding(6, 3))


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
