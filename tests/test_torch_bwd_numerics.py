"""The numerics of the backward kernels' bodies on the model's path, on
the CPU, against the JAX package.

The card runs them (``tests/test_torch_cuda.py``); here torch replays
where each body rounds, on seeded numpy inputs, and the result is held
against ``jax.vjp`` of the JAX package's plain functions:

* ``csrc/flash_attention_bwd.cu``'s bf16 body: S and dP in f32 from the
  bf16 inputs, ``P = exp2(S * scale * log2(e) - lse * log2(e))``, then P
  and dS rounded to bf16 as the operands of the dV, dK and dQ products
  (f32 sums), dq, dk, dv cast once. At d = 64, GQA 14/2 (qwen2-0.5b's
  heads), causal or not, T <= 256 (ragged against the 64- and 128-row
  tiles): within 1e-2 x max|want| of ``jax.vjp(repro.kernels.ref
  .flash_attention)``. A row that sees no key is held against torch
  autograd over the port's plain forward (the JAX reference masks with
  ``-inf`` and gives NaN there).
* ``csrc/rmsnorm_bwd.cu``'s register body, lane by lane: lane t of a
  row's group holds vectors ``k * 32 * warps + t``, sums ``x^2`` and
  ``(g * gamma) * x`` with fmaf in slot and element order, the warp sums
  by an xor butterfly and the warps in order; a lane's dgamma partial
  runs over its group's rows of the chunk in order, the groups of a chunk
  are added in order, then eight runs of consecutive chunks each in order
  and the runs in order. Against ``jax.vjp`` of
  ``repro.kernels.ref.rmsnorm``: 1e-5 x max|want| in f32 (sums in another
  order, rsqrt), one bf16 ulp plus 1e-6 x max|want| in bf16 (one
  rounding of each output).
"""

import math

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref

from repro_torch.kernels import ref
from repro_torch.kernels import rmsnorm as rn

LOG2E = 1.4426950408889634
#: runs of consecutive chunks the backward's dgamma kernel sums apart
#: (``kWarps`` in ``csrc/rmsnorm_bwd.cu``)
RUNS = 8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensor ops in parallel test workers: torch on one thread (as
    ``tests/test_torch_train_kernels.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def emulate_flash_bwd_bf16(q, k, v, out, lse, dout, causal, scale=None):
    """The bf16 body of ``csrc/flash_attention_bwd.cu`` in torch: bf16
    q, k, v, out, dout and the forward's f32 lse -> bf16 (dq, dk, dv)."""
    b, hq, tq, d = q.shape
    hkv, tk = k.shape[1], k.shape[2]
    g = hq // hkv
    if scale is None:
        scale = d ** -0.5
    qg = q.float().reshape(b, hkv, g, tq, d)
    dog = dout.float().reshape(b, hkv, g, tq, d)
    kf, vf = k.float(), v.float()
    s = torch.einsum("bkgqd,bksd->bkgqs", qg, kf)
    dp = torch.einsum("bkgqd,bksd->bkgqs", dog, vf)
    rows = (dog * out.float().reshape(b, hkv, g, tq, d)).sum(-1)
    l2 = (lse.float() * LOG2E).reshape(b, hkv, g, tq, 1)
    p = torch.exp2(s * (scale * LOG2E) - l2)
    ds = p * (dp - rows[..., None])
    if causal:
        qpos = torch.arange(tq)[:, None] + (tk - tq)
        masked = torch.arange(tk)[None, :] > qpos
        blind = (qpos < 0).expand(tq, tk)
        p = torch.where(masked & blind, torch.exp2(-l2), p)
        p = torch.where(masked & ~blind, 0.0, p)
        ds = torch.where(masked, 0.0, ds)
    p16, ds16 = (t.to(torch.bfloat16).float() for t in (p, ds))
    dv = torch.einsum("bkgqs,bkgqd->bksd", p16, dog)
    dk = torch.einsum("bkgqs,bkgqd->bksd", ds16, qg) * scale
    dq = torch.einsum("bkgqs,bksd->bkgqd", ds16, kf) * scale
    return (dq.reshape(b, hq, tq, d).to(torch.bfloat16),
            dk.to(torch.bfloat16), dv.to(torch.bfloat16))


def _bf16_inputs(b, hq, hkv, tq, tk, d, seed):
    """q, k, v, dout from a seeded numpy generator, rounded to bf16; the
    f32 copies hold the same values."""
    rng = np.random.default_rng(seed)
    arrs = [rng.normal(size=s).astype(np.float32) for s in
            ((b, hq, tq, d), (b, hkv, tk, d), (b, hkv, tk, d),
             (b, hq, tq, d))]
    bf = [torch.from_numpy(a).to(torch.bfloat16) for a in arrs]
    return bf, [t.float() for t in bf]


def _close(got, want, rel):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=rel * float(np.abs(want).max()))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("tq,tk", [(256, 256), (130, 200), (200, 200)])
def test_flash_bwd_bf16_emulation_equals_jax_vjp(tq, tk, causal):
    b, hq, hkv, d = 1, 14, 2, 64
    (q, k, v, dout), f32 = _bf16_inputs(b, hq, hkv, tq, tk, d, tq + tk)
    out, lse = ref.flash_attention(q, k, v, causal=causal, return_lse=True)
    got = emulate_flash_bwd_bf16(q, k, v, out, lse, dout, causal)
    _, vjp = jax.vjp(lambda q_, k_, v_: jref.flash_attention(
        q_, k_, v_, causal=causal), *(jnp.asarray(t.numpy()) for t in
                                      f32[:3]))
    want = vjp(jnp.asarray(f32[3].numpy()))
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        _close(g, w, 1e-2)


def test_flash_bwd_bf16_emulation_on_rows_that_see_no_key():
    """Causal, Tk < Tq: the first Tq - Tk rows see no key (lse = log Tk);
    against torch autograd over the port's plain forward in f32."""
    b, hq, hkv, tq, tk, d = 1, 14, 2, 200, 130, 64
    (q, k, v, dout), f32 = _bf16_inputs(b, hq, hkv, tq, tk, d, 7)
    out, lse = ref.flash_attention(q, k, v, causal=True, return_lse=True)
    np.testing.assert_allclose(lse[:, :, :tq - tk].numpy(), math.log(tk),
                               rtol=1e-6)
    got = emulate_flash_bwd_bf16(q, k, v, out, lse, dout, True)
    ts = [t.clone().requires_grad_() for t in f32[:3]]
    ref.flash_attention(*ts, causal=True).backward(f32[3])
    for g, t in zip(got, ts):
        assert bool(torch.isfinite(g.float()).all())
        _close(g, t.grad.numpy(), 1e-2)
    assert not got[0][:, :, :tq - tk].any()


def emulate_rmsnorm_bwd_register_body(x, gamma, g, eps, plan, chunks):
    """The register body of ``csrc/rmsnorm_bwd.cu`` in torch, lane by lane
    (fmaf as one f64 product and sum rounded to f32), for ``chunks``
    chunks of consecutive rows -> (dx, dgamma) in x's dtype."""
    R, d = x.shape
    lanes, vec, nvec = 32 * plan.warps, plan.vec, d // plan.vec
    xf, gf, gam = x.float(), g.float(), gamma.float()

    def slots(t):
        out = torch.zeros((t.shape[0], rn.SLOTS * lanes, vec))
        out[:, :nvec] = t.reshape(t.shape[0], nvec, vec)
        return out.reshape(t.shape[0], rn.SLOTS, lanes, vec)

    xs, gs, gms = slots(xf), slots(gf), slots(gam[None])
    ss, sg = torch.zeros((R, lanes)), torch.zeros((R, lanes))
    for k in range(rn.SLOTS):
        for e in range(vec):
            xv = xs[:, k, :, e].double()
            gg = (gs[:, k, :, e] * gms[:, k, :, e]).double()
            ss = (xv * xv + ss.double()).float()
            sg = (gg * xv + sg.double()).float()
    idx = torch.arange(32)
    sums = []
    for t in (ss, sg):
        t = t.reshape(R, plan.warps, 32)
        for off in (16, 8, 4, 2, 1):
            t = t + t[..., idx ^ off]
        total = t[:, 0, 0]
        for w in range(1, plan.warps):
            total = total + t[:, w, 0]
        sums.append(total)
    rstd = torch.rsqrt(sums[0] / d + eps)
    coef = rstd * rstd * sums[1] / d
    dx = rstd[:, None] * (gf * gam - xf * coef[:, None])
    contrib = gf * xf * rstd[:, None]
    per_chunk = -(-R // chunks)
    groups = plan.rows_per_block
    parts = []
    for c in range(chunks):
        r0, r1 = c * per_chunk, min(R, (c + 1) * per_chunk)
        part = None
        for q in range(groups):
            acc = torch.zeros(d)
            for row in range(r0 + q, r1, groups):
                acc = acc + contrib[row]
            part = acc if part is None else part + acc
        parts.append(part)
    # the second kernel: RUNS runs of consecutive chunks, each in order
    # from 0, then the runs in order
    per_run = -(-chunks // RUNS)
    runs = []
    for w in range(RUNS):
        acc = torch.zeros(d)
        for part in parts[w * per_run:(w + 1) * per_run]:
            acc = acc + part
        runs.append(acc)
    dgamma = runs[0]
    for acc in runs[1:]:
        dgamma = dgamma + acc
    return dx.to(x.dtype), dgamma.to(gamma.dtype)


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    mag = np.maximum(np.abs(x), np.float32(2.0 ** -126))
    return np.exp2(np.floor(np.log2(mag)) - 7)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows,d", [(1000, 896), (37, 2048), (9, 3072)])
def test_rmsnorm_bwd_register_body_emulation_equals_jax_vjp(rows, d, dtype):
    td = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    rng = np.random.default_rng(rows + d)
    x, g = ((rng.normal(size=(rows, d)) * s).astype(np.float32)
            for s in (3, 1))
    gamma = rng.normal(size=d).astype(np.float32)
    xt, gt, gamt = (torch.from_numpy(a).to(td) for a in (x, g, gamma))
    plan = rn.rmsnorm_plan(rows, d, td, True)
    assert plan.body == "register"
    chunks = rn.bwd_chunks(rows, plan)
    dx, dgamma = emulate_rmsnorm_bwd_register_body(xt, gamt, gt, 1e-6, plan,
                                                   chunks)
    np_dt = np.float32 if dtype == "float32" else ml_dtypes.bfloat16
    ins = [jnp.asarray(t.float().numpy().astype(np_dt))
           for t in (xt, gamt, gt)]
    _, vjp = jax.vjp(lambda x_, g_: jref.rmsnorm(x_, g_, 1e-6), *ins[:2])
    for got, want in zip((dx, dgamma), vjp(ins[2])):
        assert got.dtype == td
        want = np.asarray(want, np.float32)
        err = np.abs(got.float().numpy() - want)
        scale = float(np.abs(want).max())
        if dtype == "float32":
            assert (err <= 1e-5 * scale).all(), float(err.max())
        else:
            assert (err <= _bf16_ulp(want) + 1e-6 * scale).all(), \
                float(err.max())
