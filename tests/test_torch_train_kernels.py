"""The backward passes of the port's two LM kernels, on CPU.

The JAX package has no backward for its Pallas kernels (no ``custom_vjp``);
it differentiates its plain versions. The port's plain backward formulas
(``ref.flash_attention_backward``, ``ref.rmsnorm_backward``: explicit f32
formulas, not autograd) must equal ``torch.autograd`` over the port's
plain forward and ``jax.vjp`` of ``repro.kernels.ref`` on the same seeded
numpy inputs (f32, 1e-5). A row that sees no key (causal, Tk < Tq) is
held against torch autograd only: the reference masks with ``-inf`` and
gives NaN there (the port follows the Pallas kernel's finite mask). The
``torch.autograd.Function``s of the kernels, run over the plain pair, give
the gradients of autograd over the plain forward; on the card they run
over the CUDA pair (``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops, ref
from repro_torch.kernels import rmsnorm as rn

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The test files run in parallel workers on one host, where torch's
    CPU thread pool, spinning on every core, slows these small tensor ops
    by tens of times; this module runs torch on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# (B, Hq, Hkv, T, d): GQA groups of 1, 2 and 7
GROUPS = [(2, 2, 2, 24, 16), (2, 4, 2, 24, 16), (1, 14, 2, 24, 16)]


def _flash_inputs(b, hq, hkv, tq, tk, d, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32) for s in
            ((b, hq, tq, d), (b, hkv, tk, d), (b, hkv, tk, d),
             (b, hq, tq, d))]


def _autograd_flash(q, k, v, dout, causal):
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = ref.flash_attention(*ts, causal=causal)
    out.backward(torch.from_numpy(dout))
    return [t.grad.numpy() for t in ts]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("b,hq,hkv,t,d", GROUPS)
def test_flash_backward_equals_autograd_and_jax(b, hq, hkv, t, d, causal):
    q, k, v, dout = _flash_inputs(b, hq, hkv, t, t, d)
    out, lse = ref.flash_attention(*map(torch.from_numpy, (q, k, v)),
                                   causal=causal, return_lse=True)
    got = ref.flash_attention_backward(
        *map(torch.from_numpy, (q, k, v)), out, lse,
        torch.from_numpy(dout), causal=causal)
    _, vjp = jax.vjp(lambda q_, k_, v_: jref.flash_attention(
        q_, k_, v_, causal=causal), *map(jnp.asarray, (q, k, v)))
    want_jax = vjp(jnp.asarray(dout))
    want_torch = _autograd_flash(q, k, v, dout, causal)
    for g, wj, wt in zip(got, want_jax, want_torch):
        np.testing.assert_allclose(g.numpy(), np.asarray(wj), **TOL)
        np.testing.assert_allclose(g.numpy(), wt, **TOL)
    # lse is the log-sum-exp of the scaled, masked scores
    s = np.einsum("bkgqd,bksd->bkgqs", q.reshape(b, hkv, hq // hkv, t, d),
                  k) * d ** -0.5
    if causal:
        s = np.where(np.tril(np.ones((t, t), bool)), s, -np.inf)
    want_lse = np.asarray(jax.nn.logsumexp(jnp.asarray(s), axis=-1))
    np.testing.assert_allclose(lse.numpy(), want_lse.reshape(b, hq, t),
                               **TOL)


@pytest.mark.parametrize("tq,tk", [(12, 5), (9, 1)])
def test_flash_backward_on_rows_that_see_no_key(tq, tk):
    """Causal with Tk < Tq: the first Tq - Tk rows see no key. The
    forward gives them the mean of V; their lse is log(Tk); they give each
    key dv += dout / Tk and nothing to dq or dk."""
    b, hq, hkv, d = 1, 4, 2, 8
    q, k, v, dout = _flash_inputs(b, hq, hkv, tq, tk, d, seed=1)
    tq_, tk_ = map(torch.from_numpy, (q, k))
    out, lse = ref.flash_attention(tq_, tk_, torch.from_numpy(v),
                                   causal=True, return_lse=True)
    blind = tq - tk
    np.testing.assert_allclose(lse[:, :, :blind].numpy(), math.log(tk),
                               **TOL)
    np.testing.assert_allclose(
        out[:, :, :blind].numpy(),
        np.repeat(v.mean(axis=2, keepdims=True), hq // hkv, axis=1
                  ).repeat(blind, axis=2), **TOL)
    got = ref.flash_attention_backward(
        tq_, tk_, torch.from_numpy(v), out, lse, torch.from_numpy(dout),
        causal=True)
    want = _autograd_flash(q, k, v, dout, True)
    for g, w in zip(got, want):
        assert np.isfinite(g.numpy()).all()
        np.testing.assert_allclose(g.numpy(), w, **TOL)
    assert not got[0][:, :, :blind].any()
    # the blind rows alone: dv of every key is their dout summed / Tk
    dout_blind = dout.copy()
    dout_blind[:, :, blind:] = 0
    _, _, dv = ref.flash_attention_backward(
        tq_, tk_, torch.from_numpy(v), out, lse,
        torch.from_numpy(dout_blind), causal=True)
    want_dv = dout_blind.reshape(b, hkv, hq // hkv, tq, d).sum(
        axis=(2, 3))[:, :, None] / tk
    np.testing.assert_allclose(dv.numpy(),
                               np.broadcast_to(want_dv, dv.shape), **TOL)


@pytest.mark.parametrize("causal,tq,tk", [(True, 24, 24), (False, 20, 28),
                                          (True, 12, 5)])
@pytest.mark.parametrize("b,hq,hkv,t,d", GROUPS)
def test_flash_fn_over_the_plain_pair_equals_autograd(b, hq, hkv, t, d,
                                                      causal, tq, tk):
    q, k, v, dout = _flash_inputs(b, hq, hkv, tq, tk, d, seed=2)
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = fa.FlashAttentionFn.apply(*ts, causal, None, fa.PLAIN_PAIR)
    out.backward(torch.from_numpy(dout))
    want_out = ref.flash_attention(*map(torch.from_numpy, (q, k, v)),
                                   causal=causal)
    np.testing.assert_allclose(out.detach().numpy(), want_out.numpy(),
                               **TOL)
    for t_, w in zip(ts, _autograd_flash(q, k, v, dout, causal)):
        np.testing.assert_allclose(t_.grad.numpy(), w, **TOL)


@pytest.mark.parametrize("shape", [(3, 5, 48), (7, 112), (4, 1001)])
def test_rmsnorm_backward_equals_autograd_and_jax(shape):
    rng = np.random.default_rng(3)
    x = (rng.normal(size=shape) * 3).astype(np.float32)
    gamma = rng.normal(size=shape[-1]).astype(np.float32)
    g = rng.normal(size=shape).astype(np.float32)
    dx, dgamma = ref.rmsnorm_backward(torch.from_numpy(x),
                                      torch.from_numpy(gamma),
                                      torch.from_numpy(g), 1e-6)
    _, vjp = jax.vjp(lambda x_, g_: jref.rmsnorm(x_, g_, 1e-6),
                     jnp.asarray(x), jnp.asarray(gamma))
    jdx, jdgamma = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_()
    gt = torch.from_numpy(gamma).requires_grad_()
    ref.rmsnorm(xt, gt, 1e-6).backward(torch.from_numpy(g))
    for got, wj, wt in ((dx, jdx, xt.grad), (dgamma, jdgamma, gt.grad)):
        np.testing.assert_allclose(got.numpy(), np.asarray(wj), **TOL)
        np.testing.assert_allclose(got.numpy(), wt.numpy(), **TOL)


def test_rmsnorm_fn_over_the_plain_pair_equals_autograd():
    rng = np.random.default_rng(4)
    x = rng.normal(size=(9, 112)).astype(np.float32)
    gamma = rng.normal(size=112).astype(np.float32)
    g = rng.normal(size=(9, 112)).astype(np.float32)
    grads = []
    for fn in (lambda a, b: rn.RMSNormFn.apply(a, b, 1e-6, rn.PLAIN_PAIR),
               lambda a, b: ref.rmsnorm(a, b, 1e-6)):
        xt = torch.from_numpy(x).requires_grad_()
        gt = torch.from_numpy(gamma).requires_grad_()
        out = fn(xt, gt)
        out.backward(torch.from_numpy(g))
        grads.append((out.detach(), xt.grad, gt.grad))
    for a, b in zip(*grads):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL)


def test_ops_differentiate_the_plain_versions_on_the_cpu():
    """On a CPU tensor ``auto`` resolves to the plain versions, which
    autograd differentiates; ``impl='cuda'`` raises there, also under
    autograd (no fallback)."""
    q, k, v, dout = _flash_inputs(1, 4, 2, 10, 10, 8, seed=5)
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    ops.flash_attention(*ts).backward(torch.from_numpy(dout))
    for t_, w in zip(ts, _autograd_flash(q, k, v, dout, True)):
        np.testing.assert_allclose(t_.grad.numpy(), w, **TOL)
    x = torch.randn(3, 4, 16, requires_grad=True)
    gamma = torch.randn(16, requires_grad=True)
    ops.rmsnorm(x, gamma).sum().backward()
    assert x.grad.shape == x.shape and gamma.grad.shape == gamma.shape
    with pytest.raises(ValueError, match="CUDA tensor"):
        ops.flash_attention(*ts, impl="cuda")
    with pytest.raises(ValueError, match="CUDA tensor"):
        ops.rmsnorm(x, gamma, impl="cuda")
    with pytest.raises(ValueError, match="CUDA tensor"):
        fa.flash_attention_bwd_cuda(*ts, ts[0], torch.zeros(1, 4, 10),
                                    ts[0])
    with pytest.raises(ValueError, match="CUDA tensor"):
        rn.rmsnorm_bwd_cuda(x.reshape(-1, 16), gamma, x.reshape(-1, 16))
