"""The port's attention and RMSNorm ops against the JAX package, on CPU.

The plain versions (``repro_torch/kernels/ref.py``) run on seeded numpy
inputs against the Pallas kernels in interpret mode
(``repro.kernels.ops.*(impl="interpret")``), on the cases of
tests/test_kernels.py plus rows that see no key (causal, Tk < Tq), where
both give the mean of V. Tolerances as tests/test_kernels.py uses them:
2e-5 in f32 (another summation order), 3e-2 in bf16 (one rounding of
the output). The CUDA kernels run only on a card: tests/test_torch_cuda.py
and chip_smoke.py hold them against these plain versions there.
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops

from repro_torch.kernels import dispatch, ops, ref


def _jnp(a, dtype=jnp.float32):
    return jnp.asarray(a, dtype)


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dtype)


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("b,hq,hkv,tq,tk,d", [
    (1, 2, 2, 128, 128, 64),
    (2, 4, 2, 128, 256, 64),      # GQA group 2, decode-offset masking
    (1, 8, 1, 256, 256, 128),     # MQA
    (2, 2, 2, 128, 128, 128),
    (1, 4, 2, 256, 128, 32),      # Tk < Tq: rows with no visible key
])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_equals_pallas_interpret(b, hq, hkv, tq, tk, d,
                                                 causal):
    rng = np.random.default_rng(b + hq + tq + tk + d + causal)
    q = rng.normal(size=(b, hq, tq, d))
    k = rng.normal(size=(b, hkv, tk, d))
    v = rng.normal(size=(b, hkv, tk, d))
    want = jops.flash_attention(_jnp(q), _jnp(k), _jnp(v), causal=causal,
                                impl="interpret")
    got = ops.flash_attention(_t(q), _t(k), _t(v), causal=causal)
    assert got.dtype == torch.float32 and got.shape == (b, hq, tq, d)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=2e-5, atol=2e-5)


def test_flash_rows_without_a_key_are_the_mean_of_v():
    """Causal, Tq=256 against Tk=128: query rows 0..127 see no key. The
    Pallas kernel (finite NEG_INF) gives the mean of V there, and so does
    the port; the JAX package's jnp ref gives NaN (ROADMAP B3)."""
    rng = np.random.default_rng(7)
    q, k, v = (rng.normal(size=s) for s in
               ((1, 2, 256, 64), (1, 2, 128, 64), (1, 2, 128, 64)))
    got = _f32(ops.flash_attention(_t(q), _t(k), _t(v), causal=True))
    want = _f32(jops.flash_attention(_jnp(q), _jnp(k), _jnp(v),
                                     causal=True, impl="interpret"))
    mean_v = v.mean(axis=2)                                  # [1, 2, 64]
    np.testing.assert_allclose(got[:, :, :128],
                               np.broadcast_to(mean_v[:, :, None],
                                               (1, 2, 128, 64)),
                               rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    assert np.isfinite(got).all()


def test_flash_attention_bf16():
    rng = np.random.default_rng(0)
    q = rng.normal(size=(1, 4, 128, 64))
    k = rng.normal(size=(1, 2, 128, 64))
    v = rng.normal(size=(1, 2, 128, 64))
    want = jops.flash_attention(_jnp(q, jnp.bfloat16), _jnp(k, jnp.bfloat16),
                                _jnp(v, jnp.bfloat16), impl="interpret")
    got = ops.flash_attention(_t(q, torch.bfloat16), _t(k, torch.bfloat16),
                              _t(v, torch.bfloat16))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=3e-2, atol=3e-2)


@pytest.mark.parametrize("shape", [(8, 128), (4, 896), (2, 3, 256),
                                   (5, 24)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_equals_pallas_interpret(shape, dtype):
    rng = np.random.default_rng(sum(shape) + len(dtype))
    x = rng.normal(size=shape) * 3.0
    g = rng.normal(size=shape[-1:])
    jd, td = (jnp.float32, torch.float32) if dtype == "float32" else \
        (jnp.bfloat16, torch.bfloat16)
    want = jops.rmsnorm(_jnp(x, jd), _jnp(g, jd), eps=1e-6,
                        impl="interpret")
    got = ops.rmsnorm(_t(x, td), _t(g, td), eps=1e-6)
    assert got.dtype == td and got.shape == shape
    tol = 2e-5 if dtype == "float32" else 3e-2
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=tol, atol=tol)


def test_rmsnorm_casts_once():
    """The normalised x is not rounded to bf16 before the gamma product:
    the bf16 output equals the f32 result rounded once."""
    rng = np.random.default_rng(3)
    x = _t(rng.normal(size=(64, 896)), torch.bfloat16)
    g = _t(rng.normal(size=896) * 2.0, torch.bfloat16)
    once = ref.rmsnorm(x.float(), g.float()).to(torch.bfloat16)
    assert torch.equal(ops.rmsnorm(x, g), once)
    jx = jnp.asarray(x.float().numpy().astype(ml_dtypes.bfloat16))
    jg = jnp.asarray(g.float().numpy().astype(ml_dtypes.bfloat16))
    np.testing.assert_array_equal(
        _f32(jops.rmsnorm(jx, jg, impl="interpret")), _f32(once))


def test_lm_dispatch_order_explicit_env_device(monkeypatch):
    for op in ("flash_attention", "rmsnorm"):
        env = f"REPRO_TORCH_{op.upper()}_IMPL"
        monkeypatch.delenv(env, raising=False)
        assert dispatch.resolve_impl(op, platform="cuda") == "cuda"
        assert dispatch.resolve_impl(op, platform="cpu") == "ref"
        assert dispatch.resolve_impl(op, platform="cpu", width=4096) == "ref"
        monkeypatch.setenv(env, "ref")
        assert dispatch.resolve_impl(op, platform="cuda") == "ref"
        assert dispatch.resolve_impl(op, "cuda", platform="cpu") == "cuda"
        monkeypatch.setenv(env, "chunked")         # an intersect-only impl
        with pytest.raises(ValueError, match="unknown impl"):
            dispatch.resolve_impl(op, platform="cpu")
        monkeypatch.delenv(env)
    # the JAX package's overrides never reach the port
    monkeypatch.setenv("REPRO_RMSNORM_IMPL", "interpret")
    monkeypatch.setenv("REPRO_FLASH_ATTENTION_IMPL", "interpret")
    assert dispatch.resolve_impl("rmsnorm", platform="cuda") == "cuda"
    assert dispatch.resolve_impl("flash_attention", platform="cpu") == "ref"


def test_lm_cuda_impl_on_cpu_tensors_raises(monkeypatch):
    x = torch.zeros((2, 8))
    q = torch.zeros((1, 2, 4, 8))
    with pytest.raises(ValueError, match="CUDA tensor"):
        ops.rmsnorm(x, torch.ones(8), impl="cuda")
    with pytest.raises(ValueError, match="CUDA tensor"):
        ops.flash_attention(q, q, q, impl="cuda")
    monkeypatch.setenv("REPRO_TORCH_RMSNORM_IMPL", "cuda")
    with pytest.raises(ValueError, match="CUDA tensor"):
        ops.rmsnorm(x, torch.ones(8))
    monkeypatch.setenv("REPRO_TORCH_FLASH_ATTENTION_IMPL", "cuda")
    with pytest.raises(ValueError, match="CUDA tensor"):
        ops.flash_attention(q, q, q)
