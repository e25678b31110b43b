"""Flash attention on strided ``[B, H, T, d]`` views, on CPU.

The CUDA kernel (``csrc/flash_attention.cu``) reads q, k and v as strided
views through TMA tensor maps, so the GQA layer hands it the transposes
of its ``[B, T, H, d]`` activations without a copy. Here, on the CPU:

* ``ops.flash_attention`` on transposed views equals the contiguous call
  and the JAX package's flash (Pallas in interpret mode, as
  tests/test_torch_lm_kernels.py runs it); tolerance 2e-5 in f32 (another
  summation order);
* ``view_strides``, the pure-Python check the wrapper runs before every
  launch, accepts the layer's views and rejects a last dimension with a
  stride other than 1, a stride that is not a multiple of 16 bytes and a
  base that is not 16-byte aligned;
* the qwen2 smoke config's ``GQAAttention`` equals the JAX layer
  (``gqa_attention``, Pallas in interpret mode) within 2e-4, as
  tests/test_torch_lm.py holds the whole model, and hands the flash op
  views of its activations, not copies.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.kernels import ops as jops
from repro.layers import attention as jattn
from repro.layers.common import NO_SHARD

from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import view_strides
from repro_torch.layers import attention as tattn

TOL = dict(rtol=2e-5, atol=2e-5)


def _bthd(rng, b, t, h, d):
    """A [B, T, H, d] activation and its [B, H, T, d] transpose (a view)."""
    x = torch.from_numpy(rng.normal(size=(b, t, h, d)).astype(np.float32))
    return x, x.transpose(1, 2)


@pytest.mark.parametrize("b,hq,hkv,tq,tk,d", [
    (1, 4, 2, 128, 128, 64),
    (2, 14, 2, 128, 256, 64),     # qwen2-0.5b heads, decode offset
    (1, 8, 1, 256, 256, 128),     # MQA, two 64-column boxes on the card
    (1, 4, 2, 256, 128, 32),      # rows that see no key
    (1, 7, 1, 128, 128, 16),      # qwen2 smoke heads
])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_on_transposed_views_equals_contiguous_and_pallas(
        b, hq, hkv, tq, tk, d, causal):
    rng = np.random.default_rng(b + hq + tq + tk + d + causal)
    _, q = _bthd(rng, b, tq, hq, d)
    _, k = _bthd(rng, b, tk, hkv, d)
    _, v = _bthd(rng, b, tk, hkv, d)
    assert not q.is_contiguous()
    got = ops.flash_attention(q, k, v, causal=causal)
    want = ops.flash_attention(q.contiguous(), k.contiguous(),
                               v.contiguous(), causal=causal)
    assert got.shape == (b, hq, tq, d) and got.dtype == torch.float32
    torch.testing.assert_close(got, want, **TOL)
    pallas = jops.flash_attention(*(jnp.asarray(x.contiguous().numpy())
                                    for x in (q, k, v)),
                                  causal=causal, impl="interpret")
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), **TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,d", [(14, 64), (2, 64), (7, 16), (2, 8),
                                 (16, 128)])
def test_view_strides_accepts_the_layers_views(dtype, h, d):
    x = torch.zeros((2, 33, h, d), dtype=dtype)
    view = x.transpose(1, 2)                       # [B, H, T, d]
    assert view_strides("q", view) == (33 * h * d, d, h * d)
    assert view_strides("q", x.transpose(1, 2).contiguous()) == \
        (h * 33 * d, 33 * d, d)
    # a size-1 dimension's stride is never read: any value is taken
    one = torch.zeros((1, 1, 5, d), dtype=dtype)
    size = one.element_size()
    assert view_strides("k", one)[:2] == (16 // size, 16 // size)


def test_view_strides_rejects_what_tma_cannot_read():
    x = torch.zeros((2, 8, 4, 64), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="stride 1"):
        view_strides("q", x.transpose(2, 3))       # d not contiguous
    with pytest.raises(ValueError, match="4-D"):
        view_strides("q", x[0])
    odd = torch.zeros((2, 8, 4, 68), dtype=torch.bfloat16)[..., :60]
    with pytest.raises(ValueError, match="multiple of 16 bytes"):
        view_strides("k", odd)                     # rows 136 bytes apart
    flat = torch.zeros(2 * 8 * 4 * 64 + 1, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="aligned"):
        view_strides("v", flat[1:].view(2, 8, 4, 64))
    f32 = torch.zeros((2, 3, 8, 10), dtype=torch.float32)[..., :8]
    with pytest.raises(ValueError, match="multiple of 16 bytes"):
        view_strides("q", f32)                     # rows 40 bytes apart


def test_gqa_layer_equals_jax_and_passes_views(monkeypatch):
    jcfg = jax_get_config("qwen2-0.5b").smoke().model_cfg
    tcfg = get_config("qwen2-0.5b").smoke().model_cfg
    p = jax.tree.map(np.asarray, jattn.gqa_params(
        jax.random.PRNGKey(3), jcfg.d_model, jcfg.n_heads, jcfg.n_kv_heads,
        jcfg.d_head, jcfg.qkv_bias, jnp.float32))
    rng = np.random.default_rng(5)
    for name in ("bq", "bk", "bv"):            # JAX initialises them to 0
        p[name] = (p[name] + 0.3 * rng.normal(size=p[name].shape)
                   ).astype(np.float32)
    layer = tattn.GQAAttention(tcfg.d_model, tcfg.n_heads, tcfg.n_kv_heads,
                               tcfg.d_head, tcfg.qkv_bias, torch.float32,
                               torch.Generator().manual_seed(0),
                               rope_theta=tcfg.rope_theta)
    layer.load_state_dict({k: torch.tensor(v) for k, v in p.items()})
    b, t = 2, 40
    x = rng.normal(size=(b, t, tcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(t), (b, t))

    seen = []
    plain = tattn.kops.flash_attention

    def spy(q, k, v, **kw):
        for n, a in (("q", q), ("k", k), ("v", v)):
            view_strides(n, a)                 # the kernel takes them
        seen.append([(tuple(a.shape), a.stride()) for a in (q, k, v)])
        return plain(q, k, v, **kw)

    monkeypatch.setattr(tattn.kops, "flash_attention", spy)
    got, cache = layer(torch.from_numpy(x), torch.from_numpy(pos.copy()))
    assert cache is None and len(seen) == 1
    h, kvh, dh = tcfg.n_heads, tcfg.n_kv_heads, tcfg.d_head
    # transposed views of the [B, T, H, d] activations, not copies
    (qs, qst), (ks, kst), (_, vst) = seen[0]
    assert qs == (b, h, t, dh) and ks == (b, kvh, t, dh)
    assert qst == (t * h * dh, dh, h * dh, 1)
    assert kst == vst == (t * kvh * dh, dh, kvh * dh, 1)
    want, _ = jattn.gqa_attention(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x), jnp.asarray(pos),
        jcfg, NO_SHARD, attn_impl="interpret")
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=2e-4, atol=2e-4)
