"""The port's MoE and MLA layers against the JAX package, on CPU.

* ``MoE`` against ``repro.layers.moe.moe_ffn`` on the same weights and
  inputs: the expert indices first (a routing flip fails by name), then
  the reference's gathered expert inputs ``[E, C, D]`` (caught at its
  ``ctx.shard`` call: which token sits in which slot, which slots are
  empty, which assignments were dropped), then the output and the aux
  loss within 2e-4. The cases cover no drops, drops, capacities whose
  ``n_tok * k / E * cf`` is exactly x.5 (Python's ``round`` takes it to
  the even integer, in both), and ``n_shared`` 0 and 2.
* ``MLAAttention``'s expanded prefill against ``mla_attention`` with
  ``attn_impl="blockwise"`` (the Pallas kernel cannot take MLA's
  unequal head widths), its absorbed decode and caches step by step.
* the plain ``flash_attention`` with ``dqk != dv`` against the
  reference's ``blockwise_attention``, and its backward formulas against
  autograd (also through ``FlashAttentionFn`` on the MLA layer's
  layouts); the layout of the kernel's output and the MLA layer's v view
  (read in place) are checked on the CPU.
* the MoE layer's backward (gather and combine as autograd Functions
  whose backward passes are gathers by the inverse maps) against autograd
  over the plain indexing: f32 gradients within 1e-6 (sums in another
  order), bf16 within one bf16 ulp of the larger plus 1e-6 (the token
  gradient sums its k rows in f32, autograd's scatter in bf16), the slot
  and gate gradients bit-equal, and a repeat bit-equal.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.layers import attention as jatt
from repro.layers import moe as jmoe
from repro.layers.common import ShardCtx
from repro.models.transformer import LMConfig as JaxLMConfig

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ref
from repro_torch.layers.attention import MLAAttention, init_mla_cache
from repro_torch.layers import moe as tmoe
from repro_torch.layers.moe import MoE, capacity

TOL = dict(rtol=2e-4, atol=2e-4)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = torch.from_numpy(np.array(v))
    return out


class _Recorder(ShardCtx):
    """A mesh-less ShardCtx that keeps every array passed to ``shard``."""

    def __init__(self):
        object.__setattr__(self, "seen", [])

    def shard(self, x, *axes):
        self.seen.append(x)
        return x


def _jax_moe(params, x, top_k, cf):
    """moe_ffn under jit -> (out, aux, the gathered expert inputs, the
    array of its first ``ctx.shard`` call)."""
    def run(p, x):
        rec = _Recorder()
        out, aux = jmoe.moe_ffn(p, x, rec, top_k=top_k, capacity_factor=cf)
        return out, aux, rec.seen[0]
    return jax.jit(run)(jax.tree.map(jnp.asarray, params), jnp.asarray(x))


# (b, t, d, n_experts, top_k, d_ff, n_shared, capacity_factor)
MOE_CASES = {
    "no-drops": (2, 12, 32, 4, 2, 16, 0, 2.0),          # cap = n_tok
    "drops": (2, 24, 32, 4, 2, 16, 2, 0.5),
    "half-to-even-down": (1, 5, 16, 4, 2, 8, 0, 1.0),   # 2.5 -> 2
    "half-to-even-up": (1, 7, 16, 4, 2, 8, 2, 1.0),     # 3.5 -> 4
}


@pytest.mark.parametrize("case", list(MOE_CASES))
def test_moe_equals_moe_ffn(case):
    b, t, d, e, k, f, n_shared, cf = MOE_CASES[case]
    n_tok = b * t
    want_cap = int(max(1, round(n_tok * k / e * cf)))
    assert capacity(n_tok, k, e, cf) == want_cap
    if case.startswith("half"):
        assert n_tok * k / e * cf % 1 == 0.5
        assert want_cap % 2 == 0
    params = jax.tree.map(np.asarray, jmoe.moe_params(
        jax.random.PRNGKey(len(case)), d, e, f, n_shared, jnp.float32))
    rng = np.random.default_rng(len(case))
    x = rng.normal(size=(b, t, d)).astype(np.float32)

    want, want_aux, jxin = _jax_moe(params, x, k, cf)
    moe = MoE(d, e, f, n_shared, k, cf, torch.float32, torch.Generator())
    moe.load_state_dict(_flat(params))
    xt = torch.from_numpy(x)

    # 1. routing: the same experts, in the same order, for every token
    xf = xt.reshape(n_tok, d)
    with torch.no_grad():
        r = moe.route(xf)
    probs = jax.nn.softmax(jnp.asarray(x.reshape(n_tok, d))
                           @ jnp.asarray(params["router"]), axis=-1)
    jgates, jidx = jax.lax.top_k(probs, k)
    np.testing.assert_array_equal(r.experts.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(
        r.gates.numpy(), np.asarray(jgates / jgates.sum(-1, keepdims=True)),
        **TOL)

    # 2. slots and drops: the gathered expert inputs equal the reference's
    disp = moe.dispatch(r.experts)
    assert disp.cap == want_cap and disp.slot_tok.shape == (e, want_cap)
    xpad = torch.cat([xf, torch.zeros(1, d)])
    jxin = np.asarray(jxin)
    assert jxin.shape == (e, want_cap, d)
    np.testing.assert_array_equal(xpad[disp.slot_tok].numpy(), jxin)
    kept = int((disp.rows < e * want_cap).sum())
    assert kept == int((disp.slot_tok < n_tok).sum())
    if case == "no-drops":
        assert kept == n_tok * k
    if "drops" in case and case != "no-drops":
        assert kept < n_tok * k

    # 3. the output and the aux loss
    with torch.no_grad():
        got, aux = moe(xt)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(float(aux), float(want_aux), **TOL)
    with torch.no_grad():
        again, _ = moe(xt)
    assert torch.equal(again, got)          # no atomics: the same bits


@functools.lru_cache(maxsize=None)
def _mla_pair():
    cfg = JaxLMConfig(name="mla-test", n_layers=1, d_model=64, n_heads=4,
                      n_kv_heads=4, d_head=24, d_ff=64, vocab=32,
                      attn_kind="mla", kv_lora_rank=32, qk_nope_dim=16,
                      qk_rope_dim=8, v_head_dim=24, dtype=jnp.float32)
    params = jax.tree.map(np.asarray, jatt.mla_params(
        jax.random.PRNGKey(3), cfg.d_model, cfg.n_heads, cfg.kv_lora_rank,
        cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim, jnp.float32))
    rng = np.random.default_rng(3)
    params["norm_ckv"] = (params["norm_ckv"] + 0.2 * rng.normal(
        size=params["norm_ckv"].shape)).astype(np.float32)
    layer = MLAAttention(cfg.d_model, cfg.n_heads, cfg.kv_lora_rank,
                         cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim,
                         torch.float32, torch.Generator(), cfg.rope_theta)
    layer.load_state_dict(_flat(params))
    return cfg, jax.tree.map(jnp.asarray, params), layer


def test_mla_prefill_equals_reference():
    cfg, jp, layer = _mla_pair()
    b, t = 2, 20
    x = np.random.default_rng(4).normal(size=(b, t, cfg.d_model)
                                        ).astype(np.float32)
    pos = np.broadcast_to(np.arange(t), (b, t))
    want, _ = jax.jit(lambda p, x, pos: jatt.mla_attention(
        p, x, pos, cfg, ShardCtx(), attn_impl="blockwise"))(
            jp, jnp.asarray(x), jnp.asarray(pos))
    with torch.no_grad():
        got, cache = layer(torch.from_numpy(x), torch.from_numpy(pos.copy()))
    assert cache is None and got.shape == (b, t, cfg.d_model)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_mla_decode_and_caches_equal_reference():
    cfg, jp, layer = _mla_pair()
    b, steps, s_max = 2, 6, 8
    xs = np.random.default_rng(5).normal(size=(b, steps, cfg.d_model)
                                         ).astype(np.float32)
    jcache = jatt.init_mla_cache(b, s_max, cfg.kv_lora_rank, cfg.qk_rope_dim,
                                 jnp.float32)
    cache = init_mla_cache(b, s_max, cfg.kv_lora_rank, cfg.qk_rope_dim,
                           torch.float32)
    step = jax.jit(lambda p, x, pos, c: jatt.mla_attention(
        p, x, pos, cfg, ShardCtx(), cache=c))
    for i in range(steps):
        pos = np.full((b, 1), i)
        want, jcache = step(jp, jnp.asarray(xs[:, i:i + 1]), jnp.asarray(pos),
                            jcache)
        with torch.no_grad():
            got, cache = layer(torch.from_numpy(xs[:, i:i + 1].copy()),
                               torch.from_numpy(pos), cache=cache)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for key in ("c_kv", "k_rope"):
        np.testing.assert_allclose(cache[key].numpy(),
                                   np.asarray(jcache[key]), **TOL)
    assert cache["length"] == int(jcache["length"]) == steps
    # decode over the whole prefix == the expanded prefill's last rows
    pos = np.broadcast_to(np.arange(steps), (b, steps))
    with torch.no_grad():
        full, _ = layer(torch.from_numpy(xs), torch.from_numpy(pos.copy()))
    np.testing.assert_allclose(got.numpy(), full[:, -1:].numpy(), **TOL)
    with pytest.raises(ValueError, match="KV cache full"):
        with torch.no_grad():
            for i in range(steps, s_max + 1):
                layer(torch.from_numpy(xs[:, :1].copy()),
                      torch.full((b, 1), i), cache=cache)


@pytest.mark.parametrize("dqk,dv,hq,hkv,tq,tk,causal", [
    (48, 32, 4, 4, 33, 33, True),        # the deepseek smoke config's MLA
    (192, 128, 2, 2, 17, 17, True),      # MLA at full width
    (24, 40, 6, 2, 20, 20, True),        # v wider than q, GQA
    (48, 32, 4, 2, 9, 30, True),         # decode offset
    (40, 16, 2, 1, 12, 7, False),
])
def test_plain_flash_unequal_widths_equals_blockwise(dqk, dv, hq, hkv, tq,
                                                      tk, causal):
    rng = np.random.default_rng(dqk + dv + tq)
    q = rng.normal(size=(2, tq, hq, dqk)).astype(np.float32)
    k = rng.normal(size=(2, tk, hkv, dqk)).astype(np.float32)
    v = rng.normal(size=(2, tk, hkv, dv)).astype(np.float32)
    g = hq // hkv
    want = jax.jit(functools.partial(jatt.blockwise_attention,
                                     causal=causal, block=8))(
        jnp.asarray(q), jnp.asarray(np.repeat(k, g, axis=2)),
        jnp.asarray(np.repeat(v, g, axis=2)))
    tq_, tk_, tv_ = (torch.from_numpy(a).transpose(1, 2) for a in (q, k, v))
    got = ref.flash_attention(tq_, tk_, tv_, causal=causal)
    assert got.shape == (2, hq, tq, dv)
    np.testing.assert_allclose(got.transpose(1, 2).numpy(),
                               np.asarray(want), **TOL)


@pytest.mark.parametrize("dqk,dv,hq,hkv,causal", [(48, 32, 4, 2, True),
                                                  (24, 40, 2, 2, False)])
def test_plain_flash_backward_unequal_widths_equals_autograd(dqk, dv, hq,
                                                             hkv, causal):
    gen = torch.Generator().manual_seed(dqk * dv)
    b, tq, tk = 2, 11, 11
    q, k = (torch.randn((b, h, tq, dqk), generator=gen, dtype=torch.float64)
            for h in (hq, hkv))
    v = torch.randn((b, hkv, tk, dv), generator=gen, dtype=torch.float64)
    dout = torch.randn((b, hq, tq, dv), generator=gen, dtype=torch.float64)
    out, lse = ref.flash_attention(q, k, v, causal=causal, return_lse=True)
    got = ref.flash_attention_backward(q, k, v, out, lse, dout, causal)
    qa, ka, va = (t.clone().requires_grad_() for t in (q, k, v))
    ref.flash_attention(qa, ka, va, causal=causal).backward(dout)
    for g_, t in zip(got, (qa, ka, va)):
        assert g_.shape == t.shape
        torch.testing.assert_close(g_.double(), t.grad, rtol=1e-4,
                                   atol=1e-4)


def test_kernel_output_layout_and_mla_v_view():
    """The kernel's output for dv != dqk keeps q's memory order, and the
    MLA layer's v (a head-major view of the wkv_b product) is a view the
    kernel reads in place."""
    q = torch.zeros((2, 9, 3, 48)).transpose(1, 2)      # [B, H, T, dqk]
    out = fa.empty_like_q(q, 32)
    assert out.shape == (2, 3, 9, 32)
    assert out.transpose(1, 2).is_contiguous()
    assert fa.empty_like_q(q.contiguous(), 32).is_contiguous()
    assert fa.empty_like_q(q, 48).stride() == torch.empty_like(q).stride()
    for dtype in (torch.float32, torch.bfloat16):
        kv = torch.zeros((2, 9, 3, 32 + 32), dtype=dtype)
        v = kv[..., 32:].transpose(1, 2)
        assert fa.view_strides("v", v) == (9 * 3 * 64, 64, 3 * 64)
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention_cuda(q, q, q[..., :32])


def _flash_fn_layouts(dtype):
    """q, k, v as ``MLAAttention`` hands them to the flash op (q a
    head-major view, k a concatenation with the expanded rope, v a view
    of a wider row), at the deepseek smoke config's (48, 32)."""
    gen = torch.Generator().manual_seed(4)
    b, t, h, nope, rope, vd = 2, 13, 4, 32, 16, 32
    q = torch.randn((b, t, h, nope + rope), generator=gen, dtype=dtype)
    kv = torch.randn((b, t, h, nope + vd), generator=gen, dtype=dtype)
    kr = torch.randn((b, t, 1, rope), generator=gen, dtype=dtype)
    return q, kv, kr


def test_flash_fn_plain_pair_takes_mla_layouts():
    """``FlashAttentionFn`` with the plain pair on the MLA layer's
    layouts: the gradients of q, of the latent product (through k's nope
    half and v's view) and of the shared rope equal autograd through the
    plain forward, at (dqk, dv) = (48, 32): f64 inputs, within 1e-5 (the
    pair's backward formulas compute in f32)."""
    grads = []
    for fn in ("pair", "autograd"):
        q, kv, kr = (x.requires_grad_() for x in _flash_fn_layouts(
            torch.float64))
        b, t, h = kv.shape[:3]
        k = torch.cat([kv[..., :32], kr.expand(b, t, h, 16)], dim=-1)
        args = (q.transpose(1, 2), k.transpose(1, 2),
                kv[..., 32:].transpose(1, 2))
        out = fa.FlashAttentionFn.apply(*args, True, None, fa.PLAIN_PAIR) \
            if fn == "pair" else ref.flash_attention(*args, causal=True)
        assert out.shape == (b, h, t, 32)
        out.backward(torch.linspace(-1, 1, out.numel(),
                                    dtype=torch.float64).view(out.shape))
        grads.append([x.grad for x in (q, kv, kr)])
    for got, want in zip(*grads):
        assert got.shape == want.shape
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def _moe_grads(dtype, plain, n_shared, cf, seed=3):
    gen = torch.Generator().manual_seed(seed)
    moe = MoE(24, 6, 16, n_shared, 2, cf, dtype, gen)
    x = (torch.randn((3, 10, 24), generator=gen) * 2).to(dtype)
    x.requires_grad_()
    if plain:
        moe.gather = lambda xf, disp: tmoe.gather_plain(xf, disp)
        moe.combine = lambda y, g, disp: tmoe.combine_plain(y, g, disp)
    out, aux = moe(x)
    g = torch.randn(out.shape, generator=gen).to(dtype)
    (out.float() * g.float()).sum().add(aux).backward()
    return {"x": x.grad, **{n: p.grad for n, p in moe.named_parameters()}}


@pytest.mark.parametrize("n_shared,cf", [(0, 1.0), (2, 0.6)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_backward_functions_equal_plain_autograd(dtype, n_shared, cf):
    """cf 0.6 drops assignments (their rows take no gradient); a repeat
    of the Functions' backward gives the same bits."""
    got = _moe_grads(dtype, False, n_shared, cf)
    want = _moe_grads(dtype, True, n_shared, cf)
    assert sorted(got) == sorted(want)
    for name, g in got.items():
        w = want[name]
        assert g.dtype == w.dtype, name
        tol = 1e-6 if dtype == torch.float32 else \
            1e-6 + 2.0 ** -7 * float(w.float().abs().max())
        torch.testing.assert_close(g.float(), w.float(), rtol=0, atol=tol,
                                   msg=name)
    again = _moe_grads(dtype, False, n_shared, cf)
    assert all(torch.equal(got[n], again[n]) for n in got)


def test_moe_dispatch_inverse_map():
    """``slot_asg`` inverts ``rows``: every kept assignment's row names
    it, every other row (empty slots, the drop row) names ``n_tok * k``,
    and ``slot_tok`` is its token."""
    gen = torch.Generator().manual_seed(0)
    moe = MoE(8, 5, 4, 0, 2, 0.7, torch.float32, gen)
    experts = torch.randint(0, 5, (23, 2), generator=gen)
    disp = moe.dispatch(experts)
    n_asg = experts.numel()
    assert disp.slot_asg.shape == (disp.slot_tok.numel() + 1,)
    kept = disp.rows.reshape(-1) < disp.slot_tok.numel()
    asg = torch.arange(n_asg)
    assert torch.equal(disp.slot_asg[disp.rows.reshape(-1)[kept]],
                       asg[kept])
    owned = torch.zeros(disp.slot_asg.shape, dtype=torch.bool)
    owned[disp.rows.reshape(-1)[kept]] = True
    assert bool((disp.slot_asg[~owned] == n_asg).all())
    assert torch.equal(disp.slot_tok.reshape(-1),
                       disp.slot_asg[:-1] // 2)
    assert int((~kept).sum()) > 0
