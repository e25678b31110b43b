"""The port's CUDA kernels on a card, against their plain versions.

Every test here is marked ``cuda`` and skips without a card (the kernels
have no CPU mode). This file imports neither jax nor the JAX package, so
it runs on a machine with a CUDA build of torch alone:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerance 0 for the set intersections and counts (int32 set members).
Flash attention takes strided ``[B, H, T, d]`` views (the GQA layer's
transposes of ``[B, T, H, d]`` activations) and raises on views TMA
cannot read; q and k may be wider than v (MLA: 192 and 128, the smoke
config's 48 and 32), with v a view of the layer's ``wkv_b`` product.
RMSNorm: 1e-5 in f32 (another summation order), one bf16 ulp of the
output in bf16 (one rounding), on both of the kernel's bodies and in a
replayed CUDA graph. Flash attention: 2e-5 with f32 inputs (online
softmax), 2e-2 abs with bf16 inputs against the f32 plain result
on the same (upcast) inputs. The smoke models on the card equal the same
models on the CPU within 2e-4, as tests/test_torch_lm.py holds them to
the JAX package, in serving and in a training step (the backward kernels,
with exact launch counts). The backward kernels against their plain
f32 formulas: 1e-4 x max|want| in f32, 1e-2 x max|want| (flash) and one
bf16 ulp plus 1e-6 x max|want| (rmsnorm) in bf16; both bit-equal from
launch to launch, the flash backward's bf16 body (``wgmma``) at ragged T,
d of 16 to 128 and every GQA group, and at q/k wider than v (MLA's 192 and
128 on the layer's layouts, every pair of box counts), rmsnorm's on both
of its bodies and at the MoE models' widths (512, 1536, 2048).
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref


def _rand_padded_sets(rng, b, d, n):
    rows = np.full((b, d), n, np.int32)
    for i in range(b):
        k = int(rng.integers(0, min(d, n) + 1))
        rows[i, :k] = np.sort(rng.choice(n, size=k, replace=False))
    return rows


def _rand_adjacency(rng, n, d):
    adj = np.full((n + 1, d), n, np.int32)   # row n = all-sentinel
    for v in range(n):
        k = int(rng.integers(0, min(d, n) + 1))
        adj[v, :k] = np.sort(rng.choice(n, size=k, replace=False))
    return adj


def _holes(rng, rows, n, p=0.3):
    """Interspersed holes (an INT result's shape); row 0 all holes."""
    out = np.where(rng.random(rows.shape) < p, n, rows).astype(np.int32)
    out[0] = n
    return out


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda", 0)


def _tail_only(rows, n):
    """Valid ascending entries first, holes only in the tail (a DBQ
    adjacency row's shape); row 1 all holes."""
    out = np.sort(rows, axis=1).astype(np.int32)
    out[1] = n
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["mid-row holes", "tail-only"])
@pytest.mark.parametrize("da,db", [(128, 128), (384, 128), (128, 640),
                                   (3968, 3968), (640, 3968), (3968, 640),
                                   (641, 641), (3967, 3967), (3967, 641),
                                   (5000, 9000)])
def test_sorted_intersect_kernel_bit_equal(card, da, db, layout):
    """b with holes anywhere (compacted) or only in its tail (kept as
    staged), all-sentinel rows, Da != Db, widths that are not multiples of
    4 (the scalar-load path) and rows wider than one round: bit-equal to
    the plain version."""
    from repro_torch.kernels import sorted_intersect as si
    rng = np.random.default_rng(da * 7 + db + len(layout))
    n = 4 * max(da, db)
    a = _holes(rng, _rand_padded_sets(rng, 64, da, n), n)
    b = _rand_padded_sets(rng, 64, db, n)
    b[2:10] = n                                  # rows 2..9 overlap a's
    b[2:10, :min(da, db)] = np.sort(a[2:10, :min(da, db)], axis=1)
    b = _tail_only(b, n) if layout == "tail-only" else _holes(rng, b, n)
    a, b = torch.from_numpy(a).to(card), torch.from_numpy(b).to(card)
    before = si.launches
    got = ops.intersect_padded(a, b, n)
    assert si.launches == before + 1
    np.testing.assert_array_equal(got.cpu().numpy(),
                                  ref.sorted_intersect(a, b, n).cpu().numpy())
    assert int((got != n).sum()) > 0
    with pytest.raises(ValueError, match="contiguous"):
        si.sorted_intersect_cuda(a[:, ::2], b[:, ::2], n)
    with pytest.raises(ValueError, match="int32"):
        si.sorted_intersect_cuda(a.long(), b.long(), n)


@pytest.mark.cuda
@pytest.mark.parametrize("dc,d", [(128, 128), (64, 256), (640, 640),
                                  (3968, 3968)])
def test_gather_intersect_kernel_bit_equal(card, dc, d):
    from repro_torch.kernels import gather_intersect as gi
    rng = np.random.default_rng(dc * 3 + d)
    n = 2 * d
    adj = torch.from_numpy(_rand_adjacency(rng, n, d)).to(card)
    cand = torch.from_numpy(_holes(rng, _rand_padded_sets(rng, 64, dc, n),
                                   n)).to(card)
    ids = rng.integers(-2, n + 3, size=64).astype(np.int32)
    ids[:8] = ids[8]                          # duplicates
    ids = torch.from_numpy(ids).to(card)
    before = gi.launches
    got = ops.fused_gather_intersect(cand, ids, adj, n)
    assert gi.launches == before + 1
    want = ops.fused_gather_intersect(cand, ids, adj, n, impl="ref")
    np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())
    with pytest.raises(ValueError, match="sentinel"):
        gi.gather_intersect_cuda(ids, cand, adj[:-1], n)


@pytest.mark.cuda
@pytest.mark.parametrize("pname", ["triangle", "square", "clique4", "house"])
def test_backends_on_the_card_equal_the_cpu(card, pname):
    """torch and torch-gpu on the card == torch on the CPU (plain
    versions): counts, frontier sizes and chunk accounting."""
    from repro_torch.core.executor import make_executor
    from repro_torch.core.pattern import get_pattern
    from repro_torch.core.plangen import generate_best_plan
    from repro_torch.graph.generate import powerlaw
    g = powerlaw(400, 6, seed=3)
    plan = generate_best_plan(get_pattern(pname), g.stats())
    n_enu = sum(i.op == "ENU" for i in plan.instrs)
    cfg = dict(batch=32, caps=[1024] * n_enu, max_retries=12)
    want = make_executor("torch", device="cpu").run(plan, g, **cfg)
    for engine in ("torch", "torch-gpu"):
        st = make_executor(engine, device=card).run(plan, g, **cfg)
        assert st.count == want.count
        assert (st.chunks_run, st.chunks_split, st.chunks_retried) == \
            (want.chunks_run, want.chunks_split, want.chunks_retried)
        np.testing.assert_array_equal(st.extras["level_sizes"],
                                      want.extras["level_sizes"])


def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """The spacing of bf16 values at |x| (8 significant bits)."""
    mag = x.float().abs().clamp_min(torch.finfo(torch.bfloat16).tiny)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


@pytest.mark.cuda
@pytest.mark.parametrize("rows,d", [(4, 896), (1000, 896), (7, 1001),
                                    (3, 8192), (5, 24)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_kernel_vs_plain(card, rows, d, dtype):
    from repro_torch.kernels import rmsnorm as rn
    gen = torch.Generator(device=card).manual_seed(rows + d)
    x = (torch.randn((rows, d), generator=gen, device=card) * 3).to(dtype)
    g = torch.randn((d,), generator=gen, device=card).to(dtype)
    before = rn.launches
    got = ops.rmsnorm(x, g, eps=1e-6)
    assert rn.launches == before + 1 and got.dtype == dtype
    want = ref.rmsnorm(x, g, eps=1e-6)
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    else:
        err = (got.float() - want.float()).abs()
        assert bool((err <= bf16_ulp(want)).all()), float(err.max())
    with pytest.raises(ValueError, match="contiguous"):
        rn.rmsnorm_cuda(x.t(), g)
    with pytest.raises(ValueError, match="gamma"):
        rn.rmsnorm_cuda(x, g.float() if dtype != torch.float32 else g[:-1])


def _offset_view(t: torch.Tensor) -> torch.Tensor:
    """t's values in a contiguous view one element into a buffer (not
    16-byte aligned)."""
    view = torch.empty(t.numel() + 1, dtype=t.dtype,
                       device=t.device)[1:].view(t.shape)
    return view.copy_(t)


@pytest.mark.cuda
@pytest.mark.parametrize("dqk,dv,b,h,hkv,tq,tk,causal,layout", [
    (192, 128, 2, 16, 16, 300, 300, True, "mla"),   # MLA as the layer
    (192, 128, 1, 16, 16, 1000, 1000, True, "dense"),
    (192, 128, 2, 4, 4, 300, 200, True, "mla"),     # rows that see no key
    (192, 128, 1, 4, 4, 200, 333, False, "mla"),
    (48, 32, 2, 4, 4, 130, 130, True, "mla"),       # the smoke config's
    (64, 64, 2, 14, 2, 257, 257, True, "dense"),
    (128, 64, 1, 6, 2, 1000, 1000, True, "dense"),
    (64, 128, 1, 6, 2, 1000, 1000, True, "dense"),
    (192, 64, 1, 6, 2, 130, 1000, True, "dense"),   # decode offset
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_bwd_unequal_widths(card, dqk, dv, b, h, hkv, tq,
                                            tk, causal, layout, dtype):
    """The backward at q/k wider than v (MLA's (192, 128): 32-query steps
    in the dk/dv kernel and 64-key tiles in the dq kernel of the bf16
    body) and at every other pair of box counts, on MLA's layouts (q a
    head-major view, k a concatenation with the expanded rope, v a view of
    a wider row) or dense tensors: within 1e-4 x max|want| (f32) and 1e-2
    x max|want| (bf16) of the plain f32 formulas, each gradient of its
    input's shape, two launches bit-equal."""
    from repro_torch.kernels import flash_attention as fa
    gen = torch.Generator(device=card).manual_seed(dqk + dv + tq + tk)

    def rand(*shape):
        return torch.randn(shape, generator=gen, device=card).to(dtype)
    if layout == "mla":
        nope = dqk - 64 if dqk == 192 else dqk - 16
        q = rand(b, tq, h, dqk).transpose(1, 2)
        kv = rand(b, tk, h, nope + dv)
        rope = rand(b, tk, 1, dqk - nope)
        k = torch.cat([kv[..., :nope], rope.expand(b, tk, h, dqk - nope)],
                      dim=-1).transpose(1, 2)
        v = kv[..., nope:].transpose(1, 2)
    else:
        q, k, v = rand(b, h, tq, dqk), rand(b, hkv, tk, dqk), \
            rand(b, hkv, tk, dv)
    out, lse = fa.flash_attention_lse_cuda(q, k, v, causal)
    dout = rand(*out.shape)
    got = fa.flash_attention_bwd_cuda(q, k, v, out, lse, dout, causal)
    want = ref.flash_attention_backward(q.float(), k.float(), v.float(),
                                        out.float(), lse, dout.float(),
                                        causal)
    rel = 1e-4 if dtype == torch.float32 else 1e-2
    for g, w, t in zip(got, want, (q, k, v)):
        assert g.dtype == dtype and g.shape == t.shape
        torch.testing.assert_close(g.float(), w, rtol=0,
                                   atol=rel * float(w.abs().max()))
    again = fa.flash_attention_bwd_cuda(q, k, v, out, lse, dout, causal)
    assert all(torch.equal(x, y) for x, y in zip(got, again))


@pytest.mark.cuda
@pytest.mark.parametrize("rows,d,offset", [
    (16384, 896, False), (4, 896, False), (1, 896, False), (0, 896, False),
    (33, 2048, False), (5, 3072, False), (3, 8192, False), (7, 1001, False),
    (17, 896, True), (3, 8192, True)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_bodies_vs_plain(card, rows, d, offset, dtype):
    """The register body at every group width the plan takes (1, 2, 4, 8
    warps a row), and the block body (d = 1001, misaligned views, and rows
    wider than the lanes' registers: f32 d = 8192, a misaligned d = 8192),
    against the plain version; the per-body launch counters."""
    from repro_torch.kernels import rmsnorm as rn
    gen = torch.Generator(device=card).manual_seed(rows + d + offset)
    x = (torch.randn((rows, d), generator=gen, device=card) * 3).to(dtype)
    g = torch.randn((d,), generator=gen, device=card).to(dtype)
    if offset:
        x = _offset_view(x)
    aligned = x.data_ptr() % 16 == 0
    assert aligned != offset
    body = rn.rmsnorm_plan(rows, d, dtype, aligned).body
    assert body == ("block" if offset or d == 1001 or
                    (d == 8192 and dtype == torch.float32) else "register")
    before, by_body = rn.launches, dict(rn.body_launches)
    got = rn.rmsnorm_cuda(x, g, 1e-6)
    torch.cuda.synchronize()
    n = 1 if rows else 0
    assert rn.launches == before + n
    assert rn.body_launches == {**by_body, body: by_body[body] + n}
    want = ref.rmsnorm(x, g, eps=1e-6)
    assert got.shape == want.shape and got.dtype == dtype
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    else:
        err = (got.float() - want.float()).abs()
        assert bool((err <= bf16_ulp(want)).all()), float(err.max())


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [4, 16384])
def test_rmsnorm_graph_replay_equals_eager(card, rows):
    """rmsnorm_cuda captured in a CUDA graph and replayed on new inputs ==
    eager on them; capturing counts one launch a captured call, a replay
    none."""
    from repro_torch.kernels import rmsnorm as rn
    gen = torch.Generator(device=card).manual_seed(rows)
    x = torch.randn((rows, 896), generator=gen, device=card).bfloat16()
    g = torch.randn((896,), generator=gen, device=card).bfloat16()
    side = torch.cuda.Stream(card)
    side.wait_stream(torch.cuda.current_stream(card))
    with torch.cuda.stream(side):                  # warm-up off the graph
        rn.rmsnorm_cuda(x, g)
    torch.cuda.current_stream(card).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = rn.launches
    with torch.cuda.graph(graph):
        outs = [rn.rmsnorm_cuda(x, g) for _ in range(3)]
    assert rn.launches == before + 3
    x.copy_(torch.randn((rows, 896), generator=gen, device=card))
    graph.replay()
    torch.cuda.synchronize()
    assert rn.launches == before + 3
    want = rn.rmsnorm_cuda(x, g)
    for out in outs:
        assert torch.equal(out, want)


@pytest.mark.cuda
def test_rmsnorm_launcher_refuses_plans_it_cannot_run(card):
    """The C launcher checks the plan it is given and returns
    cudaErrorInvalidValue (1) for one it cannot run, launching nothing."""
    from repro_torch.kernels import rmsnorm as rn
    x = torch.randn((8, 896), device=card).bfloat16()
    g = torch.randn((896,), device=card).bfloat16()
    out = torch.empty_like(x)
    good = rn.rmsnorm_plan(8, 896, torch.bfloat16, True)
    assert good == ("register", 8, 1, 8, 1)

    def launch(plan, xp=x.data_ptr()):
        return rn._launcher()(
            xp, g.data_ptr(), out.data_ptr(), 8, 896, 1e-6, 1,
            rn.BODY_CODES.get(plan.body, 7), *plan[1:], card.index,
            torch.cuda.current_stream(card).cuda_stream)
    bad = [good._replace(grid=2),                  # more blocks than tiles
           good._replace(grid=0),
           good._replace(rows_per_block=4),        # grid != tiles
           good._replace(warps=2),                 # 512 threads
           good._replace(warps=0),
           good._replace(warps=3, rows_per_block=1, grid=8),  # no instance
           good._replace(vec=4),
           good._replace(body="other"),
           good._replace(body="block"),            # rows_per_block != 1
           good._replace(body="block", rows_per_block=1, vec=3, grid=8),
           good._replace(vec=1, rows_per_block=1, grid=8)]  # regs: vectors
    for plan in bad:
        assert launch(plan) == 1, plan
    assert launch(good, xp=x.data_ptr() + 2) == 1   # misaligned x
    assert launch(good) == 0
    torch.cuda.synchronize()
    torch.testing.assert_close(out, rn.rmsnorm_cuda(x, g), rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("b,hq,hkv,tq,tk,d,causal", [
    (2, 14, 2, 256, 256, 64, True),      # qwen2-0.5b heads
    (1, 16, 2, 192, 192, 128, True),     # qwen2.5-3b heads
    (1, 4, 2, 1000, 1000, 64, True),     # ragged tails
    (1, 4, 2, 256, 1024, 64, True),      # decode offset
    (1, 4, 2, 256, 128, 64, True),       # rows that see no key
    (2, 4, 4, 130, 70, 32, False),       # not causal, ragged
    (1, 7, 1, 33, 33, 16, True),         # qwen2 smoke heads
    (1, 2, 1, 64, 100, 8, True),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_vs_plain(card, b, hq, hkv, tq, tk, d,
                                         causal, dtype):
    from repro_torch.kernels import flash_attention as fa
    gen = torch.Generator(device=card).manual_seed(tq * 7 + tk + d)

    def rand(h, t):
        return torch.randn((b, h, t, d), generator=gen,
                           device=card).to(dtype)

    q, k, v = rand(hq, tq), rand(hkv, tk), rand(hkv, tk)
    before = fa.launches
    got = ops.flash_attention(q, k, v, causal=causal)
    assert fa.launches == before + 1 and got.dtype == dtype
    want = ref.flash_attention(q.float(), k.float(), v.float(),
                               causal=causal)
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want, rtol=0 if tol == 2e-2
                               else tol, atol=tol)
    if causal and tk < tq:                     # the mean-of-V rows
        mean_v = v.float().mean(dim=2, keepdim=True)
        rep = mean_v.repeat_interleave(hq // hkv, dim=1)
        torch.testing.assert_close(got[:, :, :tq - tk].float(),
                                   rep.expand(-1, -1, tq - tk, -1),
                                   rtol=0, atol=tol)
    # strided views are taken (test_flash_attention_on_strided_views);
    # what TMA cannot read raises: a last dimension that is not contiguous,
    # a base that is not 16-byte aligned
    with pytest.raises(ValueError, match="stride 1"):
        fa.flash_attention_cuda(q.transpose(2, 3), k, v)
    flat = torch.zeros(q.numel() + 1, dtype=dtype, device=card)
    with pytest.raises(ValueError, match="aligned"):
        fa.flash_attention_cuda(flat[1:].view(q.shape), k, v)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [8, 16, 32, 64, 128])
@pytest.mark.parametrize("tq,tk", [(1, 1), (127, 127), (129, 129),
                                   (1000, 1000), (1, 1000), (127, 1000),
                                   (1000, 129)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_on_strided_views(card, d, tq, tk, dtype):
    """[B, H, T, d] views of [B, T, H, d] tensors, as the GQA layer passes
    them (ragged against the 128-row tiles; (1, 1000) and (127, 1000) are
    decode offsets, (1000, 129) has rows that see no key): equal to the
    contiguous call and to the plain version; the output keeps q's
    [B, T, H, d] memory order."""
    from repro_torch.kernels import flash_attention as fa
    gen = torch.Generator(device=card).manual_seed(tq * 3 + tk + d)
    b, hq, hkv = 2, 6, 2

    def rand(h, t):
        return torch.randn((b, t, h, d), generator=gen,
                           device=card).to(dtype).transpose(1, 2)

    q, k, v = rand(hq, tq), rand(hkv, tk), rand(hkv, tk)
    before = fa.launches
    got = fa.flash_attention_cuda(q, k, v)
    assert fa.launches == before + 1
    assert got.transpose(1, 2).is_contiguous()   # [B, T, H, d] memory
    same = fa.flash_attention_cuda(q.contiguous(), k.contiguous(),
                                   v.contiguous())
    want = ref.flash_attention(q.float(), k.float(), v.float())
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), same.float(), rtol=0, atol=tol)
    torch.testing.assert_close(got.float(), want, rtol=0 if tol == 2e-2
                               else tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dqk,dv", [(48, 32), (192, 128), (64, 64),
                                    (128, 64), (64, 128), (192, 64)])
@pytest.mark.parametrize("b,hq,hkv,tq,tk,causal", [
    (2, 16, 16, 256, 256, True),          # MLA's heads (no GQA)
    (1, 6, 2, 1000, 1000, True),          # GQA, ragged tails
    (1, 4, 2, 129, 700, True),            # decode offset
    (1, 4, 4, 200, 77, True),             # rows that see no key
    (2, 4, 1, 130, 70, False),            # not causal, ragged
])
@pytest.mark.parametrize("views", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_unequal_widths_vs_plain(card, dqk, dv, b, hq, hkv,
                                                 tq, tk, causal, views,
                                                 dtype):
    """q and k ``dqk`` wide, v ``dv`` wide: equal to the plain version on
    the same inputs. ``views``: as the MLA layer passes them, q and k
    ``[B, H, T, d]`` views of ``[B, T, H, d]`` tensors and v a view of
    the columns past ``dqk - 16`` of a ``[B, T, H, dqk - 16 + dv]``
    product; the output keeps q's ``[B, T, H, *]`` memory order."""
    from repro_torch.kernels import flash_attention as fa
    gen = torch.Generator(device=card).manual_seed(dqk + dv + tq + tk)

    def rand(h, t, d):
        if views:
            return torch.randn((b, t, h, d), generator=gen,
                               device=card).to(dtype).transpose(1, 2)
        return torch.randn((b, h, t, d), generator=gen,
                           device=card).to(dtype)

    q, k = rand(hq, tq, dqk), rand(hkv, tk, dqk)
    if views:
        nope = dqk - 16
        v = rand(hkv, tk, nope + dv)[..., nope:]
    else:
        v = rand(hkv, tk, dv)
    before = fa.launches
    got = ops.flash_attention(q, k, v, causal=causal)
    assert fa.launches == before + 1 and got.dtype == dtype
    assert got.shape == (b, hq, tq, dv)
    assert got.transpose(1, 2).is_contiguous() == views
    want = ref.flash_attention(q.float(), k.float(), v.float(),
                               causal=causal)
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want, rtol=0 if tol == 2e-2
                               else tol, atol=tol)
    if views:
        same = fa.flash_attention_cuda(q.contiguous(), k.contiguous(),
                                       v.contiguous(), causal=causal)
        torch.testing.assert_close(got.float(), same.float(), rtol=0,
                                   atol=tol)


@pytest.mark.cuda
def test_flash_attention_refuses_widths_past_its_limits(card):
    """dqk past 192 or dv past 128 (or not a multiple of 8) raises, in the
    forward and in the backward; the backward takes MLA's (192, 128) and
    refuses an output or its gradient of another width than v's."""
    from repro_torch.kernels import flash_attention as fa

    def z(*shape, dtype=torch.bfloat16):
        return torch.zeros(shape, dtype=dtype, device=card)
    # f32 rows of 12 and 20 keep 16-byte strides: the width check refuses
    for dqk, dv, dtype in ((200, 128, torch.bfloat16),
                           (192, 136, torch.bfloat16),
                           (192, 12, torch.float32), (20, 64, torch.float32)):
        with pytest.raises(ValueError, match="dqk"):
            fa.flash_attention_cuda(z(1, 2, 8, dqk, dtype=dtype),
                                    z(1, 2, 8, dqk, dtype=dtype),
                                    z(1, 2, 8, dv, dtype=dtype))
    q, k, v = z(1, 2, 8, 192), z(1, 2, 8, 192), z(1, 2, 8, 128)
    out, lse = fa.flash_attention_lse_cuda(q, k, v)
    dq, dk, dv = fa.flash_attention_bwd_cuda(q, k, v, out, lse, out)
    assert (dq.shape, dk.shape, dv.shape) == (q.shape, k.shape, v.shape)
    with pytest.raises(ValueError, match="dout"):
        fa.flash_attention_bwd_cuda(q, k, v, out, lse, q)
    with pytest.raises(ValueError, match="dqk"):
        fa.flash_attention_bwd_cuda(z(1, 2, 8, 200), z(1, 2, 8, 200), v,
                                    out, lse, out)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen2-0.5b", "qwen2.5-3b",
                                  "phi4-mini-3.8b", "granite-moe-3b-a800m",
                                  "deepseek-v2-lite-16b"])
def test_smoke_lm_on_the_card_equals_the_cpu(card, arch):
    """prefill_step and a teacher-forced serve loop of the f32 smoke model
    on the card (the kernels) == the same weights on the CPU (the plain
    versions); launch counts per forward and per decode step (MLA adds its
    latent norm to each layer's two). The decode after the whole prompt
    equals the prefill; for an MoE model with ``capacity_factor = E / k``
    in every MoE layer, so that neither drops an assignment."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rmsnorm as rn
    from repro_torch.layers.moe import no_drops
    from repro_torch.models import transformer as ttf
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(arch).smoke().model_cfg
    norms = (3 if cfg.attn_kind == "mla" else 2) * cfg.n_layers + 1
    cpu = ttf.init_params(cfg, seed=0, device="cpu")
    gpu = ttf.Transformer(cfg, torch.Generator(device=card))
    gpu.load_state_dict(cpu.state_dict())
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 24)))
    fa.launches = rn.launches = 0
    got = ttf.prefill_step(gpu, toks.to(card))
    assert (fa.launches, rn.launches) == (cfg.n_layers, norms)
    torch.testing.assert_close(got.cpu(), ttf.prefill_step(cpu, toks),
                               rtol=2e-4, atol=2e-4)
    c_cpu = ttf.init_caches(cfg, 2, 24, device="cpu")
    c_gpu = ttf.init_caches(cfg, 2, 24, device=card)
    with no_drops(cpu), no_drops(gpu):
        for i in range(toks.shape[1]):
            fa.launches = rn.launches = 0
            lg, c_gpu = ttf.decode_step(gpu, c_gpu,
                                        toks[:, i:i + 1].to(card), i)
            assert (fa.launches, rn.launches) == (0, norms)
            want, c_cpu = ttf.decode_step(cpu, c_cpu, toks[:, i:i + 1], i)
            torch.testing.assert_close(lg.cpu(), want, rtol=2e-4, atol=2e-4)
        torch.testing.assert_close(lg.cpu(), ttf.prefill_step(cpu, toks),
                                   rtol=2e-4, atol=2e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("b,hq,hkv,tq,tk,d,causal,strided", [
    (2, 14, 2, 256, 256, 64, True, True),      # qwen2-0.5b heads, as the layer
    (1, 4, 4, 130, 130, 64, True, False),      # group 1, ragged
    (1, 14, 2, 200, 200, 64, False, True),     # not causal
    (1, 4, 2, 256, 128, 64, True, False),      # rows that see no key
    (1, 7, 1, 33, 90, 16, True, False),        # group 7, decode offset
    (1, 16, 2, 100, 100, 128, True, True),     # d = 128
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_bwd_kernel_vs_plain(card, b, hq, hkv, tq, tk, d,
                                             causal, strided, dtype):
    """The backward kernel == ``ref.flash_attention_backward`` on the same
    inputs (the kernel forward's out and lse): 1e-4 x max|want| in f32,
    1e-2 x max|want| in bf16 (one rounding of each output); the forward's
    lse == the plain lse within 1e-4; two launches bit-equal (no
    atomics)."""
    from repro_torch.kernels import flash_attention as fa
    gen = torch.Generator(device=card).manual_seed(tq * 5 + tk + d)

    def rand(h, t):
        if strided:
            return torch.randn((b, t, h, d), generator=gen, device=card
                               ).to(dtype).transpose(1, 2)
        return torch.randn((b, h, t, d), generator=gen,
                           device=card).to(dtype)

    q, k, v, dout = rand(hq, tq), rand(hkv, tk), rand(hkv, tk), rand(hq, tq)
    out, lse = fa.flash_attention_lse_cuda(q, k, v, causal)
    _, want_lse = ref.flash_attention(q, k, v, causal, return_lse=True)
    torch.testing.assert_close(lse, want_lse, rtol=0, atol=1e-4)
    before = fa.bwd_launches
    got = fa.flash_attention_bwd_cuda(q, k, v, out, lse, dout, causal)
    assert fa.bwd_launches == before + 1
    want = ref.flash_attention_backward(q.float(), k.float(), v.float(),
                                        out.float(), lse, dout.float(),
                                        causal)
    rel = 1e-4 if dtype == torch.float32 else 1e-2
    for g, w, t in zip(got, want, (q, k, v)):
        assert g.dtype == dtype and g.stride() == torch.empty_like(t).stride()
        torch.testing.assert_close(g.float(), w, rtol=0,
                                   atol=rel * float(w.abs().max()))
    again = fa.flash_attention_bwd_cuda(q, k, v, out, lse,
                                        dout.contiguous(), causal)
    assert all(torch.equal(x, y) for x, y in zip(got, again))


@pytest.mark.cuda
@pytest.mark.parametrize("b,hq,hkv,tq,tk,d,causal,strided", [
    (1, 7, 1, 1000, 1000, 64, True, True),     # group 7, ragged
    (2, 4, 2, 130, 130, 16, True, False),      # group 2, d = 16
    (1, 2, 2, 130, 1000, 128, True, True),     # group 1, decode offset
    (1, 4, 2, 1000, 130, 64, True, False),     # rows that see no key
    (1, 4, 2, 130, 1000, 16, True, True),
    (1, 14, 2, 1000, 130, 128, False, True),   # not causal
    (2, 7, 1, 130, 1000, 64, False, False),
    (1, 4, 4, 1000, 1000, 128, True, False),
    (1, 4, 2, 1000, 130, 16, True, True),      # no key, d = 16, views
])
def test_flash_attention_bwd_bf16_body(card, b, hq, hkv, tq, tk, d, causal,
                                       strided):
    """The bf16 body (wgmma, P and dS as bf16 operands) at T that are not
    multiples of its 64- and 128-row tiles, d of 16, 64 and 128, GQA
    groups 1, 2 and 7, causal or not, rows that see no key and strided
    [B, H, T, d] views of [B, T, H, d] tensors: within 1e-2 x max|want| of
    the plain f32 formulas on the same inputs; two launches bit-equal;
    dout made contiguous (another layout of the same values) gives the
    same bits."""
    from repro_torch.kernels import flash_attention as fa
    gen = torch.Generator(device=card).manual_seed(tq * 11 + tk + d)

    def rand(h, t):
        if strided:
            return torch.randn((b, t, h, d), generator=gen, device=card
                               ).to(torch.bfloat16).transpose(1, 2)
        return torch.randn((b, h, t, d), generator=gen,
                           device=card).to(torch.bfloat16)

    q, k, v, dout = rand(hq, tq), rand(hkv, tk), rand(hkv, tk), rand(hq, tq)
    out, lse = fa.flash_attention_lse_cuda(q, k, v, causal)
    before = fa.bwd_launches
    got = fa.flash_attention_bwd_cuda(q, k, v, out, lse, dout, causal)
    again = fa.flash_attention_bwd_cuda(q, k, v, out, lse, dout, causal)
    other = fa.flash_attention_bwd_cuda(q, k, v, out, lse,
                                        dout.contiguous(), causal)
    torch.cuda.synchronize()
    assert fa.bwd_launches == before + 3
    want = ref.flash_attention_backward(q.float(), k.float(), v.float(),
                                        out.float(), lse, dout.float(),
                                        causal)
    for g, w, t in zip(got, want, (q, k, v)):
        assert g.dtype == torch.bfloat16
        assert g.stride() == torch.empty_like(t).stride()
        assert bool(torch.isfinite(g).all())
        torch.testing.assert_close(g.float(), w, rtol=0,
                                   atol=1e-2 * float(w.abs().max()))
    assert all(torch.equal(x, y) for x, y in zip(got, again))
    assert all(torch.equal(x, y) for x, y in zip(got, other))
    if causal and tk < tq:               # rows that see no key: no dq
        assert not got[0][:, :, :tq - tk].any()


@pytest.mark.cuda
@pytest.mark.parametrize("dqk,dv,b,h,hkv,tq,tk,causal,layout", [
    (192, 128, 2, 16, 16, 300, 300, True, "mla"),   # MLA as the layer
    (192, 128, 1, 16, 16, 1000, 1000, True, "dense"),
    (192, 128, 2, 4, 4, 300, 200, True, "mla"),     # rows that see no key
    (192, 128, 1, 4, 4, 200, 333, False, "mla"),
    (48, 32, 2, 4, 4, 130, 130, True, "mla"),       # the smoke config's
    (64, 64, 2, 14, 2, 257, 257, True, "dense"),
    (128, 64, 1, 6, 2, 1000, 1000, True, "dense"),
    (64, 128, 1, 6, 2, 1000, 1000, True, "dense"),
    (192, 64, 1, 6, 2, 130, 1000, True, "dense"),   # decode offset
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_bwd_unequal_widths(card, dqk, dv, b, h, hkv, tq,
                                            tk, causal, layout, dtype):
    """The backward at q/k wider than v (MLA's (192, 128): 32-query steps
    in the dk/dv kernel and 64-key tiles in the dq kernel of the bf16
    body) and at every other pair of box counts, on MLA's layouts (q a
    head-major view, k a concatenation with the expanded rope, v a view of
    a wider row) or dense tensors: within 1e-4 x max|want| (f32) and 1e-2
    x max|want| (bf16) of the plain f32 formulas, each gradient of its
    input's shape, two launches bit-equal."""
    from repro_torch.kernels import flash_attention as fa
    gen = torch.Generator(device=card).manual_seed(dqk + dv + tq + tk)

    def rand(*shape):
        return torch.randn(shape, generator=gen, device=card).to(dtype)
    if layout == "mla":
        nope = dqk - 64 if dqk == 192 else dqk - 16
        q = rand(b, tq, h, dqk).transpose(1, 2)
        kv = rand(b, tk, h, nope + dv)
        rope = rand(b, tk, 1, dqk - nope)
        k = torch.cat([kv[..., :nope], rope.expand(b, tk, h, dqk - nope)],
                      dim=-1).transpose(1, 2)
        v = kv[..., nope:].transpose(1, 2)
    else:
        q, k, v = rand(b, h, tq, dqk), rand(b, hkv, tk, dqk), \
            rand(b, hkv, tk, dv)
    out, lse = fa.flash_attention_lse_cuda(q, k, v, causal)
    dout = rand(*out.shape)
    got = fa.flash_attention_bwd_cuda(q, k, v, out, lse, dout, causal)
    want = ref.flash_attention_backward(q.float(), k.float(), v.float(),
                                        out.float(), lse, dout.float(),
                                        causal)
    rel = 1e-4 if dtype == torch.float32 else 1e-2
    for g, w, t in zip(got, want, (q, k, v)):
        assert g.dtype == dtype and g.shape == t.shape
        torch.testing.assert_close(g.float(), w, rtol=0,
                                   atol=rel * float(w.abs().max()))
    again = fa.flash_attention_bwd_cuda(q, k, v, out, lse, dout, causal)
    assert all(torch.equal(x, y) for x, y in zip(got, again))


@pytest.mark.cuda
@pytest.mark.parametrize("rows,d,offset", [
    (16384, 896, False), (4, 896, False), (1, 896, False), (0, 896, False),
    (33, 2048, False), (5, 3072, False), (3, 8192, False), (2000, 64, False),
    (7, 1001, False), (17, 896, True), (3, 8192, True)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_bwd_bodies_vs_plain(card, rows, d, offset, dtype):
    """The backward takes the forward's plan: the register body at every
    group width (1, 2, 4, 8 warps a row), the block body for d = 1001,
    misaligned views and f32 rows wider than the lanes' registers; R = 0
    launches nothing. Tolerances as test_rmsnorm_bwd_kernel_vs_plain;
    bit-equal from launch to launch."""
    from repro_torch.kernels import rmsnorm as rn
    gen = torch.Generator(device=card).manual_seed(rows + d + offset + 1)
    x = (torch.randn((rows, d), generator=gen, device=card) * 3).to(dtype)
    g = torch.randn((rows, d), generator=gen, device=card).to(dtype)
    gamma = torch.randn((d,), generator=gen, device=card).to(dtype)
    if offset:
        x, g = _offset_view(x), _offset_view(g)
    aligned = x.data_ptr() % 16 == 0
    assert aligned != offset
    body = rn.rmsnorm_plan(rows, d, dtype, aligned).body
    assert body == ("block" if offset or d == 1001 or
                    (d == 8192 and dtype == torch.float32) else "register")
    before, by_body = rn.bwd_launches, dict(rn.bwd_body_launches)
    got = rn.rmsnorm_bwd_cuda(x, gamma, g, 1e-6)
    again = rn.rmsnorm_bwd_cuda(x, gamma, g, 1e-6)
    torch.cuda.synchronize()
    n = 2 if rows else 0
    assert rn.bwd_launches == before + n
    assert rn.bwd_body_launches == {**by_body, body: by_body[body] + n}
    want = ref.rmsnorm_backward(x.float(), gamma.float(), g.float(), 1e-6)
    for gt, w in zip(got, want):
        assert gt.dtype == dtype and gt.shape == w.shape
        err = (gt.float() - w).abs()
        scale = float(w.abs().max()) if w.numel() else 0.0
        bound = 1e-4 * scale if dtype == torch.float32 else \
            bf16_ulp(w) + 1e-6 * scale
        assert bool((err <= bound).all()), float(err.max())
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
@pytest.mark.parametrize("rows,d", [(4, 896), (1000, 896), (7, 1001),
                                    (33, 2048), (3, 8192), (2000, 64),
                                    (16384, 512), (16384, 1536),
                                    (16384, 2048)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_bwd_kernel_vs_plain(card, rows, d, dtype):
    """dx and dgamma == ``ref.rmsnorm_backward`` in f32: 1e-4 x max|want|
    in f32; in bf16 one bf16 ulp of the f32 value plus 1e-6 x max|want|;
    deterministic."""
    from repro_torch.kernels import rmsnorm as rn
    gen = torch.Generator(device=card).manual_seed(rows + d)
    x = (torch.randn((rows, d), generator=gen, device=card) * 3).to(dtype)
    g = torch.randn((rows, d), generator=gen, device=card).to(dtype)
    gamma = torch.randn((d,), generator=gen, device=card).to(dtype)
    before = rn.bwd_launches
    got = rn.rmsnorm_bwd_cuda(x, gamma, g, 1e-6)
    assert rn.bwd_launches == before + 1
    want = ref.rmsnorm_backward(x.float(), gamma.float(), g.float(), 1e-6)
    for gt, w in zip(got, want):
        assert gt.dtype == dtype
        err = (gt.float() - w).abs()
        scale = float(w.abs().max())
        bound = 1e-4 * scale if dtype == torch.float32 else \
            bf16_ulp(w) + 1e-6 * scale
        assert bool((err <= bound).all()), float(err.max())
    again = rn.rmsnorm_bwd_cuda(x, gamma, g, 1e-6)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
def test_autograd_functions_run_the_kernels_on_the_card(card):
    """Under autograd ``ops`` go through the Functions with the CUDA pair
    (one forward and one backward launch each), which equal the same
    Functions over the plain pair; under inference_mode no backward and
    no lse."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rmsnorm as rn
    gen = torch.Generator(device=card).manual_seed(0)
    qkv = [torch.randn((2, h, 64, 32), generator=gen, device=card)
           for h in (4, 2, 2)]
    dout = torch.randn((2, 4, 64, 32), generator=gen, device=card)
    grads = []
    for pair in (fa.CUDA_PAIR, fa.PLAIN_PAIR):
        ts = [t.clone().requires_grad_() for t in qkv]
        fa.FlashAttentionFn.apply(*ts, True, None, pair).backward(dout)
        grads.append([t.grad for t in ts])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)
    ts = [t.clone().requires_grad_() for t in qkv]
    before = (fa.launches, fa.bwd_launches)
    ops.flash_attention(*ts).backward(dout)
    assert (fa.launches, fa.bwd_launches) == (before[0] + 1, before[1] + 1)
    x = torch.randn((3, 5, 96), generator=gen, device=card,
                    requires_grad=True)
    gamma = torch.randn((96,), generator=gen, device=card,
                        requires_grad=True)
    before = (rn.launches, rn.bwd_launches)
    ops.rmsnorm(x, gamma).square().sum().backward()
    assert (rn.launches, rn.bwd_launches) == (before[0] + 1, before[1] + 1)
    xc, gc = x.detach().cpu().requires_grad_(), \
        gamma.detach().cpu().requires_grad_()
    ref.rmsnorm(xc, gc).square().sum().backward()
    torch.testing.assert_close(x.grad.cpu(), xc.grad, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(gamma.grad.cpu(), gc.grad, rtol=1e-4,
                               atol=1e-4)
    before = (fa.bwd_launches, rn.bwd_launches)
    with torch.inference_mode():
        ops.flash_attention(*qkv)
        ops.rmsnorm(x, gamma)
    assert (fa.bwd_launches, rn.bwd_launches) == before


@pytest.mark.cuda
@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("arch", ["qwen2-0.5b", "phi4-mini-3.8b"])
def test_training_step_on_the_card_equals_the_cpu(card, arch, remat):
    """One loss_fn + backward of the f32 smoke model on the card (the
    kernels and their backward kernels) == the same weights on the CPU
    (autograd over the plain versions) within 2e-4; the launches of the
    step are exact: flash L forwards (2L with remat, the recompute) and L
    backwards, rmsnorm 2L + 1 forwards (4L + 1 with remat) and 2L + 1
    backwards."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.data.pipelines import LMStream
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rmsnorm as rn
    from repro_torch.models import transformer as ttf
    from repro_torch.train.loop import to_device
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_config(arch).smoke().model_cfg,
                              remat=remat)
    L = cfg.n_layers
    cpu = ttf.init_params(cfg, seed=0, device="cpu")
    gpu = ttf.Transformer(cfg, torch.Generator(device=card))
    gpu.load_state_dict(cpu.state_dict())
    batch = LMStream(vocab=cfg.vocab, seq_len=64, global_batch=2).batch(0)
    fa.launches = fa.bwd_launches = rn.launches = rn.bwd_launches = 0
    loss, _ = ttf.loss_fn(gpu, to_device(batch, card))
    loss.backward()
    torch.cuda.synchronize()
    fwd = 2 if remat else 1
    assert (fa.launches, fa.bwd_launches, rn.launches, rn.bwd_launches) == \
        (fwd * L, L, 2 * fwd * L + 1, 2 * L + 1)
    want, _ = ttf.loss_fn(cpu, to_device(batch, "cpu"))
    want.backward()
    torch.testing.assert_close(loss.cpu(), want.detach(), rtol=2e-4,
                               atol=2e-4)
    for (n, p), q in zip(gpu.named_parameters(), cpu.parameters()):
        torch.testing.assert_close(p.grad.cpu(), q.grad, rtol=2e-4,
                                   atol=2e-4, msg=n)


@pytest.mark.cuda
@pytest.mark.parametrize("pname", ["triangle", "square", "clique4", "house"])
def test_oocache_on_the_card_equals_the_cpu(card, pname):
    """oocache on the card (pinned staging, side-stream prefetch, the
    intersect kernel) == oocache on the CPU: counts, chunk accounting,
    frontier sizes and every cache counter."""
    from repro_torch.core.executor import make_executor
    from repro_torch.core.pattern import get_pattern
    from repro_torch.core.plangen import generate_best_plan
    from repro_torch.graph.generate import powerlaw
    from repro_torch.kernels import sorted_intersect as si
    g = powerlaw(400, 6, seed=3)
    plan = generate_best_plan(get_pattern(pname), g.stats())
    n_enu = sum(i.op == "ENU" for i in plan.instrs)
    cfg = dict(batch=32, caps=[1024] * n_enu, max_retries=12)
    kw = dict(cache_rows=48, hot=16)
    want = make_executor("oocache", device="cpu", **kw).run(plan, g, **cfg)
    si.launches = 0
    st = make_executor("oocache", device=card, **kw).run(plan, g, **cfg)
    assert si.launches > 0
    assert st.count == want.count
    assert (st.chunks_run, st.chunks_split, st.chunks_retried) == \
        (want.chunks_run, want.chunks_split, want.chunks_retried)
    np.testing.assert_array_equal(st.extras["level_sizes"],
                                  want.extras["level_sizes"])
    assert st.extras["cache"] == want.extras["cache"]
    assert st.extras["cache"]["prefetch_used"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("storage", ["device", "host"])
@pytest.mark.parametrize("pname", ["dtoy", "q1'", "q2'", "q3'", "q5'"])
def test_sbenu_torch_on_the_card_equals_the_cpu(card, pname, storage):
    """sbenu-torch on the card (the intersect kernel, holes kept in place)
    == sbenu-torch on the CPU (binary probe, rows re-sorted): ΔR⁺/ΔR⁻
    sets and per-level frontier sizes, step by step."""
    from repro_torch.core.estimate import GraphStats
    from repro_torch.core.executor import SBenuTorchBackend, drive
    from repro_torch.core.executor import ExecutorConfig
    from repro_torch.core.pattern import get_pattern
    from repro_torch.core.sbenu import generate_best_sbenu_plans
    from repro_torch.graph.dynamic import SnapshotStore, stream_width_floors
    from repro_torch.graph.generate import edge_stream
    from repro_torch.kernels import sorted_intersect as si
    g0, batches = edge_stream(n=300, m_init=1500, steps=3, batch=80,
                              seed=4, delete_frac=0.3)
    plans = generate_best_sbenu_plans(get_pattern(pname),
                                      GraphStats(300, 1500, delta_edges=80))
    d, dd = stream_width_floors(g0, batches)
    stores = {dev: SnapshotStore(g0) for dev in ("cpu", "cuda")}
    backends = {dev: SBenuTorchBackend(d_min=d, delta_d_min=dd,
                                       snapshot_storage=storage, device=dev)
                for dev in ("cpu", "cuda")}
    for batch in batches:
        out = {}
        for dev, store in stores.items():
            store.begin_step(batch)
            si.launches = 0
            st = drive(backends[dev], plans, store,
                       ExecutorConfig(batch=16, collect_matches=True))
            out[dev] = (st, si.launches)
            store.end_step()
        (c, _), (g, launches) = out["cpu"], out["cuda"]
        assert launches > 0
        assert g.extras["delta_plus"] == c.extras["delta_plus"]
        assert g.extras["delta_minus"] == c.extras["delta_minus"]
        np.testing.assert_array_equal(g.extras["level_sizes"],
                                      c.extras["level_sizes"])
    assert backends["cuda"].dstore.rebuilds == 1


@pytest.mark.cuda
def test_device_derive_equals_derive_host(card):
    """derive_rows on the card == the host twin the host storage uses."""
    from repro_torch.graph.dynamic import (DeviceSnapshotStore,
                                           SnapshotStore, derive_rows)
    from repro_torch.graph.generate import edge_stream
    g0, batches = edge_stream(n=2000, m_init=16000, steps=2, batch=3000,
                              seed=1, delete_frac=0.3)
    st = SnapshotStore(g0)
    host = DeviceSnapshotStore(st, storage="host", device="cpu")
    for batch in batches:
        st.begin_step(batch)
        host._ensure_prev_fits()
        for di, delta in (("out", st.delta_out), ("in", st.delta_in)):
            tids, merged = host._derive_host(host._prev[di], delta)
            vals, signs, _ = host._delta_buffers(delta)
            got = derive_rows(
                torch.from_numpy(host._prev[di].to_rows()).to(card),
                torch.from_numpy(tids).to(card),
                torch.from_numpy(vals).to(card),
                torch.from_numpy(signs).to(card), st.n)
            np.testing.assert_array_equal(got.cpu().numpy(), merged)
        host.step_snapshot()
        st.end_step()


@pytest.mark.cuda
def test_prefetch_race_serves_staged_rows_exactly(card):
    """The side-stream copy of a staged block is held back (a long sleep
    queued ahead of it), the host refills the pinned buffers and the
    store right after each prefetch returns, and lookups must still
    serve exactly the rows that were staged."""
    from repro_torch.distributed.rowcache import DeviceRowCache
    from repro_torch.graph.hoststore import HostRowStore
    n, d, stage = 24000, 4096, 8192
    rng = np.random.default_rng(0)
    rows = rng.integers(0, n, (n + 1, d), dtype=np.int32)
    rows[n] = n
    oracle = rows.copy()
    store = HostRowStore([rows], n, n + 1)
    cache = DeviceRowCache(store, capacity_rows=4 * stage, hot=0,
                           stage_rows=stage, device=card)
    blocks = [np.arange(k * stage, min((k + 1) * stage, n))
              for k in range(3)]
    with torch.cuda.stream(cache._side):
        torch.cuda._sleep(200_000_000)              # delay the first copy
    for ids in blocks:
        cache.prefetch(ids)       # the third refills pinned buffer 0
        store.shards[0][ids] = -7                   # refill the host side
    assert cache.stats.prefetch_rows == n
    got = cache.lookup(np.concatenate(blocks))
    np.testing.assert_array_equal(got.cpu().numpy(), oracle[:n])
    assert cache.stats.cold_rows == 0
    assert cache.stats.prefetch_used == n


@pytest.fixture
def nccl_world(card, tmp_path):
    """An NCCL process group of one rank (one card) and a gloo group of
    the same rank for CPU tensors, destroyed after the test."""
    import torch.distributed as dist
    torch.cuda.set_device(card)
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/pg",
                            rank=0, world_size=1)
    try:
        yield dist.group.WORLD, dist.new_group(backend="gloo")
    finally:
        dist.destroy_process_group()


def _dist_summary(st):
    x = st.extras
    return (st.count, x["per_shard_counts"].tolist(),
            x["per_shard_level_sizes"].tolist(), x["cold_rows_fetched"],
            st.drops_seen, st.chunks_run, st.chunks_split, st.chunks_retried)


@pytest.mark.cuda
@pytest.mark.parametrize("pname", ["triangle", "chordal-square", "house"])
@pytest.mark.parametrize("hot,rebalance", [(16, True), (0, False)])
def test_dist_over_nccl_equals_gloo_on_the_cpu(nccl_world, card, pname, hot,
                                               rebalance):
    """dist on the card over NCCL (the row exchange, the rebalancer and
    the intersect kernel) == dist on the CPU over gloo: counts, per-shard
    counts and level sizes, cold rows, drops and chunk accounting."""
    from repro_torch.core.executor import make_executor
    from repro_torch.core.pattern import get_pattern
    from repro_torch.core.plangen import generate_best_plan
    from repro_torch.graph.generate import powerlaw
    from repro_torch.kernels import sorted_intersect as si
    nccl, gloo = nccl_world
    g = powerlaw(400, 6, seed=3)
    plan = generate_best_plan(get_pattern(pname), g.stats())
    kw = dict(hot=hot, rebalance=rebalance)
    want = make_executor("dist", group=gloo, device="cpu", **kw).run(
        plan, g, batch=32)
    si.launches = 0
    st = make_executor("dist", group=nccl, device=card, **kw).run(
        plan, g, batch=32)
    assert si.launches > 0
    assert _dist_summary(st) == _dist_summary(want)
    if pname == "house":
        assert st.drops_seen > 0          # the budget escalated on the card
    with pytest.raises(ValueError, match="cannot carry cpu"):
        make_executor("dist", group=nccl, device="cpu").run(plan, g, batch=8)


@pytest.mark.cuda
@pytest.mark.parametrize("pname", ["q1'", "q2'"])
def test_sbenu_dist_over_nccl_equals_gloo_on_the_cpu(nccl_world, card,
                                                     pname):
    """sbenu-dist on the card over NCCL == sbenu-dist on the CPU over gloo:
    ΔR⁺/ΔR⁻ sets, per-shard counts and level sizes and cold rows, step by
    step, one sharded snapshot build each."""
    from repro_torch.core.estimate import GraphStats
    from repro_torch.core.executor import (ExecutorConfig, SBenuDistBackend,
                                           drive)
    from repro_torch.core.pattern import get_pattern
    from repro_torch.core.sbenu import generate_best_sbenu_plans
    from repro_torch.graph.dynamic import SnapshotStore, stream_width_floors
    from repro_torch.graph.generate import edge_stream
    from repro_torch.kernels import sorted_intersect as si
    nccl, gloo = nccl_world
    g0, batches = edge_stream(n=300, m_init=1500, steps=3, batch=80,
                              seed=4, delete_frac=0.3)
    plans = generate_best_sbenu_plans(get_pattern(pname),
                                      GraphStats(300, 1500, delta_edges=80))
    d, dd = stream_width_floors(g0, batches)
    runs = {"cpu": (gloo, "cpu"), "cuda": (nccl, card)}
    stores = {k: SnapshotStore(g0) for k in runs}
    backends = {k: SBenuDistBackend(d_min=d, delta_d_min=dd, hot=16,
                                    rebalance=True, group=grp, device=dev)
                for k, (grp, dev) in runs.items()}
    for batch in batches:
        out = {}
        for k, store in stores.items():
            store.begin_step(batch)
            si.launches = 0
            st = drive(backends[k], plans, store,
                       ExecutorConfig(batch=16, collect_matches=True))
            out[k] = (st, si.launches)
            store.end_step()
        (c, _), (g, launches) = out["cpu"], out["cuda"]
        assert launches > 0
        for key in ("delta_plus", "delta_minus", "cold_rows_fetched"):
            assert g.extras[key] == c.extras[key], key
        for key in ("per_shard_counts", "per_shard_level_sizes"):
            np.testing.assert_array_equal(g.extras[key], c.extras[key])
    assert all(be.dstore.rebuilds == 1 for be in backends.values())


@pytest.mark.cuda
def test_kernel_ops_dispatcher_equals_ctypes_and_fake(card):
    """The dispatcher ops (``kernels/library.py``) launch the same kernels
    as the ctypes launches they wrap (bit-equal), and each fake
    implementation gives the launched output's shape, dtype and strides:
    flash attention on strided ``[B, H, T, d]`` views (its output in q's
    layout), RMSNorm and the intersects."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import gather_intersect as gi
    from repro_torch.kernels import library
    from repro_torch.kernels import rmsnorm as rn
    from repro_torch.kernels import sorted_intersect as si
    rng = np.random.default_rng(0)
    q = torch.randn((2, 9, 4, 32), device=card).bfloat16().transpose(1, 2)
    k = torch.randn((2, 9, 2, 32), device=card).bfloat16().transpose(1, 2)
    s = 32 ** -0.5
    out, lse = fa.launch_forward(q, k, k, True, s, True)
    x = torch.randn((5, 896), device=card).bfloat16()
    g = torch.randn((896,), device=card).bfloat16()
    n = 64
    a = torch.from_numpy(_rand_padded_sets(rng, 8, 16, n)).to(card)
    adj = torch.from_numpy(_rand_adjacency(rng, n, 16)).to(card)
    ids = torch.from_numpy(rng.integers(0, n, 8).astype(np.int32)).to(card)
    cases = {
        "flash_attention": ((q, k, k, True, s),
                            lambda: fa.launch_forward(q, k, k, True, s,
                                                      False)[0]),
        "flash_attention_lse": ((q, k, k, True, s),
                                lambda: fa.launch_forward(q, k, k, True, s,
                                                          True)),
        "flash_attention_bwd": ((q, k, k, out, lse, out, True, s),
                                lambda: fa.launch_backward(q, k, k, out, lse,
                                                           out, True, s)),
        "rmsnorm": ((x, g, 1e-6), lambda: rn.launch_forward(x, g, 1e-6)),
        "rmsnorm_bwd": ((x, g, x, 1e-6),
                        lambda: rn.launch_backward(x, g, x, 1e-6)),
        "sorted_intersect": ((a, a, n), lambda: si.launch(a, a, n)),
        "gather_intersect": ((ids, a, adj, n),
                             lambda: gi.launch(ids, a, adj, n)),
    }
    for name, (args, launch) in cases.items():
        got = library.op(name)(*args)
        want = launch()
        with FakeTensorMode(allow_non_fake_inputs=True) as fm:
            fake = library.op(name)(*[fm.from_tensor(t) if isinstance(
                t, torch.Tensor) else t for t in args])
        got, want, fake = (r if isinstance(r, tuple) else (r,)
                           for r in (got, want, fake))
        for gt, wt, ft in zip(got, want, fake):
            assert torch.equal(gt, wt), name
            assert (ft.shape, ft.dtype, ft.stride()) == \
                (gt.shape, gt.dtype, gt.stride()), name
