"""The port's kernel layer against the JAX package, on CPU.

The plain PyTorch versions (kernels/ref.py) must be bit-equal to the jnp
oracles of ``repro.kernels.ref`` and to the Pallas kernels in interpret
mode, on the cases of tests/test_kernels.py and tests/test_gpu_fetch.py
(tolerance 0: int32 set members). The CUDA kernels themselves run only on
a card: tests/test_torch_cuda.py holds them against the plain versions
there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.sorted_intersect import sorted_intersect_pallas

from repro_torch.kernels import dispatch, ops, ref


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


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


# --------------------------------------------------------------------------
# plain versions vs the jnp oracles and the Pallas kernel (interpret mode)
# --------------------------------------------------------------------------


@pytest.mark.parametrize("b,d", [(1, 128), (8, 128), (16, 256), (5, 384),
                                 (32, 512)])
def test_plain_intersect_equals_reference(b, d):
    rng = np.random.default_rng(b * 1000 + d)
    n = 3 * d
    a = _holes(rng, _rand_padded_sets(rng, b, d, n), n)
    bb = _rand_padded_sets(rng, b, d, n)
    want = np.asarray(jref.sorted_intersect(jnp.asarray(a), jnp.asarray(bb),
                                            n))
    for got in (ref.sorted_intersect(_t(a), _t(bb), n),
                ref.sorted_intersect_chunked(_t(a), _t(bb), n),
                ref.sorted_intersect_binary(_t(a), _t(bb), n),
                ops.intersect_padded(_t(a), _t(bb), n)):
        np.testing.assert_array_equal(got.numpy(), want)
    # b with interspersed holes: ref and chunked (binary needs sorted b)
    bh = _holes(rng, bb, n)
    want = np.asarray(jref.sorted_intersect(jnp.asarray(a), jnp.asarray(bh),
                                            n))
    for impl in ("ref", "chunked"):
        got = ops.intersect_padded(_t(a), _t(bh), n, impl=impl)
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("chunk", [32, 128, 200])
def test_plain_chunked_equals_reference(chunk):
    rng = np.random.default_rng(chunk)
    n = 500
    a = _rand_padded_sets(rng, 12, 256, n)
    b = _holes(rng, _rand_padded_sets(rng, 12, 256, n), n)
    want = jref.sorted_intersect_chunked(jnp.asarray(a), jnp.asarray(b), n,
                                         chunk=chunk)
    got = ref.sorted_intersect_chunked(_t(a), _t(b), n, chunk=chunk)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("b,d", [(8, 128), (16, 256)])
def test_intersect_padded_equals_pallas_interpret(b, d):
    rng = np.random.default_rng(7 * b + d)
    n = 2 * d
    a = _holes(rng, _rand_padded_sets(rng, b, d, n), n)
    bb = _rand_padded_sets(rng, b, d, n)
    want = sorted_intersect_pallas(jnp.asarray(a), jnp.asarray(bb), n,
                                   interpret=True)
    got = ops.intersect_padded(_t(a), _t(bb), n)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("da,db", [(128, 384), (256, 128)])
def test_mixed_widths_equal_reference_interpret(da, db):
    """The port takes Da != Db directly; the reference pads to the wider
    width for its Pallas kernel."""
    rng = np.random.default_rng(da + db)
    n = 600
    a = _holes(rng, _rand_padded_sets(rng, 8, da, n), n)
    bb = _rand_padded_sets(rng, 8, db, n)
    want = jops.intersect_padded(jnp.asarray(a), jnp.asarray(bb), n,
                                 impl="interpret")
    for impl in ("auto", "ref", "chunked", "binary"):
        got = ops.intersect_padded(_t(a), _t(bb), n, impl=impl)
        assert got.shape == (8, da)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("b,dc,d", [(1, 128, 128), (8, 128, 128),
                                    (16, 256, 128), (5, 64, 256),
                                    (32, 128, 384)])
def test_fused_gather_intersect_equals_reference(b, dc, d):
    rng = np.random.default_rng(b * 1000 + dc + d)
    n = 2 * d
    adj = _rand_adjacency(rng, n, d)
    cand = _holes(rng, _rand_padded_sets(rng, b, dc, n), n)
    ids = rng.integers(0, n + 1, size=b).astype(np.int32)
    args = (jnp.asarray(cand), jnp.asarray(ids), jnp.asarray(adj), n)
    want = np.asarray(jops.fused_gather_intersect(*args, impl="interpret"))
    np.testing.assert_array_equal(
        want, np.asarray(jops.fused_gather_intersect(*args, impl="ref")))
    for impl in ("auto", "ref", "chunked", "binary"):
        got = ops.fused_gather_intersect(_t(cand), _t(ids), _t(adj), n,
                                         impl=impl)
        np.testing.assert_array_equal(got.numpy(), want)


def test_fused_out_of_range_and_duplicate_ids_clip():
    n, d = 40, 128
    rng = np.random.default_rng(7)
    adj = _rand_adjacency(rng, n, d)
    cand = _rand_padded_sets(rng, 10, d, n)
    ids = np.array([-3, 0, n, n + 99, 1, 2, n, -1, 5, 5], np.int32)
    want = jops.fused_gather_intersect(jnp.asarray(cand), jnp.asarray(ids),
                                       jnp.asarray(adj), n, impl="interpret")
    got = ops.fused_gather_intersect(_t(cand), _t(ids), _t(adj), n)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# --------------------------------------------------------------------------
# binary-impl validation, dispatch order, the CPU/CUDA boundary
# --------------------------------------------------------------------------


@pytest.mark.parametrize("a,b,match", [
    ([[1, 2, 9, 9]], [[3, 1, 2, 9]], "fully ascending"),     # out of order
    ([[1, 2, 9, 9]], [[1, 9, 2, 9]], "fully ascending"),     # hole mid-row
    ([1, 2, 9], [[1, 2, 9]], "2-D operands"),                # 1-D
    (np.zeros((2, 4)), np.zeros((3, 4)), "shared batch"),   # batch mismatch
])
def test_binary_value_errors_match_reference(a, b, match):
    ja, jb = jnp.asarray(a, jnp.int32), jnp.asarray(b, jnp.int32)
    with pytest.raises(ValueError, match=match):
        jops.intersect_padded(ja, jb, 9, impl="binary")
    ta = torch.tensor(np.asarray(a), dtype=torch.int32)
    tb = torch.tensor(np.asarray(b), dtype=torch.int32)
    with pytest.raises(ValueError, match=match):
        ops.intersect_padded(ta, tb, 9, impl="binary")


def test_dispatch_order_explicit_env_device(monkeypatch):
    for op in ("intersect", "gather_intersect"):
        env = f"REPRO_TORCH_{op.upper()}_IMPL"
        monkeypatch.delenv(env, raising=False)
        assert dispatch.resolve_impl(op, platform="cuda") == "cuda"
        assert dispatch.resolve_impl(op, platform="cpu", width=64) == "ref"
        assert dispatch.resolve_impl(op, platform="cpu",
                                     width=1024) == "chunked"
        monkeypatch.setenv(env, "binary")
        assert dispatch.resolve_impl(op, platform="cuda") == "binary"
        assert dispatch.resolve_impl(op, "chunked", platform="cuda") == \
            "chunked"
        monkeypatch.delenv(env)
    # the JAX package's overrides never reach the port
    monkeypatch.setenv("REPRO_INTERSECT_IMPL", "pallas-interpret")
    monkeypatch.setenv("REPRO_GATHER_INTERSECT_IMPL", "pallas-interpret")
    assert dispatch.resolve_impl("intersect", platform="cpu",
                                 width=64) == "ref"
    assert dispatch.resolve_impl("gather_intersect",
                                 platform="cuda") == "cuda"
    with pytest.raises(ValueError, match="unknown impl"):
        dispatch.resolve_impl("intersect", "pallas", platform="cpu")
    with pytest.raises(ValueError, match="unknown kernel op"):
        dispatch.resolve_impl("nope", platform="cpu")


def test_fused_fetch_toggle(monkeypatch):
    """No environment variable moves a backend off its own fetch path."""
    from repro_torch.core.executor import make_executor
    from repro_torch.core.pattern import get_pattern
    from repro_torch.core.plangen import generate_best_plan
    from repro_torch.graph.generate import erdos_renyi
    g = erdos_renyi(30, 60, seed=1)
    plan = generate_best_plan(get_pattern("triangle"), g.stats())
    for var in ("REPRO_TORCH_FUSED_FETCH", "REPRO_FUSED_FETCH"):
        for val in ("0", "1"):
            monkeypatch.setenv(var, val)
            for engine, fused in (("torch", False), ("torch-gpu", True)):
                st = make_executor(engine, device="cpu").run(plan, g,
                                                             batch=8)
                assert st.extras["fused_fetch"] is fused
        monkeypatch.delenv(var)


def test_cuda_impl_on_cpu_tensors_raises(monkeypatch):
    a = torch.full((2, 8), 9, dtype=torch.int32)
    ids = torch.zeros(2, dtype=torch.int32)
    rows = torch.full((10, 8), 9, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensor"):
        ops.intersect_padded(a, a, 9, impl="cuda")
    with pytest.raises(ValueError, match="CUDA tensor"):
        ops.fused_gather_intersect(a, ids, rows, 9, impl="cuda")
    monkeypatch.setenv("REPRO_TORCH_INTERSECT_IMPL", "cuda")
    with pytest.raises(ValueError, match="CUDA tensor"):
        ops.intersect_padded(a, a, 9)


def test_library_path_hashes_the_headers_a_source_includes(monkeypatch,
                                                           tmp_path):
    """A library's build path is keyed by its source and by every csrc
    header it includes (followed through headers): an edit to a shared
    header rebuilds each library that includes it, and no other."""
    from repro_torch.kernels import build
    (tmp_path / "a.cu").write_text('#include "h1.cuh"\n#include <stdint.h>\n')
    (tmp_path / "b.cu").write_text("int b;\n")
    (tmp_path / "h1.cuh").write_text('#include "h2.cuh"\nint h1;\n')
    (tmp_path / "h2.cuh").write_text("int h2;\n")
    monkeypatch.setattr(build, "CSRC", tmp_path)
    assert [p.name for p in build._sources("a")] == ["a.cu", "h1.cuh",
                                                     "h2.cuh"]
    before = {n: build.library_path(n) for n in ("a", "b")}
    (tmp_path / "h2.cuh").write_text("int h2 = 1;\n")
    after = {n: build.library_path(n) for n in ("a", "b")}
    assert after["a"] != before["a"] and after["b"] == before["b"]
    assert after["a"].name.startswith("a-")
    (tmp_path / "h2.cuh").write_text("int h2;\n")
    assert build.library_path("a") == before["a"]


def test_both_flash_libraries_include_the_hopper_header():
    from repro_torch.kernels import build
    for name in ("flash_attention", "flash_attention_bwd"):
        assert [p.name for p in build._sources(name)] == [
            f"{name}.cu", "hopper.cuh"]
    assert [p.name for p in build._sources("rmsnorm_bwd")] == [
        "rmsnorm_bwd.cu"]
