"""The RMSNorm kernel's launch plan (``repro_torch.kernels.rmsnorm``), on
the CPU.

``rmsnorm_plan`` picks the kernel's body (its launch shape) before a
launch on the card. Here the index math of ``csrc/rmsnorm.cu`` is replayed
from a plan: every row and every vector of d is covered exactly once,
blocks stay within 256 threads, and the register body holds its row in
the lanes' registers. The widths of the three dense LM configs take the
register body; widths not a multiple of the 16-byte vector and misaligned
views (a contiguous view that starts one element into a buffer; at
d = 896, ``x[1:]`` stays aligned) take the block body. A torch emulation
of the register body's lane assignment and reduction order (per-lane
``fmaf`` over its slots, a butterfly of warp shuffles, then the warps of
a row in order) equals the JAX package's ``rmsnorm_pallas`` in interpret
mode: 1e-6 rel in f32 (another summation order, rsqrt), one bf16 ulp of
the output in bf16 (one rounding).
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops

from repro_torch.configs import get_config
from repro_torch.kernels import rmsnorm as rn

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _rows_covered(plan, R):
    """Row of (block, group) for every group of the grid, past R dropped."""
    rows = (np.arange(plan.grid)[:, None] * plan.rows_per_block
            + np.arange(plan.rows_per_block)[None, :]).ravel()
    return rows[rows < R]


def _vectors_covered(plan, nvec):
    """Vector index of (lane, load) for every lane of a row's group: lane
    t takes t, t + G, t + 2G, ... below nvec."""
    lanes = 32 * plan.warps
    loads = max(1, -(-nvec // lanes))
    j = np.arange(loads)[:, None] * lanes + np.arange(lanes)[None, :]
    return j[j < nvec]


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("d", [24, 896, 1001, 2048, 3072, 8192])
@pytest.mark.parametrize("R", [0, 1, 4, 7, 9, 33, 257, 1000, 16384, 16385])
def test_plan_covers_rows_and_vectors_once(R, d, dtype, aligned):
    plan = rn.rmsnorm_plan(R, d, DTYPES[dtype], aligned)
    vec16 = 16 // torch.tensor([], dtype=DTYPES[dtype]).element_size()
    assert plan.threads <= rn.MAX_THREADS and plan.threads % 32 == 0
    assert plan.vec == (vec16 if aligned and d % vec16 == 0 else 1)
    nvec = d // plan.vec
    assert plan.vec * nvec == d
    rows = _rows_covered(plan, R)
    np.testing.assert_array_equal(np.sort(rows), np.arange(R))
    vecs = _vectors_covered(plan, nvec)
    np.testing.assert_array_equal(np.sort(vecs), np.arange(nvec))
    if plan.body == "register":
        # the fewest warps (a power of two) whose lanes hold the row
        assert plan.warps in (1, 2, 4, 8)
        assert nvec <= 32 * plan.warps * rn.SLOTS
        assert plan.warps == 1 or nvec > 16 * plan.warps * rn.SLOTS
        assert plan.grid == -(-R // plan.rows_per_block)
        # as many rows a block as fit, and no more than R
        assert plan.rows_per_block == max(
            1, min(rn.MAX_THREADS // (32 * plan.warps), R))
    else:
        assert plan.grid == R and plan.rows_per_block == 1
        assert plan.threads == min(rn.MAX_THREADS,
                                   max(32, -(-nvec // 32) * 32))


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "qwen2.5-3b",
                                  "phi4-mini-3.8b"])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_config_widths_take_the_register_body(arch, dtype):
    d = get_config(arch).model_cfg.d_model
    assert d in (896, 2048, 3072)
    for R in (1, 4, 16384):
        plan = rn.rmsnorm_plan(R, d, DTYPES[dtype], True)
        assert plan.body == "register", plan
        assert rn.rmsnorm_plan(R, d, DTYPES[dtype], False).body == "block"
    if d == 896 and dtype == "bfloat16":    # a warp a row, 8 rows a block
        assert rn.rmsnorm_plan(16384, d, torch.bfloat16,
                               True) == ("register", 8, 1, 8, 2048)


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m",
                                  "deepseek-v2-lite-16b"])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_moe_and_mla_widths_take_a_register_body_the_backward_runs(arch,
                                                                  dtype):
    """The MoE models' block norms (1536, 2048) and MLA's latent norm
    (512) plan the register body, forward and backward, at the training
    and decode rows: one or two warps a row, which
    ``csrc/rmsnorm_bwd.cu`` instantiates (1, 2, 4 or 8), every row in
    some chunk."""
    cfg = get_config(arch).model_cfg
    widths = [cfg.d_model] + ([cfg.kv_lora_rank]
                              if cfg.attn_kind == "mla" else [])
    assert widths in ([1536], [2048, 512])
    for d in widths:
        for R in (4, 16384):
            plan = rn.rmsnorm_plan(R, d, DTYPES[dtype], True)
            assert plan.body == "register" and plan.warps in (1, 2, 4, 8)
            assert 32 * plan.warps * rn.SLOTS * plan.vec >= d
            chunks = rn.bwd_chunks(R, plan)
            assert 1 <= chunks <= min(R, rn.BWD_CHUNKS)
            assert -(-R // -(-R // chunks)) == chunks


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_other_inputs_take_the_block_body(dtype):
    dt = DTYPES[dtype]
    assert rn.rmsnorm_plan(7, 1001, dt, True).body == "block"
    assert rn.rmsnorm_plan(7, 16384, dt, True).body == "block"
    # rows of 896 are 16-byte multiples, so x[1:] of [5, 896] stays
    # aligned; a view one element into a flat buffer is contiguous and
    # misaligned
    x = torch.zeros((5, 896), dtype=dt)
    assert x[1:].data_ptr() % 16 == 0
    view = torch.zeros(4 * 896 + 1, dtype=dt)[1:].view(4, 896)
    assert view.is_contiguous() and view.data_ptr() % 16 != 0
    assert rn.rmsnorm_plan(4, 896, dt,
                           view.data_ptr() % 16 == 0).body == "block"


def emulate_register_body(x: torch.Tensor, gamma: torch.Tensor, eps: float,
                          plan) -> torch.Tensor:
    """The register body of ``csrc/rmsnorm.cu`` in torch, lane by lane:
    lane t of a row's group holds vectors ``k * 32 * warps + t`` (zeros
    past d), sums its squares with fmaf in slot and element order (in f64,
    rounded to f32 per step), the warp sums by an xor butterfly
    (16, 8, 4, 2, 1), the warps of a row are summed in order, and the row
    is scaled as ``(x * r) * gamma`` in f32 with one cast."""
    R, d = x.shape
    lanes, nvec = 32 * plan.warps, d // plan.vec
    xf = x.float()
    slots = torch.zeros((R, rn.SLOTS * lanes, plan.vec))
    slots[:, :nvec] = xf.reshape(R, nvec, plan.vec)
    slots = slots.reshape(R, rn.SLOTS, lanes, plan.vec)
    ss = torch.zeros((R, lanes))
    for k in range(rn.SLOTS):
        for e in range(plan.vec):
            f = slots[:, k, :, e].double()
            ss = (f * f + ss.double()).float()
    s = ss.reshape(R, plan.warps, 32)
    idx = torch.arange(32)
    for off in (16, 8, 4, 2, 1):
        s = s + s[..., idx ^ off]
    assert bool((s == s[..., :1]).all())       # every lane holds the sum
    total = s[:, 0, 0]
    for w in range(1, plan.warps):
        total = total + s[:, w, 0]
    r = torch.rsqrt(total / d + eps)
    return (xf * r[:, None] * gamma.float()).to(x.dtype)


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    mag = np.maximum(np.abs(x), np.float32(2.0 ** -126))
    return np.exp2(np.floor(np.log2(mag)) - 7)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", [(64, 896), (7, 2048), (5, 3072)])
def test_register_body_emulation_equals_pallas_interpret(shape, dtype):
    rng = np.random.default_rng(sum(shape) + len(dtype))
    td = DTYPES[dtype]
    x = torch.from_numpy((rng.normal(size=shape) * 3).astype(np.float32)
                         ).to(td)
    g = torch.from_numpy(rng.normal(size=shape[-1:]).astype(np.float32)
                         ).to(td)
    plan = rn.rmsnorm_plan(*shape, td, True)
    assert plan.body == "register"
    got = emulate_register_body(x, g, 1e-6, plan).float().numpy()
    np_dt = np.float32 if dtype == "float32" else ml_dtypes.bfloat16
    want = jops.rmsnorm(jnp.asarray(x.float().numpy().astype(np_dt)),
                        jnp.asarray(g.float().numpy().astype(np_dt)),
                        eps=1e-6, impl="interpret")
    want = np.asarray(want, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    else:
        assert (np.abs(got - want) <= _bf16_ulp(want)).all(), \
            float(np.abs(got - want).max())


@pytest.mark.parametrize("d", [896, 1001, 2048, 8192])
def test_backward_chunks_cover_every_row_once(d):
    """The backward's chunks (``bwd_chunks``) for the forward's plan: at
    most BWD_CHUNKS chunks of ``ceil(R / chunks)`` consecutive rows, none
    empty; on the register body no more chunks than give each of a
    block's groups BWD_ROWS_PER_GROUP rows."""
    for R in list(range(1, 300)) + [16384, 100_000, 1_000_000]:
        plan = rn.rmsnorm_plan(R, d, torch.bfloat16, True)
        chunks = rn.bwd_chunks(R, plan)
        per = -(-R // chunks)
        assert 1 <= chunks <= min(R, rn.BWD_CHUNKS)
        assert (chunks - 1) * per < R <= chunks * per
        if plan.body == "register":
            least = plan.rows_per_block * rn.BWD_ROWS_PER_GROUP
            assert chunks <= -(-R // least)
    assert rn.bwd_chunks(16384, rn.rmsnorm_plan(
        16384, 896, torch.bfloat16, True)) == 256
