"""The port's CUDA kernels on a card, against their plain versions.

Every test here is marked ``cuda`` and skips without a card (the kernels
have no CPU mode). This file imports neither jax nor the JAX package, so
it runs on a machine with a CUDA build of torch alone:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerance 0: the values are int32 set members and counts.
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


@pytest.mark.cuda
@pytest.mark.parametrize("da,db", [(128, 128), (384, 128), (128, 640),
                                   (3968, 3968)])
def test_sorted_intersect_kernel_bit_equal(card, da, db):
    from repro_torch.kernels import sorted_intersect as si
    rng = np.random.default_rng(da * 7 + db)
    n = 4 * max(da, db)
    a = torch.from_numpy(_holes(rng, _rand_padded_sets(rng, 64, da, n),
                                n)).to(card)
    b = torch.from_numpy(_holes(rng, _rand_padded_sets(rng, 64, db, n),
                                n)).to(card)
    before = si.launches
    got = ops.intersect_padded(a, b, n)
    assert si.launches == before + 1
    np.testing.assert_array_equal(got.cpu().numpy(),
                                  ref.sorted_intersect(a, b, n).cpu().numpy())
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
