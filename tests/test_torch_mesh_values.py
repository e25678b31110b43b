"""The dry-run's mesh paths on values: the LM programs on a real (2, 2)
mesh of 4 gloo ranks against the same programs without a mesh.

The dry-run (``launch/steps.py``) traces each cell's program on fake
tensors, so its counts are only as right as the program it traces. Some
of that program runs only under a mesh: the vocab-parallel embedding
(``layers/embedding_bag.lookup_sharded``), flash attention and RMSNorm on
local shards (``kernels/ops._local_flash`` / ``_local_rmsnorm``), the
heads split on local blocks (``ShardCtx.split_heads``), the MoE layer's
local dispatch with its explicit all-gathers (``MoE._forward_sharded``),
the decode over a sequence-sharded cache with its flash-decode combine
(``_decode_sharded`` of GQA and MLA) and the cross entropy over
vocab-sharded logits. Here the three LM smoke configs (qwen2: dense GQA
with bias and heads the model axis does not divide; granite: MoE, heads
split over it; deepseek: MLA, MoE with a shared expert, a dense first
layer) run in f32 with their parameters, batch and caches laid out by
``launch/shardings.py`` on a (data, model) = (2, 2) mesh, the model under
``ShardCtx(mesh, dp="data", tp="model")``, against the same weights with
``NO_SHARD``:

* training: the cross entropy, the aux loss (under a mesh each data rank
  routes its own tokens, so the aux is the mean over the data ranks of
  each block's; held against that mean computed without a mesh) and
  every gradient of ``ce + aux``;
* prefill: the last position's logits;
* decode: one step's logits and the caches after it, with the cache's
  sequence over "model" (decode_32k's layout, batch 2) and over every
  axis (long_500k's, batch 1), the new entry landing in a rank other
  than 0's block.

The MoE layers run without drops on both sides (``no_drops``), since the
capacity follows the local token count under a mesh. Tolerance: 2e-5 x
the largest magnitude of each tensor (the losses 1e-5 relative); the same
f32 sums in another order differ by at most 3.4e-6 x here. All ranks run
in one subprocess with a time limit, as ``test_torch_gnn_dist`` does, so
a rank waiting on a collective no other rank reaches fails the test
instead of hanging it.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from test_torch_dist import _finish, _start

ARCHS = ("qwen2-0.5b", "granite-moe-3b-a800m", "deepseek-v2-lite-16b")
MESH = (2, 2)
B, T = 4, 16                 # training / prefill batch and length
S_MAX, POS = 16, 11          # decode: cache slots, the position written
DECODE = {"decode_32k": (False, 2), "long_500k": (True, 1)}
TOL, LOSS_RTOL = 2e-5, 1e-5


def _distribute(model, specs, mesh, serving: bool):
    """``model``'s parameters as DTensors laid out by ``specs`` (under
    ``inference_mode`` for serving, as the dry-run lays them out)."""
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.launch.shardings import placements
    with torch.inference_mode(serving):
        for name, p in list(model.named_parameters()):
            owner, _, leaf = name.rpartition(".")
            mod = model.get_submodule(owner) if owner else model
            d = distribute_tensor(p.detach(), mesh,
                                  placements(specs[name], mesh))
            setattr(mod, leaf, torch.nn.Parameter(
                d, requires_grad=not serving))


def _whole(t):
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def _rank_cases(path: str) -> None:
    """One rank of the spawned gloo world: every case of every arch; rank
    0 writes ``{case|want, case|got}`` arrays to ``path``."""
    import torch.distributed as dist
    from torch.distributed.tensor import distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.shardings import (cache_specs, lm_param_specs,
                                              mesh_shape, placements,
                                              sanitize)
    from repro_torch.layers.common import ShardCtx
    from repro_torch.layers.moe import no_drops
    from repro_torch.models.transformer import (decode_step, forward,
                                                init_caches, init_params,
                                                loss_fn, prefill_step)
    torch.set_num_threads(1)
    mesh = make_mesh(MESH, ("data", "model"), "cpu")
    ms = mesh_shape(mesh)
    ctx = ShardCtx(mesh=mesh, dp=("data",), tp="model")
    out = {}

    def put(key, want, got):
        out[f"{key}|want"] = np.asarray(want.detach().double())
        out[f"{key}|got"] = np.asarray(_whole(got).detach().double())

    def spread(t, spec):
        return distribute_tensor(t, mesh, placements(spec, mesh))

    with implicit_replication():
        for arch in ARCHS:
            cfg = dataclasses.replace(get_config(arch).smoke().model_cfg,
                                      dtype=torch.float32)
            ref = init_params(cfg, seed=0, device="cpu")
            shapes = dict(ref.named_parameters())
            specs = sanitize(lm_param_specs(shapes), shapes, ms)
            gen = torch.Generator().manual_seed(1)
            toks = torch.randint(0, cfg.vocab, (B, T + 1), generator=gen)
            batch = {"tokens": toks[:, :-1].contiguous(),
                     "labels": toks[:, 1:].contiguous()}
            dbatch = {k: spread(v, ("data", None)) for k, v in batch.items()}

            # training: ce, the aux (the data ranks' mean) and gradients
            shd = init_params(cfg, seed=0, device="cpu")
            _distribute(shd, specs, mesh, serving=False)
            with no_drops(ref), no_drops(shd):
                _, m0 = loss_fn(ref, batch)
                half = B // MESH[0]
                aux0 = sum(forward(ref, batch["tokens"][i:i + half])[1]
                           for i in range(0, B, half)) / MESH[0]
                (m0["ce"] + aux0).backward()
                loss1, m1 = loss_fn(shd, dbatch, ctx=ctx)
                loss1.backward()
            put(f"{arch}|train|ce", m0["ce"], m1["ce"])
            put(f"{arch}|train|aux", aux0, m1["aux"])
            for (name, p0), (_, p1) in zip(ref.named_parameters(),
                                           shd.named_parameters()):
                put(f"{arch}|grad|{name}", p0.grad, p1.grad)

            # serving: prefill and decode
            for p in ref.parameters():
                p.requires_grad_(False)
            shd = init_params(cfg, seed=0, device="cpu")
            _distribute(shd, specs, mesh, serving=True)
            with no_drops(ref), no_drops(shd):
                put(f"{arch}|prefill|logits",
                    prefill_step(ref, batch["tokens"]),
                    prefill_step(shd, dbatch["tokens"], ctx=ctx))
                for cell, (long_ctx, b) in DECODE.items():
                    c0 = init_caches(cfg, b, S_MAX, device="cpu")
                    for c in c0:
                        for k, v in c.items():
                            if isinstance(v, torch.Tensor):
                                v.copy_(torch.randn(v.shape, generator=gen))
                        c["length"] = POS
                    c1 = []
                    for c, cs in zip(c0, cache_specs(c0, False, long_ctx)):
                        cs = sanitize(cs, c, ms)
                        d = {k: spread(v.clone(), cs[k])
                             for k, v in c.items()
                             if isinstance(v, torch.Tensor)}
                        c1.append(dict(d, length=POS))
                    tk = torch.randint(0, cfg.vocab, (b, 1), generator=gen)
                    tspec = sanitize({"t": ("data", None)}, {"t": tk}, ms)
                    put(f"{arch}|{cell}|logits",
                        decode_step(ref, c0, tk, POS)[0],
                        decode_step(shd, c1, spread(tk, tspec["t"]), POS,
                                    ctx=ctx)[0])
                    for i, (a, d) in enumerate(zip(c0, c1)):
                        for k, v in a.items():
                            if isinstance(v, torch.Tensor):
                                put(f"{arch}|{cell}|cache{i}.{k}", v, d[k])
    if dist.get_rank() == 0:
        np.savez(path, **out)


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("mesh") / "values.npz")
    proc = _start(f"""
        import test_torch_mesh_values as t
        from repro_torch.launch.enumerate import run_on_ranks
        run_on_ranks({MESH[0] * MESH[1]}, "cpu", t._rank_cases, {path!r})
    """, {"OMP_NUM_THREADS": "1"})
    _finish(proc, 300)
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _pairs(results, prefix):
    keys = sorted(k[:-5] for k in results if k.startswith(prefix)
                  and k.endswith("|want"))
    assert keys, prefix
    return [(k, results[f"{k}|want"], results[f"{k}|got"]) for k in keys]


def _close(pairs, tol):
    for key, want, got in pairs:
        assert got.shape == want.shape, key
        err = np.abs(got - want).max() if want.size else 0.0
        scale = np.abs(want).max() if want.size else 0.0
        assert err <= tol * max(scale, 1e-30), (key, err, scale)


@pytest.mark.parametrize("arch", ARCHS)
def test_training_losses_on_a_mesh_equal_no_mesh(results, arch):
    """ce equal; the aux equal to the mean of the data blocks' auxes."""
    for key, want, got in _pairs(results, f"{arch}|train|"):
        np.testing.assert_allclose(got, want, rtol=LOSS_RTOL, err_msg=key)


@pytest.mark.parametrize("arch", ARCHS)
def test_every_gradient_on_a_mesh_equals_no_mesh(results, arch):
    """Each parameter's gradient of ce + aux, whole, within TOL x its
    largest magnitude."""
    _close(_pairs(results, f"{arch}|grad|"), TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_on_a_mesh_equals_no_mesh(results, arch):
    _close(_pairs(results, f"{arch}|prefill|"), TOL)


@pytest.mark.parametrize("cell", sorted(DECODE))
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_over_a_sharded_cache_equals_no_mesh(results, arch, cell):
    """The step's logits and every cache after the write (the new entry
    in another rank's block) within TOL."""
    _close(_pairs(results, f"{arch}|{cell}|"), TOL)
