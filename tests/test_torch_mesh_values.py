"""The dry-run's mesh paths on values: the LM programs on a real (2, 2)
mesh of 4 gloo ranks against the same programs without a mesh.

The dry-run (``launch/steps.py``) traces each cell's program on fake
tensors, so its counts are only as right as the program it traces. Some
of that program runs only under a mesh: the vocab-parallel embedding
(``layers/embedding_bag.lookup_sharded``), flash attention and RMSNorm on
local shards (``kernels/ops._local_flash`` / ``_local_rmsnorm``), the
heads split on local blocks (``ShardCtx.split_heads``), the MoE layer's
global-capacity dispatch and its combine where the slots are
(``MoE._forward_sharded``), the decode over a sequence-sharded cache
with its flash-decode combine
(``_decode_sharded`` of GQA and MLA) and the cross entropy over
vocab-sharded logits. Here the three LM smoke configs (qwen2: dense GQA
with bias and heads the model axis does not divide; granite: MoE, heads
split over it; deepseek: MLA, MoE with a shared expert, a dense first
layer) run in f32 with their parameters, batch and caches laid out by
``launch/shardings.py`` on a (data, model) = (2, 2) mesh, the model under
``ShardCtx(mesh, dp="data", tp="model")``, against the same weights with
``NO_SHARD``:

* training: the cross entropy, the aux loss and every gradient of
  ``ce + aux``;
* prefill: the last position's logits;
* decode: one step's logits and the caches after it, with the cache's
  sequence over "model" (decode_32k's layout, batch 2) and over every
  axis (long_500k's, batch 1), the new entry landing in a rank other
  than 0's block.

The MoE layers run without drops on both sides (``no_drops``) in these
cases; granite's MoE layer and training with drops, at the config's
capacity factor, follow on (2, 2) and (4, 1) meshes. Tolerance: 2e-5 x
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
    from repro_torch.models.transformer import (decode_step, init_caches,
                                                init_params, loss_fn,
                                                prefill_step)
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
                loss0, m0 = loss_fn(ref, batch)
                loss0.backward()
                loss1, m1 = loss_fn(shd, dbatch, ctx=ctx)
                loss1.backward()
            put(f"{arch}|train|ce", m0["ce"], m1["ce"])
            put(f"{arch}|train|aux", m0["aux"], m1["aux"])
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
    """ce and the aux equal."""
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


# --------------------------------------------------------------------------
# granite's MoE with drops: the reference's global capacity on a mesh
# --------------------------------------------------------------------------

DROP_MESHES = ((2, 2), (4, 1))
DROP_SEED = 0
DROP_TIMEOUT_S = 240


def _drops_rank(path: str, ms) -> None:
    """One rank: granite's smoke MoE layer (out and aux) and its training
    loss and every gradient at the config's capacity factor, on the mesh
    ``ms`` and without one; the assignments each dispatch drops, per
    call. Rank 0 writes the arrays and the drop counts (the mesh's summed
    over the data ranks of model rank 0) to ``path``."""
    import torch.distributed as dist
    from torch.distributed.tensor import distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.shardings import (lm_param_specs, mesh_shape,
                                              placements, sanitize)
    from repro_torch.layers.common import ShardCtx
    from repro_torch.layers.moe import MoE
    from repro_torch.models.transformer import init_params, loss_fn
    torch.set_num_threads(1)
    mesh = make_mesh(ms, ("data", "model"), "cpu")
    ctx = ShardCtx(mesh=mesh, dp=("data",), tp="model")
    cfg = get_config("granite-moe-3b-a800m").smoke().model_cfg
    drops = {"want": [], "got": []}
    side = ["want"]
    orig = MoE.dispatch

    def counted(self, experts, *a, **k):
        disp = orig(self, experts, *a, **k)
        e = self.router.shape[1]
        drops[side[0]].append(int((disp.rows == e * disp.cap).sum()))
        return disp
    MoE.dispatch = counted
    out = {}

    def put(key, want, got):
        out[f"{key}|want"] = np.asarray(want.detach().double())
        out[f"{key}|got"] = np.asarray(_whole(got).detach().double())

    gen = torch.Generator().manual_seed(DROP_SEED)
    toks = torch.randint(0, cfg.vocab, (B, T + 1), generator=gen)
    batch = {"tokens": toks[:, :-1].contiguous(),
             "labels": toks[:, 1:].contiguous()}
    with implicit_replication():
        ref = init_params(cfg, seed=DROP_SEED, device="cpu")
        shapes = dict(ref.named_parameters())
        specs = sanitize(lm_param_specs(shapes), shapes, mesh_shape(mesh))
        shd = init_params(cfg, seed=DROP_SEED, device="cpu")
        _distribute(shd, specs, mesh, serving=False)
        dbatch = {k: distribute_tensor(v, mesh, placements(("data", None),
                                                           mesh))
                  for k, v in batch.items()}
        # the layer alone, on the embedded tokens
        x = ref.embed.detach()[batch["tokens"]]
        moe0, moe1 = ref.layers[0].ffn, shd.layers[0].ffn
        side[0] = "want"
        y0, a0 = moe0(x)
        side[0] = "got"
        y1, a1 = moe1(distribute_tensor(x, mesh, placements(
            ("data", None, None), mesh)), ctx)
        put("layer|out", y0, y1)
        put("layer|aux", a0, a1)
        # training: the loss and every gradient
        side[0] = "want"
        loss0, m0 = loss_fn(ref, batch)
        loss0.backward()
        side[0] = "got"
        loss1, m1 = loss_fn(shd, dbatch, ctx=ctx)
        loss1.backward()
        put("train|ce", m0["ce"], m1["ce"])
        put("train|aux", m0["aux"], m1["aux"])
        for (name, p0), (_, p1) in zip(ref.named_parameters(),
                                       shd.named_parameters()):
            put(f"grad|{name}", p0.grad, p1.grad)
    MoE.dispatch = orig
    everyone = [None] * dist.get_world_size()
    dist.all_gather_object(everyone, (mesh.get_coordinate(), drops["got"]))
    got = [sum(d[i] for c, d in everyone if c[1] == 0)
           for i in range(len(drops["got"]))]
    out["drops|want"] = np.asarray(drops["want"])
    out["drops|got"] = np.asarray(got)
    if dist.get_rank() == 0:
        np.savez(path, **out)


@pytest.mark.parametrize("ms", DROP_MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_granite_moe_with_drops_on_a_mesh_equals_no_mesh(tmp_path, ms):
    """At the config's capacity factor, granite's MoE layer (out, aux)
    and its training (ce, aux, every gradient) on the mesh equal no mesh
    within TOL (the losses LOSS_RTOL): the sharded dispatch takes the
    whole batch's capacity and slots. Each layer drops at least one
    assignment on each side, as many on the mesh as without it."""
    path = str(tmp_path / "drops.npz")
    proc = _start(f"""
        import test_torch_mesh_values as t
        from repro_torch.launch.enumerate import run_on_ranks
        run_on_ranks({ms[0] * ms[1]}, "cpu", t._drops_rank, {path!r},
                     {tuple(ms)!r})
    """, {"OMP_NUM_THREADS": "1"})
    _finish(proc, DROP_TIMEOUT_S)
    with np.load(path) as z:
        res = {k: z[k] for k in z.files}
    want, got = res.pop("drops|want"), res.pop("drops|got")
    assert len(want) == 3, want      # the layer, then each of 2 layers
    assert (want > 0).all(), want
    np.testing.assert_array_equal(got, want)
    for key in ("layer|aux", "train|ce", "train|aux"):
        np.testing.assert_allclose(res[f"{key}|got"], res[f"{key}|want"],
                                   rtol=LOSS_RTOL, err_msg=key)
    _close(_pairs(res, "layer|out"), TOL)
    _close(_pairs(res, "grad|"), TOL)
