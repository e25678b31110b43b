"""The port's dry-run against the JAX package's on sharded meshes.

``tests/test_torch_dryrun.py`` holds the smoke cells' per-device flops to
the reference's on a (1, 1) mesh. Here the same cells run on meshes of
four devices, (data, model) = (2, 2), (1, 4) and (4, 1): the reference
in one subprocess with ``XLA_FLAGS=--xla_force_host_platform_device_count=4``
(the suite's in-process jax holds one device), each cell built as
``test_torch_dryrun._reference_flops`` builds it on a ``Mesh`` of that
shape and counted by ``hlo_analysis.analyze`` of its compiled HLO; the
port in process, ``analyze_cell(..., device="cpu", mesh_shape=...)``.

Tolerance 0. The gaps allowed are computed here, each from its formula:

* BST: the backward of its MLP's last layer (width 1) is a matmul with a
  contraction of size 1, which XLA rewrites as a multiply and the HLO
  count leaves out: 2 x the local batch x the last hidden width.
* granite (MoE), none of them on the production meshes:
    - the router, when both the data and the model axes exceed 1, laid
      out by XLA's partitioner: it contracts the router's forward and
      weight gradient over ``D / dp`` on a block of ``N / tp`` of the
      microbatch's ``N`` tokens, where the port gathers the router and
      contracts all of ``D`` on its ``n_loc`` rows;
    - the experts, when one data rank holds the batch and the model axis
      does not divide the expert count, the port's own layout: it runs
      ``ceil(E / tp)`` experts whole (the reference's constraint, experts
      over "model", padded as GSPMD pads it where dp > 1), where XLA
      keeps the expert weights as stored (the FFN width over "model")
      and runs every expert on ``F / tp``;
    - the capacity, when the data ranks do not divide the batch, the
      port's own dispatch (GShard's local one on padded rows): each rank
      routes its (padded) rows at their local capacity, ``dp x
      capacity(n_loc)`` slots an expert against the reference's
      ``capacity(N)``.
  Nine expert products a layer and microbatch (gate, up and down, each
  with two in the backward), each ``2 x experts x slots x D x F`` over
  what the layout splits.

Also here: ``cut_depth`` (the CLI's ``--layers``); the qwen2 smoke
cell's attention gathers; the granite ``train_4k`` cell traced at one
layer over the fake 16 x 16 world, with its tied head on local shards
and no Shard -> Partial redistribution asked of DTensor (the card's torch
raised on one), and BST's training step on a (2, 2) mesh of 4 gloo
ranks against no mesh (its encoder and MLP tower on local blocks).
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.launch.dryrun import analyze_cell, cut_depth
from repro_torch.launch.dryrun import main as dryrun_main
from repro_torch.layers.moe import capacity
from test_torch_dist import _finish, _start

SMOKE_CELLS = [("qwen2-0.5b", "train"), ("qwen2-0.5b", "decode"),
               ("granite-moe-3b-a800m", "train"), ("gin-tu", "full"),
               ("gin-tu", "mol"), ("pna", "full"), ("bst", "train"),
               ("benu", "enum_128m")]
TRAIN_CELLS = [("qwen2-0.5b", "train"), ("granite-moe-3b-a800m", "train"),
               ("bst", "train")]
CELLS = [(a, s, (2, 2)) for a, s in SMOKE_CELLS] + \
    [(a, s, m) for m in ((1, 4), (4, 1)) for a, s in TRAIN_CELLS]
REF_TIMEOUT_S = 300

_REFERENCE = """
import json, sys
import jax
import numpy as np
from jax.sharding import Mesh
from repro.configs import get_config
from repro.launch import hlo_analysis, steps
assert len(jax.devices()) == 4, jax.devices()
out = {}
for arch, shape, ms in json.loads(sys.argv[1]):
    spec = get_config(arch).smoke()
    mesh = Mesh(np.array(jax.devices()[:ms[0] * ms[1]]).reshape(*ms),
                ("data", "model"))
    build = {"lm": steps._lm_cell, "gnn": steps._gnn_cell,
             "recsys": steps._rec_cell, "benu": steps._benu_cell}
    cell = build[spec.family](spec, shape, mesh, False)
    out[f"{arch}:{shape}:{ms[0]}x{ms[1]}"] = hlo_analysis.analyze(
        cell.lower().compile().as_text()).flops
print(json.dumps(out))
"""


def _key(arch, shape, ms) -> str:
    return f"{arch}:{shape}:{ms[0]}x{ms[1]}"


@pytest.fixture(scope="module")
def reference():
    """The reference's flops of every cell, from one subprocess on four
    forced host devices; started once, read when first needed."""
    proc = _start("import sys; sys.argv[1:] = [" + repr(json.dumps(
        [[a, s, list(m)] for a, s, m in CELLS])) + "]\n" + _REFERENCE, {
        "XLA_FLAGS": "--xla_force_host_platform_device_count=4",
        "JAX_PLATFORMS": "cpu"})
    got = {}

    def flops(key):
        if not got:
            got.update(json.loads(_finish(proc, REF_TIMEOUT_S)
                                  .strip().splitlines()[-1]))
        return got[key]
    yield flops
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


def _gap(arch: str, shape: str, ms, rep) -> int:
    """The port's flops less the reference's that the module's docstring
    allows: 0 but for BST's size-1 contraction and granite's three
    layouts."""
    if arch not in ("bst", "granite-moe-3b-a800m"):
        return 0
    spec = get_config(arch).smoke()
    dp, tp = ms
    dims = spec.shapes[shape].dims
    cfg = spec.model_cfg
    b_loc = -(-dims["batch"] // dp)
    if arch == "bst":
        return 2 * b_loc * cfg.mlp_sizes[-1]
    L, mb = cfg.n_layers, rep["meta"]["microbatches"]
    E, D, F = cfg.n_experts, cfg.d_model, cfg.moe_d_ff
    T = dims["seq"]
    n_tok = dims["batch"] * T // mb              # the reference's N
    n_loc = b_loc * T // mb                      # a rank's rows
    e_loc = -(-E // tp)
    gap = 0
    if dp > 1 and tp > 1:                        # the router
        gap += 2 * L * mb * 2 * E * (n_loc * D - (n_tok // tp) * (D // dp))
    cap = capacity(n_tok, cfg.top_k, E, cfg.capacity_factor)
    slots = dp * capacity(n_loc, cfg.top_k, E, cfg.capacity_factor)
    port = 2 * e_loc * slots * (D // dp) * F
    if dp == 1 and E % tp:                       # every expert on F / tp
        ref = 2 * E * cap * D * (F // tp)
    else:
        ref = 2 * e_loc * cap * (D // dp) * F
    return gap + 9 * L * mb * (port - ref)


@pytest.mark.parametrize("arch,shape,ms", CELLS,
                         ids=[_key(*c) for c in CELLS])
def test_sharded_cell_flops_match_the_reference(reference, arch, shape, ms):
    """Per-device flops of the smoke cell on a 4-device mesh equal the
    reference's compiled cell's, less the module docstring's gaps
    (tolerance 0)."""
    rep = analyze_cell(arch, shape, device="cpu", mesh_shape=ms,
                       spec=get_config(arch).smoke())
    got = rep["cost_analysis"]["flops_per_chip"]
    want = reference(_key(arch, shape, ms))
    assert got - want == _gap(arch, shape, ms, rep), (got, want)
    if arch == "benu":
        assert got == 0


def test_qwen2_attention_gathers_each_activation_once(monkeypatch):
    """qwen2's smoke train cell at (2, 2), whose 7 heads the 2 model
    ranks do not divide: per layer the forward all-gathers q, k, v and
    the padded heads' output once each over "model", and the backward the
    output's gradient once (the width of q, as ``dv == d_head``). No other
    activation of the cell is gathered but the vocab-parallel logits: the
    rows' offset and the output's layout are read from metadata, not
    from a gathered copy of q."""
    import collections
    import repro_torch.launch.op_analysis as oa
    seen = collections.Counter()
    orig = oa.OpCounter.__torch_dispatch__

    def counted(self, func, types, args=(), kwargs=None):
        if func.__name__.split(".")[0] == "all_gather_into_tensor" and \
                args[0].ndim == 3:
            seen[tuple(args[0].shape)] += 1
        return orig(self, func, types, args, kwargs)
    monkeypatch.setattr(oa.OpCounter, "__torch_dispatch__", counted)
    spec = get_config("qwen2-0.5b").smoke()
    rep = analyze_cell("qwen2-0.5b", "train", device="cpu",
                       mesh_shape=(2, 2), spec=spec)
    cfg, dims = spec.model_cfg, spec.shapes["train"].dims
    assert rep["meta"]["microbatches"] == 1 and not cfg.remat
    tp, h, dh, L = 2, cfg.n_heads, cfg.d_head, cfg.n_layers
    assert h % tp and cfg.n_kv_heads % tp
    rows = (dims["batch"] // 2, dims["seq"])
    want = collections.Counter({
        rows + (h * dh // tp,): 2 * L,                  # q; the out's grad
        rows + (cfg.n_kv_heads * dh // tp,): 2 * L,     # k and v
        rows + (-(-h // tp) * dh,): L})                 # the padded heads
    attention = {k: n for k, n in seen.items()
                 if k[-1] not in (cfg.vocab, cfg.vocab // tp)}
    assert attention == want, seen


def test_layers_cut_an_lm_cells_depth(tmp_path):
    """``cut_depth`` (the CLI's ``--layers``, which phase 14 traces
    granite's train_4k with) keeps the first N layers: the per-layer
    flops scale with N, a non-LM arch refuses it, and the CLI writes the
    cut depth into the cell's report."""
    spec = get_config("qwen2-0.5b").smoke()
    reps = {n: analyze_cell("qwen2-0.5b", "train", device="cpu",
                            mesh_shape=(2, 2), spec=cut_depth(spec, n))
            for n in (1, 2)}
    assert reps[2]["cost_analysis"]["flops_per_chip"] == \
        analyze_cell("qwen2-0.5b", "train", device="cpu", mesh_shape=(2, 2),
                     spec=spec)["cost_analysis"]["flops_per_chip"]
    f1, f2 = (reps[n]["cost_analysis"]["flops_per_chip"] for n in (1, 2))
    head = f2 - 2 * (f2 - f1)                  # the layers' flops removed
    assert 0 < head < f1 < f2
    with pytest.raises(ValueError, match="LM"):
        cut_depth(get_config("gin-tu").smoke(), 1)
    assert dryrun_main(["--cells", "qwen2-0.5b:decode_32k", "--layers", "1",
                        "--device", "cpu", "--out", str(tmp_path)]) == 0
    rep = json.loads((tmp_path / "qwen2-0.5b__decode_32k__pod.json")
                     .read_text())
    assert rep["layers"] == 1


def test_granite_train_4k_head_on_local_shards():
    """granite's train_4k at one layer over the fake 16 x 16 world: no
    product with the (tied) embedding runs on DTensors (the head's was
    the op whose gradient reached the embedding in another layout than
    the lookup's, and the card's torch planned their sum through a
    Shard -> Partial redistribution it cannot do), every op on the
    embedding's gradient takes its operands in one layout, and no Shard
    -> Partial redistribution is asked of DTensor."""
    import sys
    import torch.distributed.tensor._redistribute as red
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import DTensor, Partial, Shard
    from torch.distributed.tensor.experimental import implicit_replication
    from torch.utils._python_dispatch import TorchDispatchMode
    from repro_torch.launch.mesh import fake_world, make_production_mesh
    from repro_torch.launch.steps import build_cell

    spec = get_config("granite-moe-3b-a800m")
    spec = dataclasses.replace(spec, model_cfg=dataclasses.replace(
        spec.model_cfg, n_layers=1))
    cfg = spec.model_cfg
    emb = {(cfg.vocab, cfg.d_model), (cfg.d_model, cfg.vocab)}
    products = {"mm", "addmm", "bmm", "matmul", "linear", "baddbmm"}
    seen, bad, s2p = [], [], []

    class Watch(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            ds = [a for a in args if isinstance(a, DTensor)
                  and tuple(a.shape) in emb]
            if ds:
                name = func.__name__.split(".")[0]
                seen.append(name)
                if name in products:
                    bad.append(f"{name} on DTensors")
                if len({tuple(d.placements) for d in ds}) > 1:
                    bad.append(f"{name}: {[d.placements for d in ds]}")
            return func(*args, **(kwargs or {}))

    orig = red.redistribute_local_tensor

    def watched(local, cur, tgt, *a, **k):
        for p, q in zip(cur.placements, tgt.placements):
            if isinstance(p, Shard) and isinstance(q, Partial):
                s2p.append((cur.placements, tgt.placements,
                            tuple(cur.shape)))
        return orig(local, cur, tgt, *a, **k)

    mods = [m for n, m in list(sys.modules.items())
            if n.startswith("torch.distributed.tensor")
            and getattr(m, "redistribute_local_tensor", None) is orig]
    for m in mods:
        m.redistribute_local_tensor = watched
    try:
        with fake_world(256):
            mesh = make_production_mesh()
            with FakeTensorMode(), implicit_replication():
                cell = build_cell("granite-moe-3b-a800m", "train_4k", mesh,
                                  spec=spec)
                with Watch():        # inside the fake mode: sees DTensors
                    _, metrics = cell.fn(*cell.args)
                assert tuple(metrics["loss"].shape) == ()
    finally:
        for m in mods:
            m.redistribute_local_tensor = orig
    assert not s2p, s2p
    assert not bad, bad
    assert "add" in seen, seen


# --------------------------------------------------------------------------
# BST on values: a (2, 2) mesh of 4 gloo ranks against no mesh
# --------------------------------------------------------------------------

BST_B = 8
TOL, LOSS_RTOL = 2e-5, 1e-5           # tests/test_torch_mesh_values.py's


def _bst_rank(path: str) -> None:
    """One rank: BST's loss and every gradient with the parameters and
    the batch laid out by ``launch/shardings.py`` on the (2, 2) mesh, the
    model under a ``ShardCtx``, and the same without a mesh; rank 0
    writes them to ``path``."""
    import torch.distributed as dist
    from torch.distributed.tensor import distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.shardings import (bst_param_specs, mesh_shape,
                                              placements, sanitize)
    from repro_torch.layers.common import ShardCtx
    from repro_torch.models.bst import bst_loss, init_bst_params
    from test_torch_mesh_values import _distribute, _whole
    torch.set_num_threads(1)
    mesh = make_mesh((2, 2), ("data", "model"), "cpu")
    ctx = ShardCtx(mesh=mesh, dp=("data",), tp="model")
    cfg = get_config("bst").smoke().model_cfg
    gen = torch.Generator().manual_seed(3)
    batch = {"hist": torch.randint(0, cfg.n_items, (BST_B, cfg.seq_len),
                                   generator=gen),
             "target": torch.randint(0, cfg.n_items, (BST_B,),
                                     generator=gen),
             "user_feats": torch.randint(0, cfg.n_user_feats,
                                         (BST_B, cfg.user_feat_len),
                                         generator=gen),
             "label": torch.randint(0, 2, (BST_B,), generator=gen)}
    ref = init_bst_params(cfg, seed=0, device="cpu")
    shapes = dict(ref.named_parameters())
    specs = sanitize(bst_param_specs(shapes), shapes, mesh_shape(mesh))
    shd = init_bst_params(cfg, seed=0, device="cpu")
    _distribute(shd, specs, mesh, serving=False)
    out = {}
    with implicit_replication():
        dbatch = {k: distribute_tensor(v, mesh, placements(
            ("data",) + (None,) * (v.ndim - 1), mesh))
            for k, v in batch.items()}
        loss0, _ = bst_loss(ref, batch)
        loss0.backward()
        loss1, _ = bst_loss(shd, dbatch, ctx=ctx)
        loss1.backward()
        out["loss|want"] = loss0.detach().double().numpy()
        out["loss|got"] = _whole(loss1).detach().double().numpy()
        for (name, p0), (_, p1) in zip(ref.named_parameters(),
                                       shd.named_parameters()):
            out[f"{name}|want"] = p0.grad.double().numpy()
            out[f"{name}|got"] = _whole(p1.grad).double().numpy()
    if dist.get_rank() == 0:
        np.savez(path, **out)


def test_bst_training_on_a_mesh_equals_no_mesh(tmp_path):
    """BST's loss (1e-5 relative) and every gradient (2e-5 x its largest
    magnitude) on the (2, 2) mesh equal those without a mesh."""
    path = str(tmp_path / "bst.npz")
    proc = _start(f"""
        import test_torch_dryrun_mesh as t
        from repro_torch.launch.enumerate import run_on_ranks
        run_on_ranks(4, "cpu", t._bst_rank, {path!r})
    """, {"OMP_NUM_THREADS": "1"})
    _finish(proc, 300)
    with np.load(path) as z:
        res = {k: z[k] for k in z.files}
    np.testing.assert_allclose(res["loss|got"], res["loss|want"],
                               rtol=LOSS_RTOL)
    names = sorted(k[:-5] for k in res if k.endswith("|want")
                   and k != "loss|want")
    assert names
    for name in names:
        want, got = res[f"{name}|want"], res[f"{name}|got"]
        assert got.shape == want.shape, name
        scale = max(float(np.abs(want).max()), 1e-30)
        assert float(np.abs(got - want).max()) <= TOL * scale, name
