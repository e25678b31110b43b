"""The port's dry-run against the JAX package's on sharded meshes.

``tests/test_torch_dryrun.py`` holds the smoke cells' per-device flops to
the reference's on a (1, 1) mesh. Here the same cells run on meshes of
four devices, (data, model) = (2, 2), (1, 4) and (4, 1): the reference
in one subprocess with ``XLA_FLAGS=--xla_force_host_platform_device_count=4``
(the suite's in-process jax holds one device), each cell built as
``test_torch_dryrun._reference_flops`` builds it on a ``Mesh`` of that
shape and counted by ``hlo_analysis.analyze`` of its compiled HLO; the
port in process, ``analyze_cell(..., device="cpu", mesh_shape=...)``.

Flops: tolerance 0. The gaps allowed are computed here, each from its
formula:

* BST: the backward of its MLP's last layer (width 1) is a matmul with a
  contraction of size 1, which XLA rewrites as a multiply and the HLO
  count leaves out: 2 x the local batch x the last hidden width.
* granite (MoE), neither of them on the production meshes:
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
      and runs every expert on ``F / tp``: nine expert products a layer
      and microbatch (gate, up and down, each with two in the backward),
      each ``2 x experts x capacity(N) x D x F`` over what the layout
      splits.
  The capacity is the reference's on every mesh: the sharded MoE takes
  the whole microbatch's ``capacity(N)`` and slots (padding rows take
  none), so the (4, 1) mesh, whose data ranks do not divide the batch,
  has no gap.

Collective wire bytes a device (``collectives_wire`` summed, against
the reference's ``coll_wire_bytes`` from the same compile): tolerance 1
byte after the causes below, each a formula in ``wire_causes`` (bytes a
step, the port's less the reference's), named by whose choice it is. The
sizes on the production meshes are ``tools/wire_gaps.py``'s for
qwen2-0.5b and granite ``train_4k`` (16 x 16, then 2 x 16 x 16 taken as a
data axis of 32); "not known" where the cause was read from XLA's
partition of a smoke mesh. The port's own layouts that XLA's differ from
were repaired where the port moved more for nothing (BST's history and
bag looked up and summed twice, the tower's input gradient summed per
part, the LM cross entropy's logit-sized backward gathers, the expert
weights gathered whole over "model", two all-reduces of the expert
hidden gradient, the GNN's shares of every gradient, BENU's shuffled
dead columns, the MoE outputs gathered whole over both axes), and the
step's metrics are reduced, as the reference's
outputs are; those that stay:

* XLA's, kept as formulas:
    - FSDP gradients all-reduced, where the port reduce-scatters them:
      -1.68e8 / -1.73e8 B (qwen2), -9.44e7 / -9.75e7 B (granite);
    - FSDP weights gathered again in the backward (the head's embedding
      too where its vocab is split over "model"): -2.32e8 / -2.39e8 B,
      -6.61e8 / -6.83e8 B;
    - each product's partial input gradient all-reduced apart (q, k, v;
      gate and up), where the port sums them first: -1.59e10 / -7.93e9
      B, -2.42e10 / -1.21e10 B;
    - the global norm's square sums all-reduced per stacked leaf, where
      the port reduces one sum per mesh axis: about -100 B;
    - the logits relaid over the sequence for a batch the data ranks do
      not divide (the (4, 1) smoke cells only: the production batches
      divide);
    - BST's ``mlp.w1`` and ``mlp.b0`` updated on their model blocks, the
      new parameter and both moments gathered: -2.46e5 / -1.23e5 B at
      ``train_batch``, and its norm per leaf;
    - PNA: each gather's gradient all-reduced apart: -6.47e6 / -6.49e6 B
      at ``full_graph_sm``.
* The reference's own program: a GNN's segments carry a pad row, -5.1e3
  (gin-tu) and -1.9e4 B (pna) at ``full_graph_sm``.
* The port's own, staying:
    - the embedding lookup gathers the table's FSDP blocks (and sums the
      vocab-parallel rows over "model"), where the reference gathers the
      token ids, looks up every token on its block of D and all-to-alls
      the rows back: it moves less at the production training cells
      (-1.49e9 / -7.36e8 B, -2.62e9 / -1.33e9 B) and more at
      ``decode_32k`` (+1.59e7 / +1.65e7 B, qwen2), so it stays for
      training; a decode-side lookup is ROADMAP §C's.
* Both programs' own layouts, the sizes not known on the production
  meshes (XLA's partition there was not compiled):
    - heads the model axis does not divide (qwen2's 7 over 2 and 4, its
      14 and granite's 24 over 16): the port gathers q, k, v and the
      padded heads' output whole, XLA moves head slices;
    - KV heads it does not divide (granite's 2 over 4);
    - the MoE layer: the port's global-capacity slots reduce-scattered
      over dp, its combine where the slots are (token rows sent back by
      all-to-all) and its expert weights' F blocks moved over "model",
      against XLA's partition of the sort-based dispatch (per mesh);
    - the decode step's heads (qwen2 at (2, 2)).

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
import math

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
    tot = hlo_analysis.analyze(cell.lower().compile().as_text())
    out[f"{arch}:{shape}:{ms[0]}x{ms[1]}"] = {
        "flops": tot.flops, "wire": tot.coll_wire_bytes}
print(json.dumps(out))
"""


def _key(arch, shape, ms) -> str:
    return f"{arch}:{shape}:{ms[0]}x{ms[1]}"


@pytest.fixture(scope="module")
def reference():
    """The reference's per-device flops and collective wire bytes by kind
    of every cell, ``{"flops", "wire"}``, from one compile of each in one
    subprocess on four forced host devices; started once, read when first
    needed."""
    proc = _start("import sys; sys.argv[1:] = [" + repr(json.dumps(
        [[a, s, list(m)] for a, s, m in CELLS])) + "]\n" + _REFERENCE, {
        "XLA_FLAGS": "--xla_force_host_platform_device_count=4",
        "JAX_PLATFORMS": "cpu"})
    got = {}

    def cell(key):
        if not got:
            got.update(json.loads(_finish(proc, REF_TIMEOUT_S)
                                  .strip().splitlines()[-1]))
        return got[key]
    yield cell
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


def _gap(arch: str, shape: str, ms, rep) -> int:
    """The port's flops less the reference's that the module's docstring
    allows: 0 but for BST's size-1 contraction and granite's two
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
    if dp == 1 and E % tp:                       # every expert on F / tp
        cap = capacity(n_tok, cfg.top_k, E, cfg.capacity_factor)
        gap += 9 * L * mb * 2 * cap * D * (e_loc * F - E * (F // tp))
    return gap


@pytest.mark.parametrize("arch,shape,ms", CELLS,
                         ids=[_key(*c) for c in CELLS])
def test_sharded_cell_flops_match_the_reference(reference, arch, shape, ms):
    """Per-device flops of the smoke cell on a 4-device mesh equal the
    reference's compiled cell's, less the module docstring's gaps
    (tolerance 0)."""
    rep = analyze_cell(arch, shape, device="cpu", mesh_shape=ms,
                       spec=get_config(arch).smoke())
    got = rep["cost_analysis"]["flops_per_chip"]
    want = reference(_key(arch, shape, ms))["flops"]
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


# --------------------------------------------------------------------------
# Collective wire bytes against the reference's
# --------------------------------------------------------------------------
#
# Each function returns ``{cause: port wire - reference wire}`` in bytes a
# device and step, one entry per cause of the module docstring, keyed by
# whose choice it is ("XLA", "port" or "reference" for the reference's own
# program); ``tools/wire_gaps.py`` evaluates them at the production meshes.
# A cause read from XLA's compiled partition of one smoke mesh is NaN on
# another: its size there is not known.

NOT_READ = float("nan")


def _ar(nbytes: float, g: int) -> float:
    """Ring wire of an all-reduce of ``nbytes`` over ``g`` ranks."""
    return 2.0 * nbytes * (g - 1) / g


def _ag(nbytes: float, g: int) -> float:
    """Ring wire of an all-gather (or all-to-all) of ``nbytes`` out."""
    return nbytes * (g - 1) / g


def _isz(dtype) -> int:
    return torch.finfo(dtype).bits // 8


def _gnn_causes(spec, shape: str, ms) -> dict:
    """The (world, 1) grid against the reference's GSPMD program, node
    state whole on every rank on both sides."""
    cfg = spec.model_cfg_for(shape)
    g, isz = ms[0] * ms[1], _isz(cfg.dtype)
    n, d, L = spec.shapes[shape].dims["n_nodes"], cfg.d_hidden, cfg.n_layers
    # per layer: sums and extrema all-reduced forward, the extrema's tie
    # counts (port: backward; reference: forward, in jax's JVP of
    # segment_max), the nodes' gradient from the edges (port: one
    # all-reduce where the edges read the nodes; XLA: one per gather)
    if cfg.kind not in ("gin", "pna"):
        return {"XLA: the GNN's partition": NOT_READ}
    n_sum, n_gather, n_ext = {"gin": (1, 1, 0), "pna": (2, 2, 2)}[cfg.kind]
    row = _ar(isz * d, g)
    return {"reference: segments with a pad row":
            -L * (n_sum + 2 * n_ext + n_gather) * row
            - (cfg.kind == "pna") * _ar(isz, g),           # the in-degree
            "XLA: each gather's gradient all-reduced apart":
            -L * (n_gather - 1) * n * row}


def _bst_causes(spec, ms) -> dict:
    """BST on a model axis: XLA updates the tower's replicated mlp.w1
    and mlp.b0 on their model-split blocks, and reduces the global norm
    per leaf."""
    dp, tp = ms
    cfg = spec.model_cfg
    isz = _isz(cfg.dtype)
    h0, h1 = cfg.mlp_sizes[:2]
    if tp == 1:
        return {}
    # the port gathers the gradient's blocks over tp and all-reduces it
    # whole over dp; XLA all-reduces the block over dp and gathers the new
    # parameter and both moments over tp
    upd = sum((_ag(full, tp) + _ar(full, dp))
              - (_ar(full / tp, dp) + 3 * _ag(full, tp))
              for full in (isz * h0 * h1, isz * h0))
    # the norm: one scalar over tp (port); one per leaf split over it (the
    # tables, mlp.w0, and the two blocks above)
    return {"XLA: mlp.w1 and mlp.b0 updated on model blocks": upd,
            "XLA: the global norm reduced per leaf": (1 - 5) * _ar(4, tp)}


def _lm_params(spec, ms):
    """``[(name, global shape, spec, itemsize)]`` of the port's LM
    parameters as the dry-run lays them out on the mesh ``ms`` (drawn on
    fake tensors: nothing is allocated)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.launch.shardings import lm_param_specs, sanitize
    from repro_torch.models.transformer import init_params
    with FakeTensorMode():
        model = init_params(spec.model_cfg, device="cpu")
        shapes = dict(model.named_parameters())
        specs = sanitize(lm_param_specs(shapes), shapes,
                         {"data": ms[0], "model": ms[1]})
        return [(k, tuple(v.shape), specs[k], v.element_size())
                for k, v in shapes.items()]


def _axes(spec) -> set:
    out = set()
    for a in spec:
        out |= set(a) if isinstance(a, tuple) else {a} if a else set()
    return out


def _tp_bytes(shape, spec, isz, tp) -> float:
    """Bytes of a parameter's block over the model axis alone."""
    return math.prod(shape) * isz / (tp if "model" in _axes(spec) else 1)


def _moe_causes(cfg, ms, N: int, n: int) -> dict:
    """One MoE layer, a microbatch of ``N`` real tokens (``n`` rows a
    rank): the port's collectives (a formula of its design) less XLA's
    partition of the sort-based dispatch (read from its compiled HLO on
    each smoke mesh)."""
    dp, tp = ms
    E, k, D, F = cfg.n_experts, cfg.top_k, cfg.d_model, cfg.moe_d_ff
    isz = _isz(cfg.dtype)
    cap = capacity(N, k, E, cfg.capacity_factor)
    e_loc = -(-E // tp)
    slots = e_loc * cap
    # the port: counts (int64) and the probabilities' sums over dp; the
    # router gathered over dp and its gradient reduce-scattered; the
    # slots reduce-scattered into D blocks over dp (gathered back in the
    # backward), gate and up all-reduced, dh all-reduced once; the
    # combine where the slots are: every rank's rows (int64) and gates
    # gathered over dp (the gates' gradient reduce-scattered back and
    # summed over tp), each token's f32 blocks of D sent to its dp rank
    # (and back) and summed over tp; the tokens' gradient summed over
    # tp; the experts' F blocks moved by all-to-all where tp does not
    # divide E (forward and backward)
    port = _ag(dp * E * 8, dp) + _ar(E * 4, dp) + 2 * _ag(D * E * 4, dp) \
        + 2 * _ag(slots * D * isz, dp) + 3 * _ar(slots * F * isz, dp) \
        + _ag(dp * n * k * 8, dp) + 2 * _ag(dp * n * k * 4, dp) \
        + _ar(n * k * 4, tp) + 2 * _ag(n * D * 4, dp) + _ar(n * D * 4, tp) \
        + _ar(n * D * isz, tp)
    if E % tp:
        port += 6 * _ag(e_loc * D // dp * F * isz, tp)
    if ms == (1, 4):
        # XLA runs every expert on its F block: it gathers the slots over
        # tp (forward and backward), all-reduces the down product and the
        # slots' two gradients, the tokens' gradient (with the pad row)
        # and gathers the slot table twice
        ref = 2 * _ag(e_loc * tp * cap * D * isz, tp) \
            + 3 * _ar(E * cap * D * isz, tp) + _ar((n + 1) * D * isz, tp) \
            + 2 * _ag(e_loc * tp * cap * 4, tp)
    elif ms == (2, 2):
        # XLA: gate and up all-reduced over dp with the gates and both aux
        # sums; the slots all-reduced (not reduce-scattered) over dp and
        # their gradient gathered; the expert weights moved by windowed
        # all-to-alls (three forward, three backward) and their gradients
        # gathered; the hidden state gathered over tp; dh and the slot
        # gates' gradient all-reduced; the gates' and tokens' gradients
        # (with the pad row) all-reduced over tp; the router on token
        # blocks (logits, gradient and its transposes); the tokens and
        # their gradients relaid over dp; the sort's ids and keys
        w = e_loc * D // dp * F * isz
        ref = _ar(2 * slots * F * isz + N * k * 4 + 2 * E * 4, dp) \
            + _ar(slots * D * isz, dp) + _ag(slots * D * isz, dp) \
            + 3 * _ag(e_loc * tp * D // dp * F * isz, dp) \
            + 3 * _ag(2 * w, tp) \
            + _ag(e_loc * tp * cap * F * isz, tp) \
            + _ar(slots * 4 + slots * F * isz, dp) \
            + _ar(N * k * 4 + (n + 1) * D * isz, tp) \
            + 2 * _ag(2 * (n + 1) * D // dp * isz, dp) \
            + 2 * _ag(2 * n * D // dp * isz, dp) \
            + 3 * D // dp * E * 4 + _ag(D * E * 4, tp) + _ar(n * E * 4, dp) \
            + _ag(N * E * 4, dp) + _ar(D // dp * E * isz, tp) \
            + 2 * _ar(N * k * 4, dp) + 2 * N * k * 4 \
            + 2 * _ag(e_loc * tp * cap * 4, dp) + _ag(N * k * 4, dp) \
            + _ag(2 * D // dp * isz, dp) / 2
    elif ms == (4, 1):
        # XLA, the batch's two rows on two of the four data ranks: gate,
        # up and dh all-reduced over dp; the slots, gates and aux sums
        # all-reduced over the pairs, their gradient gathered; the tokens
        # gathered whole; x relaid over the pairs (collective-permutes and
        # all-reduces, forward and backward) and its blocks moved by
        # all-to-alls; the router gathered twice, its gradient reduced
        # over the pairs; the slot gates' gradient all-reduced; the sort's
        # ids, keys and probabilities over the pairs
        h = D // 2
        ref = 3 * _ar(slots * F * isz, dp) \
            + _ar(slots * D * isz + N * k * 4 + 2 * E * 4, 2) \
            + _ag(slots * D * isz, dp) + _ag(N * D * isz, dp) \
            + 4 * n * D * isz + 2 * _ar(n * D * isz, 2) \
            + _ag(2 * (n + 1) * h * isz, 2) + _ag(2 * n * h * isz, 2) \
            + N * D // dp * isz + _ag(2 * n * D // dp * isz, 2) \
            + _ar(D * E * isz, 2) + 2 * _ag(D * E * isz, dp) \
            + _ag(N * E * 4, 2) + _ar(N * k * 4, 2) + N * k * 4 \
            + _ag(N * k * 4, 2) + _ar(slots * 4, dp) + _ag(2 * h * isz, 2) / 2
    else:
        ref = NOT_READ
    return {"port and XLA: the MoE layer's layouts": port - ref}


def _lm_causes(spec, shape: str, ms, mb: int) -> dict:
    """An LM training cell of ``mb`` microbatches."""
    cfg, dims = spec.model_cfg, spec.shapes[shape].dims
    dp, tp = ms
    L, V = cfg.n_layers, cfg.vocab
    B, T, D = dims["batch"], dims["seq"], cfg.d_model
    bp = -(-B // dp) * dp                  # the batch padded over dp
    b = bp // dp // mb                     # a rank's rows a microbatch
    isz = _isz(cfg.dtype)
    params = _lm_params(spec, ms)
    out = {}
    # XLA all-reduces each FSDP gradient where the port reduce-scatters
    # it (the tied embedding: the port's two reduce-scatters, of the
    # lookup's and the head's gradients, move one all-reduce's wire), and
    # gathers each FSDP weight again in the backward (the head's
    # embedding too, where its vocab is split over "model"). The MoE
    # layer's parameters are the MoE entry's
    dense = [(shp, sp, i) for name, shp, sp, i in params
             if name != "embed" and "data" in _axes(sp)
             and (".ffn." not in name or len(shp) == 2 and not cfg.moe)]
    fsdp = sum(mb * _ag(_tp_bytes(shp, sp, i, tp), dp)
               for shp, sp, i in dense)
    out["XLA: FSDP gradients all-reduced"] = -fsdp
    out["XLA: FSDP weights gathered again backward"] = -sum(
        mb * _ag(_tp_bytes(shp, sp, i, tp), dp)
        for shp, sp, i in dense if len(shp) == 2)
    if tp > 1:
        emb = next(p for p in params if p[0] == "embed")
        out["XLA: FSDP weights gathered again backward"] -= \
            mb * _ag(_tp_bytes(*emb[1:3], emb[3], tp), dp)
    # XLA all-reduces each product's partial input gradient apart (q, k,
    # v; gate and up of a dense block) where the port sums them first
    # (one per attention and one per dense FFN)
    n_moe = L - cfg.first_dense_layers if cfg.moe else 0
    out["XLA: each product's input gradient all-reduced apart"] = \
        -mb * (3 * (L - n_moe) + 2 * n_moe) * _ar(b * T * D * isz, tp)
    # the heads, where the model axis does not divide them: the port
    # gathers q, k, v and the padded heads' output forward, and the
    # output's gradient, reduce-scatters dq, dk, dv backward; XLA
    # gathers k and v, all-reduces dk and dv, and moves head slices.
    # Where it divides the heads but not the KV heads: the port gathers
    # k and v (reduce-scatters their gradients); XLA gathers them over
    # the pairs of ranks that share a KV head, all-reduces dk and dv
    # there, and moves head slices
    H, KV, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    u = b * T * dh * isz
    if H % tp:
        port = (3 * H + 4 * KV + -(-H // tp) * tp) * _ag(u, tp)
        ref = 2 * _ag(KV * u, tp) + 2 * _ar(KV * u, tp) + \
            {2: 10, 4: 5}.get(tp, NOT_READ) * u
        out["port and XLA: heads the model axis does not divide"] = \
            mb * L * (port - ref)
    elif KV % tp:
        g = tp // KV
        port = 4 * _ag(KV * u, tp)
        ref = 2 * _ag(u, g) + 2 * _ar(u, g) + {4: 2}.get(tp, NOT_READ) * u
        out["port and XLA: KV heads the model axis does not divide"] = \
            mb * L * (port - ref)
    if n_moe:
        moe = _moe_causes(cfg, ms, B * T // mb, b * T)
        out.update({k: mb * n_moe * v for k, v in moe.items()})
    # the embedding lookup: the port gathers the table's FSDP blocks and
    # all-reduces the vocab-parallel rows over "model"; the reference
    # gathers the token ids, looks up every token on its block of D
    # (all-reduced over "model", the ids relaid once), and all-to-alls the
    # rows to their data rank, forward and backward
    port = _ag(V * D * isz / tp, dp) + _ar(b * T * D * isz, tp)
    if dp == 1:
        ref = _ar(b * T * D * isz, tp)
    else:
        rows = bp * T * D // dp * isz
        ref = _ag(B * T * 4, dp) + 2 * _ag(rows, dp)
        if tp > 1:
            ref += _ar(rows, tp) + b * T * 4
    out["port: the lookup gathers the table"] = mb * (port - ref)
    # the cross entropy, where the data ranks do not divide the batch:
    # XLA lays the logits out over the sequence (forward, and twice
    # backward) with three per-token vectors
    if B % dp:
        n = bp * T // dp
        out["XLA: the logits relaid for a padded batch"] = -(
            3 * _ag(n * V * isz, dp) + 2 * _ag(n * 4, dp) + _ag(n, dp))
    # the global norm: the port all-reduces one square sum over each mesh
    # axis; XLA one per stacked leaf split over it
    leaves = {}
    for name, shp, sp, i in params:
        key = name.split(".", 2)[-1] if name.startswith("layers.") else name
        leaves[key] = _axes(sp)
    norm = 0.0
    for axis, g in (("data", dp), ("model", tp)):
        n_split = sum(axis in ax for ax in leaves.values())
        if g > 1 and n_split:
            norm -= (n_split - 1) * _ar(4, g)
    out["XLA: the global norm reduced per leaf"] = norm
    return out


def _decode_causes(spec, shape: str, ms) -> dict:
    """An LM decode cell (one new token a row, the cache's sequence over
    "model")."""
    cfg, dims = spec.model_cfg, spec.shapes[shape].dims
    dp, tp = ms
    B, D, V = dims["batch"], cfg.d_model, cfg.vocab
    b = B // dp
    isz = _isz(cfg.dtype)
    # the lookup, as in training without its backward
    rows = B * D // dp * isz
    out = {"port: the lookup gathers the table":
           _ag(V * D * isz / tp, dp) + _ar(b * D * isz, tp)
           - (_ag(B * 4, dp) + _ag(rows, dp) + _ar(rows, tp) + b * 4)}
    # the port gathers q and the new k and v over "model"; XLA gathers
    # the padded heads' q and the heads' output, the new K/V entry in
    # halves and into its cache slot, and moves quarter head slices
    H, KV, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    u = b * dh * isz
    if H % tp:
        port = _ag(H * u, tp) + 2 * _ag(KV * u, tp)
        ref = _ag(-(-H // tp) * tp * u, tp) + _ag(H * u, tp) \
            + 2 * _ag(KV * u / 2, tp) + _ag(KV * u, tp) \
            + (u / 2 if tp == 2 else NOT_READ)
        out["port and XLA: heads the model axis does not divide"] = \
            cfg.n_layers * (port - ref)
    return out


def wire_causes(spec, shape: str, ms, mb: int = 1) -> dict:
    """``{cause: port - reference wire bytes}`` of the cell (``spec``'s
    family) on the (data, model) mesh ``ms``; ``mb`` the microbatches of
    an LM training cell."""
    kind = spec.shapes[shape].kind
    if spec.family == "gnn":
        return _gnn_causes(spec, shape, ms)
    if spec.family == "recsys":
        return _bst_causes(spec, ms)
    if kind == "lm_train":
        return _lm_causes(spec, shape, ms, mb)
    if kind == "lm_decode":
        return _decode_causes(spec, shape, ms)
    return {}


def _by_kind(wire) -> str:
    return ", ".join(f"{k} {v:.0f}" for k, v in wire.items() if v)


@pytest.mark.parametrize("arch,shape,ms", CELLS,
                         ids=[_key(*c) for c in CELLS])
def test_sharded_cell_wire_matches_the_reference(reference, arch, shape,
                                                 ms):
    """Per-device collective wire bytes (``collectives_wire`` summed) of
    the smoke cell on a 4-device mesh equal the reference's compiled
    cell's (``coll_wire_bytes`` summed; both the ring model of
    ``op_analysis.collective_bytes``), less the module docstring's gaps,
    within 1 byte. Totals, not kinds: a reduce-scatter and an all-gather
    move the ring wire of one all-reduce."""
    spec = get_config(arch).smoke()
    rep = analyze_cell(arch, shape, device="cpu", mesh_shape=ms, spec=spec)
    got = rep["collectives_wire"]
    want = reference(_key(arch, shape, ms))["wire"]
    causes = wire_causes(spec, shape, ms, rep["meta"].get("microbatches", 1))
    diff = sum(got.values()) - sum(want.values())
    assert abs(diff - sum(causes.values())) <= 1, (
        f"port - reference {diff:.0f}, allowed {causes}; port: "
        f"{_by_kind(got)}; reference: {_by_kind(want)}")
