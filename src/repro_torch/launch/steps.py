"""Step builders: one traced program per dry-run cell.

Counterpart of ``repro/launch/steps.py``. ``build_cell(arch, shape, mesh,
multi_pod)`` returns a :class:`CellProgram`: the step function, its
arguments and the specs they are laid out by. Call it under a
``FakeTensorMode`` over a fake world (``launch/mesh.py``): every tensor
is then a fake tensor of rank 0's shard on the mesh's device, nothing is
allocated on a card, and ``fn(*args)`` traces the program rank 0 would
run under the reference's layout for the cell:

    LM       the model's parameters, the optimizer state and the batch
             are DTensors laid out by ``launch/shardings.py``; the model
             runs with a ``ShardCtx`` over the mesh. Training accumulates
             gradients over microbatches (each microbatch takes its share
             of every rank's rows, so it still lies over every dp rank)
             and takes an AdamW step; prefill and decode run the serving
             steps, decode over caches whose sequence is sharded
             (a flash-decode combine over the sequence's ranks)
    GNN      ``models/gnn_dist.build_dist_loss`` on local tensors: the
             small cells over a ``(world, 1)`` grid (node tensors whole on
             every rank, edges over every rank), ogb_products over the
             ``(data, model)`` grid in bf16 with remat; the gradients are
             summed over the world and AdamW steps on local parameters
    recsys   BST's train, serve and retrieval steps on DTensors
             (candidates over every axis)
    benu     enum_128m: rank 0's ``build_benu_step`` over the fake world
             on its ``[rps, 128]`` shard; sbenu_delta_16m: the
             single-device Delta-P_1 step on rank 0's slice of the start
             batch, the snapshots whole
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Tuple

import torch
from torch import nn

from ..configs import get_config
from ..configs.base import ArchSpec
from ..layers.common import ShardCtx
from ..train.optimizer import AdamWConfig, AdamWState, adamw_update
from .mesh import dp_axes, flat_axes
from .shardings import (batch_specs, bst_param_specs, cache_specs,
                        fsdp2d_param_specs, gnn_param_specs,
                        lm_param_specs, local_shape, mesh_shape,
                        opt_state_specs, placements, sanitize,
                        zero1_opt_specs, zero1_param_specs)


@dataclass
class CellProgram:
    name: str
    fn: Callable
    args: Tuple[Any, ...]              # DTensors / local fake tensors
    specs: Dict[str, Any]              # the layouts, by argument
    meta: Dict[str, Any]
    #: the modules whose parameters are arguments (outside ``args``)
    modules: Tuple[nn.Module, ...] = field(default_factory=tuple)

    def arguments(self):
        """Every tensor the program starts from: ``args`` and the
        parameters of ``modules``."""
        out = tensors_of(self.args)
        for m in self.modules:
            out += [p for p in m.parameters()]
        return out


def tensors_of(obj) -> list:
    """The tensors in ``obj``: through dicts, lists, tuples (named ones
    too) and dataclasses."""
    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, dict):
        obj = list(obj.values())
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        obj = [getattr(obj, f.name) for f in dataclasses.fields(obj)]
    if isinstance(obj, (list, tuple)):
        return [t for x in obj for t in tensors_of(x)]
    return []


def _dtensor(shape, dtype, spec, mesh, device):
    """A DTensor of global ``shape`` laid out by ``spec``: rank 0's shard
    is a new (fake) tensor."""
    from torch.distributed.tensor import DTensor
    ms = mesh_shape(mesh)
    local = torch.empty(local_shape(shape, spec, ms), dtype=dtype,
                        device=device)
    stride = [math.prod(shape[i + 1:]) for i in range(len(shape))]
    return DTensor.from_local(local, mesh, placements(spec, mesh),
                              run_check=False, shape=torch.Size(shape),
                              stride=tuple(stride))


def _distribute_module(model: nn.Module, specs: Dict[str, tuple], mesh,
                       device) -> None:
    """Replace each parameter of ``model`` by a DTensor parameter laid out
    by its spec. A model that serves (no parameter requires grad) gets
    inference tensors, as the serving steps run under
    ``inference_mode``."""
    serving = not any(p.requires_grad for p in model.parameters())
    with torch.inference_mode(serving):
        _replace_parameters(model, specs, mesh, device)


def _replace_parameters(model, specs, mesh, device) -> None:
    for name, p in list(model.named_parameters()):
        owner, _, leaf = name.rpartition(".")
        mod = model.get_submodule(owner) if owner else model
        d = _dtensor(tuple(p.shape), p.dtype, specs[name], mesh, device)
        setattr(mod, leaf, nn.Parameter(d, requires_grad=p.requires_grad))


def _on_device(model: nn.Module, device) -> nn.Module:
    """``model`` with each parameter a new (fake) tensor of its shape on
    ``device``: the models are drawn on the CPU, and a fake tensor's
    values are never read."""
    for name, p in list(model.named_parameters()):
        owner, _, leaf = name.rpartition(".")
        mod = model.get_submodule(owner) if owner else model
        setattr(mod, leaf, nn.Parameter(
            torch.empty(p.shape, dtype=p.dtype, device=device),
            requires_grad=p.requires_grad))
    return model


def _inputs(ispecs, bspecs, mesh, device):
    return {k: _dtensor(tuple(v.shape), v.dtype, bspecs[k], mesh, device)
            for k, v in ispecs.items()}


def _opt_state(params, ospecs, mesh, device) -> AdamWState:
    def leaves(specs):
        return {k: _dtensor(tuple(p.shape), torch.float32, specs[k], mesh,
                            device) for k, p in params.items()}
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=device),
                      m=leaves(ospecs["m"]), v=leaves(ospecs["v"]))


def _microbatch(t, i: int, mb: int):
    """Microbatch ``i`` of ``mb`` of a batch DTensor: each rank's ``i``-th
    share of its own rows."""
    from torch.distributed.tensor import DTensor
    loc = t.to_local()
    n = loc.shape[0] // mb
    return DTensor.from_local(loc[i * n:(i + 1) * n], t.device_mesh,
                              t.placements, run_check=False)


def _whole(t: torch.Tensor) -> torch.Tensor:
    """A metric as every rank holds it: a DTensor's partial sums reduced
    (the reference's replicated outputs)."""
    if type(t).__name__ != "DTensor":
        return t
    from torch.distributed.tensor import Replicate
    return t.redistribute(t.device_mesh, [Replicate()] * t.device_mesh.ndim)


def _accumulating_step(model, loss_fn, opt_cfg, mb: int, decay,
                       report=()):
    """``step(opt_state, batch)``: gradients summed in f32 over ``mb``
    microbatches, each laid out as its parameter first (a partial sum
    reduced, as FSDP reduce-scatters), and averaged, then one AdamW step
    in place. It returns the reference's metrics, whole on every rank:
    the mean loss, the loss function's metrics named in ``report`` (the
    last microbatch's) and the optimizer's."""
    def step(opt_state, batch):
        params = dict(model.named_parameters())
        gsum: Dict[str, torch.Tensor] = {}
        lsum = None
        for i in range(mb):
            mbt = {k: _microbatch(v, i, mb) for k, v in batch.items()} \
                if mb > 1 else batch
            model.zero_grad(set_to_none=True)
            loss, lm = loss_fn(model, mbt)
            loss.backward()
            for k, p in params.items():
                g = p.grad
                if type(g).__name__ == "DTensor" and \
                        g.placements != p.placements:
                    g = g.redistribute(p.device_mesh, p.placements)
                g = g.float()
                gsum[k] = g if k not in gsum else gsum[k] + g
            lsum = loss.detach() if lsum is None else lsum + loss.detach()
        model.zero_grad(set_to_none=True)
        grads = {k: g / mb for k, g in gsum.items()}
        with torch.no_grad():
            _, new_o, om = adamw_update(opt_cfg, grads, opt_state, params,
                                        decay=decay)
        return new_o, {"loss": _whole(lsum / mb),
                       **{k: _whole(lm[k].detach()) for k in report}, **om}
    return step


# --------------------------------------------------------------------------
# LM cells
# --------------------------------------------------------------------------


def _lm_cell(spec: ArchSpec, shape: str, mesh, multi_pod: bool,
             sharding_mode: str, device) -> CellProgram:
    from ..models.transformer import (decay_mask, decode_step, init_caches,
                                      init_params, loss_fn, prefill_step)
    cfg = spec.model_cfg
    sp = spec.shapes[shape]
    ms = mesh_shape(mesh)
    is_train = sp.kind == "lm_train"
    fsdp2d = sharding_mode == "fsdp2d" and is_train
    ctx = ShardCtx(mesh=mesh, dp=flat_axes(multi_pod), tp=None) if fsdp2d \
        else ShardCtx(mesh=mesh, dp=dp_axes(multi_pod), tp="model")
    model = init_params(cfg, device="cpu")
    shapes = dict(model.named_parameters())
    if sharding_mode == "zero1" and is_train:
        pspecs = zero1_param_specs(shapes)
    elif fsdp2d:
        pspecs = fsdp2d_param_specs(shapes, ms, multi_pod)
    else:
        pspecs = lm_param_specs(shapes)
    pspecs = sanitize(pspecs, shapes, ms)
    ispecs = spec.input_specs(shape)
    padded = sp.kind in ("lm_train", "lm_prefill") and \
        sp.dims["batch"] % ctx.dp_size
    if padded:
        # a batch the dp ranks do not divide is padded to a multiple of
        # them, as GSPMD pads it: rank 0 holds ceil(batch / dp) rows, and
        # the padding rows take no expert slot (one microbatch)
        rows = -(-sp.dims["batch"] // ctx.dp_size) * ctx.dp_size
        ispecs = {k: torch.empty((rows,) + tuple(v.shape[1:]),
                                 dtype=v.dtype, device="meta")
                  for k, v in ispecs.items()}
        ctx = dataclasses.replace(ctx, rows=sp.dims["batch"])
    if fsdp2d:
        fa = flat_axes(multi_pod)
        bspecs = {k: (fa,) + (None,) * (v.ndim - 1)
                  for k, v in ispecs.items()}
    else:
        bspecs = batch_specs("lm", sp.kind, ispecs, multi_pod)
    bspecs = sanitize(bspecs, ispecs, ms)
    meta = {"family": "lm", "kind": sp.kind, "n_params": cfg.n_params,
            "n_active_params": cfg.n_active_params, "dims": dict(sp.dims)}
    decay = decay_mask(shapes)
    if not is_train:
        for p in model.parameters():
            p.requires_grad_(False)
    _distribute_module(model, pspecs, mesh, device)
    with torch.inference_mode(not is_train):
        batch = _inputs(ispecs, bspecs, mesh, device)

    if is_train:
        params = dict(model.named_parameters())
        if sharding_mode == "zero1":
            ospecs = zero1_opt_specs(pspecs, shapes, ms)
        else:
            ospecs = opt_state_specs(pspecs)
        ospecs = {"step": (), "m": sanitize(ospecs["m"], shapes, ms),
                  "v": sanitize(ospecs["v"], shapes, ms)}
        opt = _opt_state(params, ospecs, mesh, device)
        meta["sharding_mode"] = sharding_mode
        mb = 1 if padded else int(sp.dims.get("microbatches", 4))
        mb = max(1, min(mb, sp.dims["batch"] // max(ctx.dp_size, 1)))
        meta["microbatches"] = mb
        step = _accumulating_step(
            model, lambda m, b: loss_fn(m, b, ctx=ctx), AdamWConfig(), mb,
            decay)
        return CellProgram(f"{spec.name}:{shape}", step, (opt, batch),
                           {"params": pspecs, "opt": ospecs,
                            "batch": bspecs}, meta, (model,))

    if sp.kind == "lm_prefill":
        def prefill(batch):
            return prefill_step(model, batch["tokens"], ctx=ctx)
        return CellProgram(f"{spec.name}:{shape}", prefill, (batch,),
                           {"params": pspecs, "batch": bspecs}, meta,
                           (model,))

    long_ctx = sp.kind == "lm_long_decode"
    b, s_max = sp.dims["batch"], sp.dims["seq"]
    caches = init_caches(cfg, b, s_max, device="meta")
    cspecs = cache_specs(caches, multi_pod, long_ctx)
    position = s_max - 1              # the last slot of a full cache
    with torch.inference_mode():
        for c, cs in zip(caches, cspecs):
            for k, s in sanitize(cs, c, ms).items():
                c[k] = _dtensor(tuple(c[k].shape), c[k].dtype, s, mesh,
                                device)
            c["length"] = position
    meta["position"] = position

    def decode(caches, batch):
        return decode_step(model, caches, batch["tokens"], position,
                           ctx=ctx)[0]
    return CellProgram(f"{spec.name}:{shape}", decode, (caches, batch),
                       {"params": pspecs, "caches": cspecs,
                        "batch": bspecs}, meta, (model,))


# --------------------------------------------------------------------------
# GNN cells
# --------------------------------------------------------------------------


def _gnn_cell(spec: ArchSpec, shape: str, mesh, multi_pod: bool,
              device) -> CellProgram:
    import torch.distributed as dist
    from ..models.gnn import gnn_decay_mask, init_gnn_params
    from ..models.gnn_dist import build_dist_loss, make_grid, reduce_grads
    cfg = spec.model_cfg_for(shape)
    sp = spec.shapes[shape]
    ms = mesh_shape(mesh)
    world = dist.get_world_size()
    big = sp.kind == "gnn_full" and sp.dims["n_nodes"] > 1_000_000
    if big:
        cfg = dataclasses.replace(cfg, remat=True, dtype=torch.bfloat16)
        grid = make_grid(world // ms["model"], ms["model"])
    else:
        grid = make_grid(world, 1)
    model = _on_device(init_gnn_params(cfg, device="cpu"), device)
    shapes = dict(model.named_parameters())
    ispecs = spec.input_specs(shape)
    n_total = sp.dims["n_nodes"]
    # rank 0's part: edges over every rank, node tensors over the model
    # axis (whole when n_model is 1), per-graph tensors whole
    bspecs, batch = {}, {}
    for k, v in ispecs.items():
        if k.startswith("edge"):
            parts = world
        elif v.shape[0] == n_total:
            parts = grid.n_model
        else:
            parts = 1
        bspecs[k] = parts
        batch[k] = torch.empty((v.shape[0] // parts,) + tuple(v.shape[1:]),
                               dtype=v.dtype, device=device)
    loss_fn = _pooled_dist_loss(cfg, n_total, grid) \
        if cfg.task == "graph_class" else build_dist_loss(cfg, n_total, grid)
    red = reduce_grads(grid)
    opt_cfg = AdamWConfig()
    decay = gnn_decay_mask(shapes)
    opt = AdamWState(step=torch.zeros((), dtype=torch.int32, device=device),
                     m={k: torch.zeros_like(p, dtype=torch.float32)
                        for k, p in shapes.items()},
                     v={k: torch.zeros_like(p, dtype=torch.float32)
                        for k, p in shapes.items()})

    def train_step(opt_state, batch):
        model.zero_grad(set_to_none=True)
        loss, metrics = loss_fn(model, batch)
        loss.backward()
        params = dict(model.named_parameters())
        # a parameter the loss does not reach (EGNN's last coordinate
        # update) has a zero gradient, as jax.grad gives it
        grads = red({k: torch.zeros_like(p) if p.grad is None else p.grad
                     for k, p in params.items()})
        with torch.no_grad():
            _, new_o, om = adamw_update(opt_cfg, grads, opt_state, params,
                                        decay=decay)
        return new_o, {**metrics, **om}

    return CellProgram(
        f"{spec.name}:{shape}", train_step, (opt, batch),
        {"params": gnn_param_specs(shapes), "batch_parts": bspecs,
         "grid": (grid.n_data, grid.n_model)},
        {"family": "gnn", "kind": sp.kind, "n_params": cfg.n_params,
         "n_active_params": cfg.n_params, "dims": dict(sp.dims)}, (model,))


def _pooled_dist_loss(cfg, n_total: int, grid):
    """``gnn_dist.build_dist_loss`` for graph classification over whole
    node blocks (``n_model == 1``): every rank pools every graph's nodes
    after the layers (node state is whole on every rank) and computes
    the loss alike."""
    from ..models.gnn import graph_index, masked_loss_sum, node_states, \
        scatter_sum
    from ..models.gnn_dist import GridAggregation
    if grid.n_model != 1:
        raise ValueError("graph pooling needs whole node blocks")

    def loss_fn(model, batch):
        ix = graph_index(batch["edge_src"], batch["edge_dst"], n_total)
        h = node_states(model, batch, GridAggregation(ix, grid))
        h = scatter_sum(h, batch["graph_ids"], batch["loss_mask"].shape[0])
        num = masked_loss_sum(model.dec(h), batch, cfg.task)
        loss = num / batch["loss_mask"].float().sum().clamp(min=1.0)
        return loss, {"loss": loss}
    return loss_fn


# --------------------------------------------------------------------------
# RecSys cells
# --------------------------------------------------------------------------


def _rec_cell(spec: ArchSpec, shape: str, mesh, multi_pod: bool,
              device) -> CellProgram:
    from ..models.bst import (bst_decay_mask, bst_loss, bst_retrieval,
                              bst_serve, init_bst_params)
    cfg = spec.model_cfg
    sp = spec.shapes[shape]
    ms = mesh_shape(mesh)
    ctx = ShardCtx(mesh=mesh, dp=dp_axes(multi_pod), tp="model")
    model = init_bst_params(cfg, device="cpu")
    shapes = dict(model.named_parameters())
    pspecs = sanitize(bst_param_specs(shapes), shapes, ms)
    ispecs = spec.input_specs(shape)
    bspecs = sanitize(batch_specs("recsys", sp.kind, ispecs, multi_pod),
                      ispecs, ms)
    meta = {"family": "recsys", "kind": sp.kind, "n_params": cfg.n_params,
            "n_active_params": cfg.n_params, "dims": dict(sp.dims)}
    is_train = sp.kind == "rec_train"
    if not is_train:
        for p in model.parameters():
            p.requires_grad_(False)
    _distribute_module(model, pspecs, mesh, device)
    with torch.inference_mode(not is_train):
        batch = _inputs(ispecs, bspecs, mesh, device)
    specs = {"params": pspecs, "batch": bspecs}
    if is_train:
        params = dict(model.named_parameters())
        ospecs = opt_state_specs(pspecs)
        opt = _opt_state(params, ospecs, mesh, device)
        step = _accumulating_step(
            model, lambda m, b: bst_loss(m, b, ctx=ctx), AdamWConfig(), 1,
            bst_decay_mask(shapes), report=("acc",))
        return CellProgram(f"{spec.name}:{shape}", step, (opt, batch),
                           dict(specs, opt=ospecs), meta, (model,))
    if sp.kind == "rec_serve":
        def serve(batch):
            with torch.inference_mode():
                return bst_serve(model, batch, ctx=ctx)
        return CellProgram(f"{spec.name}:{shape}", serve, (batch,), specs,
                           meta, (model,))

    def retrieval(batch):
        with torch.inference_mode():
            return bst_retrieval(model, batch["hist"], batch["user_feats"],
                                 batch["cand_ids"], ctx=ctx)
    return CellProgram(f"{spec.name}:{shape}", retrieval, (batch,), specs,
                       meta, (model,))


# --------------------------------------------------------------------------
# BENU cells (the paper's technique)
# --------------------------------------------------------------------------


def _benu_cell(spec: ArchSpec, shape: str, mesh, multi_pod: bool,
               device) -> CellProgram:
    import torch.distributed as dist
    from ..core.estimate import GraphStats
    from ..core.executor import build_benu_step
    from ..core.pattern import get_pattern
    from ..core.plangen import generate_best_plan
    from ..distributed.rowstore import RowStoreSpec
    cfg = spec.model_cfg
    sp = spec.shapes[shape]
    n_shards = dist.get_world_size()
    rps = -(-(cfg.n_vertices + 1) // n_shards)
    store = RowStoreSpec(n=cfg.n_vertices, d=cfg.row_width,
                         n_shards=n_shards, rows_per_shard=rps, hot=cfg.hot)
    stats = GraphStats(n_vertices=cfg.n_vertices,
                       n_edges=cfg.n_vertices * 16)
    plan = generate_best_plan(get_pattern(cfg.pattern), stats)
    n_enu = sum(1 for i in plan.instrs if i.op == "ENU")
    caps = [cfg.batch_per_shard * cfg.cap_mult[min(i, len(cfg.cap_mult) - 1)]
            for i in range(n_enu)]
    caps = [-(-c // n_shards) * n_shards for c in caps]
    step = build_benu_step(plan, store, dist.group.WORLD, caps, cfg.req_cap,
                           rebalance=True)
    D, bps = cfg.row_width, cfg.batch_per_shard
    args = (torch.empty((rps, D), dtype=torch.int32, device=device),
            torch.empty((cfg.hot + 1, D), dtype=torch.int32, device=device),
            torch.empty((bps,), dtype=torch.int32, device=device),
            torch.empty((bps,), dtype=torch.bool, device=device))
    ispecs = {"shards": (n_shards, rps, D), "hot_rows": (cfg.hot + 1, D),
              "starts": (n_shards * bps,), "starts_valid": (n_shards * bps,)}
    metas = {k: torch.empty(v, device="meta") for k, v in ispecs.items()}
    return CellProgram(
        f"benu:{shape}", step, args,
        {"global_shapes": ispecs,
         "batch": batch_specs("benu", sp.kind, metas, multi_pod)},
        {"family": "benu", "kind": sp.kind, "n_params": 0,
         "n_active_params": 0, "dims": dict(sp.dims),
         "plan": plan.pretty(), "caps": caps})


def _sbenu_cell(spec: ArchSpec, shape: str, mesh, multi_pod: bool,
                device) -> CellProgram:
    import torch.distributed as dist
    from ..core.engine_sbenu_torch import (build_sbenu_enumerator,
                                           sbenu_default_caps)
    from ..core.estimate import GraphStats
    from ..core.pattern import get_pattern
    from ..core.sbenu import generate_best_sbenu_plans
    from ..graph.dynamic import DeviceSnapshot
    cfg = spec.model_cfg
    sp = spec.shapes[shape]
    d = sp.dims
    n, B = d["n_vertices"], d["batch"]
    world = dist.get_world_size()
    stats = GraphStats(n_vertices=n, n_edges=n * 8,
                       delta_edges=d["delta_width"])
    plan = generate_best_sbenu_plans(get_pattern(cfg.sbenu_pattern),
                                     stats)[0]
    bl = B // world                    # rank 0's slice of the start batch
    caps = sbenu_default_caps(plan, bl, d["delta_width"], d["row_width"])
    run = build_sbenu_enumerator(plan, n, caps)
    ispecs = spec.input_specs(shape)
    bspecs = batch_specs("benu", sp.kind, ispecs, multi_pod)
    rows, D, Dd = n + 1, d["row_width"], d["delta_width"]

    def blk(*shape):
        return torch.empty(shape, dtype=torch.int32, device=device)
    stacked_out, stacked_in = blk(2 * rows, D), blk(2 * rows, D)
    snap = DeviceSnapshot(
        prev_out=stacked_out[:rows], cur_out=stacked_out[rows:],
        prev_in=stacked_in[:rows], cur_in=stacked_in[rows:],
        delta_out=blk(rows, Dd), delta_out_sign=blk(rows, Dd),
        delta_in=blk(rows, Dd), delta_in_sign=blk(rows, Dd), n=n,
        stacked_out=stacked_out, stacked_in=stacked_in)
    starts = blk(bl)
    valid = torch.empty((bl,), dtype=torch.bool, device=device)
    return CellProgram(
        f"sbenu:{shape}", run, (snap, starts, valid), {"batch": bspecs},
        {"family": "benu", "kind": sp.kind, "n_params": 0,
         "n_active_params": 0, "dims": dict(d), "plan": plan.pretty(),
         "caps": caps})


# --------------------------------------------------------------------------


def build_cell(arch: str, shape: str, mesh, multi_pod: bool = False,
               sharding_mode: str = "fsdp", device="cpu",
               spec: ArchSpec = None) -> CellProgram:
    """The cell's program (see the module's docstring). Call under a
    ``FakeTensorMode`` over a fake world. ``spec`` overrides the
    registry's (a smoke spec)."""
    spec = spec or get_config(arch)
    family = spec.family
    if family == "lm":
        return _lm_cell(spec, shape, mesh, multi_pod, sharding_mode, device)
    if family == "gnn":
        return _gnn_cell(spec, shape, mesh, multi_pod, device)
    if family == "recsys":
        return _rec_cell(spec, shape, mesh, multi_pod, device)
    if family == "benu":
        if spec.shapes[shape].kind == "sbenu_enum":
            return _sbenu_cell(spec, shape, mesh, multi_pod, device)
        return _benu_cell(spec, shape, mesh, multi_pod, device)
    raise KeyError(family)
