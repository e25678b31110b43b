"""Partition specs for every parameter / optimizer state / cache / batch.

Counterpart of ``repro/launch/shardings.py``, over the port's parameter
names (the ``state_dict`` keys that ``repro_torch.convert`` maps). A spec
is a tuple with one entry per tensor dim: ``None``, a mesh-axis name, or
a tuple of names (the counterpart of ``PartitionSpec``).
:func:`placements` turns one into DTensor ``Shard`` / ``Replicate``
placements and :func:`local_shape` gives rank 0's shard.

LM parameter rules (FSDP over "data", TP/EP over "model"):

    embed [V, D]                  (model, data)     vocab x fsdp
    lm_head [D, V]                (data, model)
    wq/wk/wv [D, HD]              (data, model)     fsdp x TP(flattened heads)
    wo [HD, D]                    (model, data)
    biases [HD]                   (model,)
    swiglu gate/up [D, F]         (data, model)
    swiglu down [F, D]            (model, data)
    MLA wkv_a [D, r+rope]         (data, None)
    MLA wkv_b [r, H(n+v)]         (None, model)
    MoE router [D, E]             (data, None)
    MoE gate/up [E, D, F]         (model, data, None)   EP over model
    MoE down [E, F, D]            (model, None, data)
    norms                         replicated

The reference stacks each block's leaves into one ``[L, ...]`` leaf whose
spec leads with ``None``; the port keeps a tensor per layer
(``layers.{i}.``), whose spec is the reference's without that entry.
Where the reference's :func:`sanitize` or ZeRO-1 rule puts an axis on
the stack dim itself, the port puts it on the next dim that takes it:
the same axes, so the same bytes per device, in another shard shape.

Optimizer state (m, v) inherits the parameter spec leaf for leaf. KV
caches shard the *sequence* axis over "model" (decode_32k) or over every
axis (long_500k).
"""

from __future__ import annotations

import math
from typing import Dict, Mapping, Sequence, Tuple, Union

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Replicate, Shard

from .mesh import dp_axes, flat_axes

DATA, MODEL = "data", "model"

Axis = Union[None, str, Tuple[str, ...]]
Spec = Tuple[Axis, ...]


def replicated(ndim: int) -> Spec:
    return (None,) * ndim


def _axes(axis: Axis) -> Tuple[str, ...]:
    if axis is None:
        return ()
    return (axis,) if isinstance(axis, str) else tuple(axis)


def axis_size(axis: Axis, mesh_shape: Mapping[str, int]) -> int:
    return math.prod(mesh_shape[a] for a in _axes(axis))


def mesh_shape(mesh: DeviceMesh) -> Dict[str, int]:
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


# --------------------------------------------------------------------------
# LM parameters
# --------------------------------------------------------------------------


def lm_param_spec_one(name: str, ndim: int) -> Spec:
    """The spec of the LM parameter ``name`` (a state_dict key)."""
    leaf = name.split(".")[-1]
    if name == "embed":
        return (MODEL, DATA)
    if name == "lm_head":
        return (DATA, MODEL)
    if leaf in ("wq", "wk", "wv", "w_gate", "w_up"):
        if ndim == 3:                               # MoE expert [E, D, F]
            return (MODEL, DATA, None)
        return (DATA, MODEL)
    if leaf in ("wo", "w_down"):
        if ndim == 3:                               # [E, F, D]
            return (MODEL, None, DATA)
        return (MODEL, DATA)
    if leaf in ("bq", "bk", "bv"):
        return (MODEL,)
    if leaf == "wkv_a":
        return (DATA, None)
    if leaf == "wkv_b":
        return (None, MODEL)
    if leaf == "router":
        return (DATA, None)
    return replicated(ndim)                         # norms, anything else


def lm_param_specs(shapes: Mapping[str, torch.Tensor]) -> Dict[str, Spec]:
    """``{name: spec}`` for a dict of LM parameters (any device, meta)."""
    return {k: lm_param_spec_one(k, v.ndim) for k, v in shapes.items()}


def opt_state_specs(param_specs: Mapping[str, Spec]) -> Dict[str, Dict]:
    """AdamW's ``step`` (replicated), ``m`` and ``v`` mirroring the
    parameter specs."""
    return {"step": (), "m": dict(param_specs), "v": dict(param_specs)}


def fsdp2d_param_specs(shapes: Mapping[str, torch.Tensor],
                       mesh_shape: Mapping[str, int],
                       multi_pod: bool = False) -> Dict[str, Spec]:
    """Pure 2D FSDP: every parameter sharded over the flattened
    ("data", "model") axes on its largest divisible dim ("pod" excluded:
    parameters replicated across pods); no tensor parallelism."""
    flat = flat_axes(multi_pod)[1:] if multi_pod else flat_axes(False)
    size = axis_size(flat, mesh_shape)
    out = {}
    for k, leaf in shapes.items():
        best, best_dim = None, -1
        for i, n in enumerate(leaf.shape):
            if n % size == 0 and n > best_dim:
                best, best_dim = i, n
        entries = [None] * leaf.ndim
        if best is not None:
            entries[best] = flat
        out[k] = tuple(entries)
    return out


def zero1_param_specs(shapes: Mapping[str, torch.Tensor]
                      ) -> Dict[str, Spec]:
    """ZeRO-1: parameters sharded over "model" only (replicated across
    "data"); the optimizer state adds "data" (:func:`zero1_opt_specs`)."""
    return {k: tuple(None if ax == DATA else ax
                     for ax in lm_param_spec_one(k, v.ndim))
            for k, v in shapes.items()}


def zero1_opt_specs(param_specs: Mapping[str, Spec],
                    shapes: Mapping[str, torch.Tensor],
                    mesh_shape: Mapping[str, int]) -> Dict[str, Dict]:
    """Opt-state specs: the parameter's spec + "data" on the first free,
    divisible dim (the ZeRO-1 shard axis)."""
    dsize = mesh_shape[DATA]
    mv = {}
    for k, spec in param_specs.items():
        shape = shapes[k].shape
        entries = list(spec) + [None] * (len(shape) - len(spec))
        for i, ax in enumerate(entries):
            if ax is None and shape[i] % dsize == 0 and shape[i] >= dsize:
                entries[i] = DATA
                break
        mv[k] = tuple(entries)
    return {"step": (), "m": mv, "v": dict(mv)}


def cache_spec_one(name: str, ndim: int, multi_pod: bool,
                   long_context: bool) -> Spec:
    """A KV-cache leaf's spec: GQA ``k`` / ``v`` [B, S, KV, dh]; MLA
    ``c_kv`` [B, S, r], ``k_rope`` [B, S, rope]."""
    seq_axes = flat_axes(multi_pod) if long_context else MODEL
    dp = None if long_context else dp_axes(multi_pod)
    if name in ("k", "v"):
        return (dp, seq_axes, None, None)
    if name in ("c_kv", "k_rope"):
        return (dp, seq_axes, None)
    return replicated(ndim)


def cache_specs(caches: Sequence[Mapping[str, torch.Tensor]],
                multi_pod: bool, long_context: bool) -> list:
    """Specs of the per-layer cache dicts (``init_caches``); the int
    ``length`` entries are left out."""
    return [{k: cache_spec_one(k, v.ndim, multi_pod, long_context)
             for k, v in c.items() if isinstance(v, torch.Tensor)}
            for c in caches]


# --------------------------------------------------------------------------
# GNN / BST parameters
# --------------------------------------------------------------------------


def gnn_param_specs(shapes: Mapping[str, torch.Tensor]) -> Dict[str, Spec]:
    """GNN models are small: replicate every leaf."""
    return {k: replicated(v.ndim) for k, v in shapes.items()}


def bst_param_specs(shapes: Mapping[str, torch.Tensor]) -> Dict[str, Spec]:
    out = {}
    for k, v in shapes.items():
        if k in ("item_emb", "user_emb"):
            out[k] = (MODEL, None)                  # row-sharded tables
        elif k == "mlp.w0":
            out[k] = (None, MODEL)                  # widest MLP matmul
        else:
            out[k] = replicated(v.ndim)
    return out


# --------------------------------------------------------------------------
# Batches
# --------------------------------------------------------------------------


def batch_specs(family: str, kind: str, specs: Mapping[str, torch.Tensor],
                multi_pod: bool) -> Dict[str, Spec]:
    dp = dp_axes(multi_pod)
    flat = flat_axes(multi_pod)
    out: Dict[str, Spec] = {}
    if family == "lm":
        for k, v in specs.items():
            if kind == "lm_long_decode":
                out[k] = replicated(v.ndim)         # batch=1
            else:
                out[k] = (dp,) + replicated(v.ndim - 1)
        return out
    if family == "gnn":
        for k, v in specs.items():
            if k in ("edge_src", "edge_dst", "edge_attr"):
                out[k] = (flat,) + replicated(v.ndim - 1)
            else:
                out[k] = replicated(v.ndim)         # node tensors replicated
        return out
    if family == "recsys":
        for k, v in specs.items():
            if kind == "rec_retrieval":
                out[k] = ((flat,) if k == "cand_ids"
                          else replicated(v.ndim))
            else:
                out[k] = (dp,) + replicated(v.ndim - 1)
        return out
    if family == "benu":
        if kind == "sbenu_enum":
            # snapshot blocks replicated, start batch sharded over the mesh
            return {k: ((flat,) if v.ndim == 1 else replicated(v.ndim))
                    for k, v in specs.items()}
        if kind == "sbenu_dist_enum":
            return sbenu_snapshot_specs(flat)
        return {"shards": (flat, None, None), "hot_rows": (None, None),
                "starts": (flat,), "starts_valid": (flat,)}
    raise KeyError(family)


def sbenu_snapshot_specs(axis: Axis = "shard") -> Dict[str, Spec]:
    """Specs of the mesh-sharded six-block streaming snapshot: value
    blocks row-block partitioned over ``axis``, their ``hot_*`` slices
    replicated, the start batch over ``axis``."""
    blocks = ("prev_out", "cur_out", "prev_in", "cur_in",
              "delta_joint_out", "delta_joint_in")
    specs: Dict[str, Spec] = {name: (axis, None) for name in blocks}
    specs.update({f"hot_{name}": (None, None) for name in blocks})
    specs.update(starts=(axis,), starts_valid=(axis,))
    return specs


# --------------------------------------------------------------------------
# Specs against a mesh
# --------------------------------------------------------------------------


def sanitize_one(spec: Spec, shape: Sequence[int],
                 mesh_shape: Mapping[str, int], rehome: bool = True) -> Spec:
    """Drop axis assignments whose mesh size does not divide the dim,
    then re-home each dropped axis on the first unassigned dim it divides
    (granite's vocab 49155 is not divisible by 16: its embed falls back
    from (model, data) to (None, data); an expert count that the model
    axis does not divide moves "model" to the FFN dim). DTensor would
    accept the uneven shard, but rank 0's shape would then differ from
    the reference's. ``rehome=False`` only drops (an activation's layout:
    the reference never re-homes a constraint)."""
    entries = list(spec) + [None] * (len(shape) - len(spec))
    dropped = []
    for i, ax in enumerate(entries):
        if ax is not None and shape[i] % axis_size(ax, mesh_shape) != 0:
            dropped.append(ax)
            entries[i] = None
    for ax in dropped if rehome else ():
        size = axis_size(ax, mesh_shape)
        for i, cur in enumerate(entries):
            if cur is None and shape[i] % size == 0 and shape[i] >= size \
                    and shape[i] > 1:
                taken = {a for e in entries for a in _axes(e)}
                if taken & set(_axes(ax)):
                    continue
                entries[i] = ax
                break
    return tuple(entries)


def sanitize(specs: Mapping[str, Spec], shapes: Mapping[str, torch.Tensor],
             mesh_shape: Mapping[str, int]) -> Dict[str, Spec]:
    return {k: sanitize_one(s, shapes[k].shape, mesh_shape)
            for k, s in specs.items()}


def placements(spec: Spec, mesh: DeviceMesh) -> list:
    """DTensor placements of ``spec`` on ``mesh``: mesh dim ``a`` gets
    ``Shard(i)`` when ``spec[i]`` names it, else ``Replicate()``. A dim
    over several axes shards in mesh-dim order (the reference's
    major-to-minor order), so its axes must be named in that order. A
    mesh dim of size 1 is ``Replicate()`` (the same layout; DTensor's
    views refuse a dim of size 1 sharded over it)."""
    names = list(mesh.mesh_dim_names)
    out = [Replicate() for _ in names]
    sizes = dict(zip(names, mesh.shape))
    for i, ax in enumerate(spec):
        axes = _axes(ax)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: axes {axes} of dim {i} are not "
                             f"in the mesh's order {names}")
        for j in idx:
            if sizes[names[j]] > 1:
                out[j] = Shard(i)
    return out


def local_shape(global_shape: Sequence[int], spec: Spec,
                mesh_shape: Mapping[str, int]) -> Tuple[int, ...]:
    """Rank 0's shard of a tensor of ``global_shape`` laid out by
    ``spec`` (a sanitized spec: every axis divides its dim)."""
    spec = tuple(spec) + (None,) * (len(global_shape) - len(spec))
    out = []
    for n, ax in zip(global_shape, spec):
        size = axis_size(ax, mesh_shape)
        if n % size:
            raise ValueError(f"dim {n} is not divisible by {ax} ({size})")
        out.append(n // size)
    return tuple(out)
