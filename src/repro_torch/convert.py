"""Carry state from the JAX package into the port, as plain data.

The tests run the port on the JAX package's own plan, device rows and LM
weights:

    plan = plan_from_fields(dataclasses.asdict(jax_plan))
    dg = device_graph_from_numpy(np.asarray(jax_device_graph.rows), n, "cpu")
    snap = device_snapshot_from_numpy(
        {k: np.asarray(getattr(jax_snap, k)) for k in SNAPSHOT_BLOCKS},
        n, "cpu")
    sd = lm_state_dict_from_numpy(jax.tree.map(np.asarray, params), cfg)
    model.load_state_dict(sd)
    bst.load_state_dict(bst_state_dict_from_numpy(
        jax.tree.map(np.asarray, bst_params), bst_cfg))
    shards, hot_rows, jspec = build_row_shards(jax_graph, S, hot=8)
    shard, hot, spec = row_shards_from_numpy(
        shards, hot_rows, dataclasses.asdict(jspec), rank, "cpu")
    jblocks, jhot, jspec = jax_sharded_store.step_sharded()
    blocks, hot_blocks, spec = snapshot_shard_from_numpy(
        {k: np.asarray(v) for k, v in jblocks.items()},
        {k: np.asarray(v) for k, v in jhot.items()},
        dataclasses.asdict(jspec), rank, "cpu")
    gnn.load_state_dict(gnn_state_dict_from_numpy(
        jax.tree.map(np.asarray, gnn_params), gnn_cfg))
    jopt = adamw_init(params)       # the JAX package's AdamWState
    opt = adamw_state_from_numpy(np.asarray(jopt.step),
                                 jax.tree.map(np.asarray, jopt.m),
                                 jax.tree.map(np.asarray, jopt.v), cfg)

Nothing here imports the JAX package; the inputs are dicts, tuples and
numpy arrays.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

from .core.engine_sbenu_torch import device_put_snapshot
from .core.engine_torch import DeviceGraph
from .core.instructions import Instr, Plan
from .distributed.rowstore import RowStoreSpec
from .graph.dynamic import SNAPSHOT_BLOCKS, DeviceSnapshot, SnapshotShardSpec
from .train.optimizer import AdamWState


def _tuples(x: Any) -> Any:
    """Nested lists/tuples -> nested tuples (variables are hashable)."""
    if isinstance(x, (list, tuple)):
        return tuple(_tuples(v) for v in x)
    return x


def plan_from_fields(d: Dict[str, Any]) -> Plan:
    """Rebuild a port :class:`Plan` from ``dataclasses.asdict(plan)``."""
    fields = dict(d)
    instrs = []
    for ins in fields.pop("instrs"):
        ins = dict(ins)
        if ins.get("target") is not None:
            ins["target"] = _tuples(ins["target"])
        for k in ("operands", "filters", "report"):
            ins[k] = _tuples(ins.get(k, ()))
        instrs.append(Instr(**ins))
    fields["matching_order"] = _tuples(fields["matching_order"])
    fields["constraints"] = _tuples(fields.get("constraints", ()))
    return Plan(instrs=instrs, **fields)


def device_graph_from_numpy(rows: np.ndarray, n: int,
                            device) -> DeviceGraph:
    """A :class:`DeviceGraph` from ``int32[N+1, D]`` padded rows whose row
    ``n`` is all-sentinel (``np.asarray`` of the JAX engine's rows)."""
    rows = np.ascontiguousarray(rows, dtype=np.int32)
    if rows.ndim != 2 or rows.shape[0] != n + 1 or np.any(rows[n] != n):
        raise ValueError(f"rows{rows.shape} must be [n+1, D] with row n={n} "
                         "all-sentinel")
    return DeviceGraph(rows=torch.from_numpy(rows).to(device), n=n)


def device_snapshot_from_numpy(blocks: Mapping[str, np.ndarray], n: int,
                               device) -> DeviceSnapshot:
    """A :class:`DeviceSnapshot` on ``device`` (stacked prev/cur buffers
    built) from the eight blocks of a reference snapshot, each an
    ``np.asarray`` of the JAX block: value blocks ``int32[n+1, D]`` with
    row ``n`` all-sentinel, sign blocks ``int32[n+1, Dd]``."""
    missing = [k for k in SNAPSHOT_BLOCKS if k not in blocks]
    if missing:
        raise ValueError(f"snapshot blocks missing: {missing}")
    for k in SNAPSHOT_BLOCKS:
        b = np.asarray(blocks[k])
        if b.ndim != 2 or b.shape[0] != n + 1:
            raise ValueError(f"{k}{b.shape} must be [n+1, D] with n={n}")
    return device_put_snapshot(
        DeviceSnapshot(n=n, **{k: np.array(blocks[k], np.int32)
                               for k in SNAPSHOT_BLOCKS}), device)


def _tensor(a: np.ndarray) -> torch.Tensor:
    """A torch tensor owning a copy of ``a``. A bf16 leaf comes from JAX as
    ``ml_dtypes.bfloat16``, which ``torch.from_numpy`` refuses: its bits
    go across as uint16 and are viewed as ``torch.bfloat16``."""
    a = np.array(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _leaves(tree: Mapping[str, Any], prefix: str = ""):
    """(dotted name, leaf) of a nested dict of arrays, depth first."""
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def lm_state_dict_from_numpy(params: Mapping[str, Any],
                             cfg) -> Dict[str, torch.Tensor]:
    """The port's ``Transformer`` state_dict from the JAX package's LM
    params (the pytree of ``np.asarray`` leaves of
    ``repro.models.transformer.init_params``). The stacked layer leaves
    ``[L, ...]`` are split per layer into ``layers.{i}``: the
    ``dense_layers`` stack first (an MoE model's dense prefix, or every
    layer of a dense model), then ``moe_layers`` (router, experts, shared
    experts). Attention leaves (GQA's, or MLA's with ``norm_ckv``) keep
    their names under ``attn.``, FFN leaves under ``ffn.``, and the block
    norms become ``norm1.weight`` / ``norm2.weight``. A tied ``embed``
    stays the one ``embed`` entry, which the head reads transposed."""
    sd = {"embed": _tensor(params["embed"]),
          "final_norm.weight": _tensor(params["final_norm"])}
    if not cfg.tie_embeddings:
        sd["lm_head"] = _tensor(params["lm_head"])
    norms = {"norm1": "norm1.weight", "norm2": "norm2.weight"}
    i = 0
    for stack_name in ("dense_layers", "moe_layers"):
        if stack_name not in params:
            continue
        leaves = [(norms.get(name, name), np.asarray(leaf))
                  for name, leaf in _leaves(params[stack_name])]
        n = leaves[0][1].shape[0]
        for j in range(n):
            for name, leaf in leaves:
                sd[f"layers.{i + j}.{name}"] = _tensor(leaf[j])
        i += n
    if i != cfg.n_layers:
        raise ValueError(f"{i} stacked layers for a config of "
                         f"{cfg.n_layers}")
    return sd


def bst_state_dict_from_numpy(params: Mapping[str, Any],
                              cfg) -> Dict[str, torch.Tensor]:
    """The port's ``BST`` state_dict from the JAX package's BST params
    (``np.asarray`` leaves of ``repro.models.bst.init_bst_params``): the
    three tables as they are, each ``[n_blocks, ...]`` leaf of ``blocks``
    split into ``blocks.{i}.<name>``, and ``mlp.w{i}`` / ``mlp.b{i}``."""
    sd = {name: _tensor(params[name])
          for name in ("item_emb", "pos_emb", "user_emb")}
    for name, leaf in _leaves(params["blocks"]):
        leaf = np.asarray(leaf)
        if leaf.shape[0] != cfg.n_blocks:
            raise ValueError(f"blocks.{name}{leaf.shape}: expected "
                             f"{cfg.n_blocks} stacked blocks")
        for i in range(cfg.n_blocks):
            sd[f"blocks.{i}.{name}"] = _tensor(leaf[i])
    for name, leaf in _leaves(params["mlp"], "mlp."):
        sd[name] = _tensor(leaf)
    return sd


def gnn_state_dict_from_numpy(params: Mapping[str, Any],
                              cfg) -> Dict[str, torch.Tensor]:
    """The port's ``GNN`` state_dict from the JAX package's GNN params
    (``np.asarray`` leaves of ``repro.models.gnn.init_gnn_params``):
    ``enc``, ``enc_e`` (MeshGraphNet) and ``dec`` as they are, and each
    ``[n_layers, ...]`` leaf of ``layers`` split into
    ``layers.{i}.<name>`` (GIN's ``eps [L]`` into 0-d tensors)."""
    sd = {}
    for tower in ("enc", "enc_e", "dec"):
        if tower in params:
            sd.update((name, _tensor(leaf))
                      for name, leaf in _leaves(params[tower], tower + "."))
    for name, leaf in _leaves(params["layers"]):
        leaf = np.asarray(leaf)
        if leaf.shape[0] != cfg.n_layers:
            raise ValueError(f"layers.{name}{leaf.shape}: expected "
                             f"{cfg.n_layers} stacked layers")
        for i in range(cfg.n_layers):
            sd[f"layers.{i}.{name}"] = _tensor(leaf[i])
    return sd


def adamw_state_from_numpy(step, m: Mapping[str, Any], v: Mapping[str, Any],
                           cfg):
    """The port's :class:`~repro_torch.train.optimizer.AdamWState` from the
    JAX package's ``AdamWState`` fields as host data: ``step`` (its int32
    counter) and the ``m`` and ``v`` pytrees of ``np.asarray`` leaves,
    shaped as the LM params. The moments go by the names of
    :func:`lm_state_dict_from_numpy` (stacked layer leaves split per
    layer), in f32."""
    moments = [{k: t.float() for k, t in
                lm_state_dict_from_numpy(tree, cfg).items()}
               for tree in (m, v)]
    return AdamWState(step=torch.tensor(int(np.asarray(step)),
                                        dtype=torch.int32),
                      m=moments[0], v=moments[1])


def row_shards_from_numpy(shards: np.ndarray, hot_rows: np.ndarray,
                          spec_fields: Mapping[str, Any], rank: int, device
                          ) -> Tuple[torch.Tensor, torch.Tensor,
                                     RowStoreSpec]:
    """One rank's ``(local_shard [rps, D], hot_rows [hot+1, D], spec)``
    from the reference's ``build_row_shards`` output: ``shards`` is its
    ``int32[S, rps, D]`` array, ``hot_rows`` its replicated rows and
    ``spec_fields`` ``dataclasses.asdict`` of its spec."""
    spec = RowStoreSpec(**spec_fields)
    shards = np.asarray(shards)
    if shards.shape != (spec.n_shards, spec.rows_per_shard, spec.d):
        raise ValueError(f"shards{shards.shape} do not match {spec}")
    return (torch.from_numpy(np.array(shards[rank], np.int32)).to(device),
            torch.from_numpy(np.array(hot_rows, np.int32)).to(device), spec)


def snapshot_shard_from_numpy(blocks: Mapping[str, np.ndarray],
                              hot_blocks: Mapping[str, np.ndarray],
                              spec_fields: Mapping[str, Any], rank: int,
                              device
                              ) -> Tuple[Dict[str, torch.Tensor],
                                         Dict[str, torch.Tensor],
                                         SnapshotShardSpec]:
    """One rank's slice of a reference sharded six-block snapshot
    (``ShardedDeviceSnapshotStore.step_sharded``): its ``[rps, W]`` rows
    of each of the six ``[S * rps, W]`` blocks, the replicated
    ``[hot+1, W]`` blocks as they are, and the spec — the same shape
    :meth:`repro_torch.graph.dynamic.ShardedDeviceSnapshotStore.
    step_sharded` returns."""
    spec = SnapshotShardSpec(**spec_fields)
    rps = spec.rows_per_shard
    mine, hot = {}, {}
    for k, b in blocks.items():
        b = np.asarray(b)
        if b.shape[0] != spec.n_shards * rps:
            raise ValueError(f"{k}{b.shape} must have S * rps rows")
        mine[k] = torch.from_numpy(
            np.array(b[rank * rps:(rank + 1) * rps], np.int32)).to(device)
        hot[k] = torch.from_numpy(
            np.array(hot_blocks[k], np.int32)).to(device)
    return mine, hot, spec
