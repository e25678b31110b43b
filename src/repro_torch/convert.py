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

Nothing here imports the JAX package; the inputs are dicts, tuples and
numpy arrays.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from .core.engine_sbenu_torch import device_put_snapshot
from .core.engine_torch import DeviceGraph
from .core.instructions import Instr, Plan
from .graph.dynamic import SNAPSHOT_BLOCKS, DeviceSnapshot


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


def lm_state_dict_from_numpy(params: Mapping[str, Any],
                             cfg) -> Dict[str, torch.Tensor]:
    """The port's ``Transformer`` state_dict from the JAX package's LM
    params (the pytree of ``np.asarray`` leaves of
    ``repro.models.transformer.init_params``). The stacked
    ``dense_layers`` leaves ``[L, ...]`` are split per layer; a tied
    ``embed`` stays the one ``embed`` entry, which the head reads
    transposed."""
    if "moe_layers" in params or cfg.moe or cfg.attn_kind == "mla":
        raise NotImplementedError("MoE and MLA params come with the MoE/MLA "
                                  "slice of the port")
    sd = {"embed": _tensor(params["embed"]),
          "final_norm.weight": _tensor(params["final_norm"])}
    if not cfg.tie_embeddings:
        sd["lm_head"] = _tensor(params["lm_head"])
    stack = params["dense_layers"]
    leaves = {"norm1.weight": stack["norm1"], "norm2.weight": stack["norm2"]}
    leaves.update({f"attn.{k}": v for k, v in stack["attn"].items()})
    leaves.update({f"ffn.{k}": v for k, v in stack["ffn"].items()})
    for i in range(cfg.n_layers):
        for name, leaf in leaves.items():
            sd[f"layers.{i}.{name}"] = _tensor(np.asarray(leaf)[i])
    return sd
