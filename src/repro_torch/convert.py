"""Carry state from the JAX package into the port, as plain data.

The tests run the port on the JAX package's own plan and device rows:

    plan = plan_from_fields(dataclasses.asdict(jax_plan))
    dg = device_graph_from_numpy(np.asarray(jax_device_graph.rows), n, "cpu")

Nothing here imports the JAX package; the inputs are dicts, tuples and
numpy arrays.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from .core.engine_torch import DeviceGraph
from .core.instructions import Instr, Plan


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
