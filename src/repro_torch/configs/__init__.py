"""Architecture registry of the port: ``get_config(arch_id)`` /
``list_archs()``.

Counterpart of ``repro/configs/__init__.py`` (and of the parts of
``repro/configs/base.py`` that need no JAX) for the ten assigned
architectures: the five LMs (dense GQA, MoE, MLA), the recsys model BST
and the four GNNs, whose shape cells (``gnn_shapes``) set their feature
width, classes and task (``ArchSpec.model_cfg_for``). ``benu`` raises
``NotImplementedError``: it has no model config.
"""

from __future__ import annotations

import importlib
from dataclasses import dataclass, field, replace
from typing import Any, Callable, Dict, List, Optional

_MODULES = {
    "bst": "bst",
    "deepseek-v2-lite-16b": "deepseek_v2_lite_16b",
    "egnn": "egnn",
    "gin-tu": "gin_tu",
    "granite-moe-3b-a800m": "granite_moe_3b_a800m",
    "meshgraphnet": "meshgraphnet",
    "phi4-mini-3.8b": "phi4_mini_3_8b",
    "pna": "pna",
    "qwen2-0.5b": "qwen2_0_5b",
    "qwen2.5-3b": "qwen2_5_3b",
}

#: the reference's other architectures -> why the port has no config
_LATER = {
    "benu": "no model config (run repro_torch.launch.enumerate)",
}


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str
    dims: Dict[str, int]          # e.g. {"n_nodes": 2708, "n_edges": ...}
    note: str = ""


@dataclass
class ArchSpec:
    """The reference's ``ArchSpec`` without ``input_specs`` (abstract
    ``jax.ShapeDtypeStruct`` inputs), which waits for the port's dry-run
    tooling. ``shapes`` holds the GNN cells; the other families keep
    theirs as plain numbers beside the config (``configs/bst.py``)."""

    name: str
    family: str                   # lm | gnn | recsys | benu
    model_cfg: Any
    source: str = ""              # citation tag from the assignment
    smoke_builder: Optional[Callable[[], "ArchSpec"]] = None
    shapes: Dict[str, ShapeSpec] = field(default_factory=dict)

    def model_cfg_for(self, shape_name: str):
        """GNN configs vary with the shape (feature dim / classes /
        task); the other families' configs do not."""
        if self.family != "gnn":
            return self.model_cfg
        sp = self.shapes[shape_name]
        cfg = self.model_cfg
        if cfg.task == "node_reg":                      # meshgraphnet
            return replace(cfg, d_feat=sp.dims["d_feat"])
        task = "graph_class" if sp.kind == "gnn_molecule" else "node_class"
        return replace(cfg, d_feat=sp.dims["d_feat"],
                       n_out=sp.dims["n_classes"], task=task)

    def smoke(self) -> "ArchSpec":
        """Reduced same-family config for CPU smoke tests."""
        if self.smoke_builder is None:
            raise ValueError(f"{self.name}: no smoke config")
        return self.smoke_builder()


def get_config(name: str) -> ArchSpec:
    if name in _LATER:
        raise NotImplementedError(f"arch {name!r} is not ported yet: "
                                  f"{_LATER[name]}")
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_MODULES)}")
    mod = importlib.import_module(f".{_MODULES[name]}", __package__)
    return mod.SPEC


def list_archs() -> List[str]:
    return list(_MODULES)


def gnn_shapes() -> Dict[str, ShapeSpec]:
    """The reference's GNN cells (``gnn_shapes`` of
    ``repro/configs/base.py``)."""
    return {
        "full_graph_sm": ShapeSpec(
            "full_graph_sm", "gnn_full",
            {"n_nodes": 2708, "n_edges": 2 * 10556, "d_feat": 1433,
             "n_classes": 7},
            note="Cora-scale full batch (edges symmetrized: 2x)"),
        "minibatch_lg": ShapeSpec(
            "minibatch_lg", "gnn_minibatch",
            {"n_nodes": 169_984, "n_edges": 337_920, "d_feat": 602,
             "batch_nodes": 1024, "fanout1": 15, "fanout2": 10,
             "n_classes": 41, "graph_nodes": 232_965},
            note="Reddit-scale sampled block: 1024 targets, fanout 15-10 -> "
                 "padded induced block (nodes 1024*(1+15+150))"),
        "ogb_products": ShapeSpec(
            "ogb_products", "gnn_full",
            {"n_nodes": 2_449_408, "n_edges": 2 * 61_859_140,
             "d_feat": 100, "n_classes": 47},
            note="full-batch-large (edges symmetrized; nodes padded "
                 "2449029 -> 2449408 for even 1D node sharding)"),
        "molecule": ShapeSpec(
            "molecule", "gnn_molecule",
            {"n_nodes": 128 * 30, "n_edges": 2 * 128 * 64, "d_feat": 16,
             "n_graphs": 128, "n_classes": 2},
            note="batched small graphs, block-diagonal"),
    }
