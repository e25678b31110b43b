"""Architecture registry of the port: ``get_config(arch_id)`` /
``list_archs()`` / ``all_cells()``.

Counterpart of ``repro/configs/__init__.py``: the ten assigned
architectures (the five LMs, the recsys model BST and the four GNNs, at
their exact published configs) plus ``benu``, the paper's own technique
as a dry-runnable architecture. Each spec carries its dry-run cells
(``shapes``; ``configs/base.py``).
"""

from __future__ import annotations

import importlib
from typing import List

from .base import (ArchSpec, ShapeSpec, gnn_shapes,  # noqa: F401 (re-export)
                   lm_shapes, recsys_shapes)

_MODULES = {
    "phi4-mini-3.8b": "phi4_mini_3_8b",
    "qwen2-0.5b": "qwen2_0_5b",
    "qwen2.5-3b": "qwen2_5_3b",
    "deepseek-v2-lite-16b": "deepseek_v2_lite_16b",
    "granite-moe-3b-a800m": "granite_moe_3b_a800m",
    "meshgraphnet": "meshgraphnet",
    "pna": "pna",
    "egnn": "egnn",
    "gin-tu": "gin_tu",
    "bst": "bst",
    "benu": "benu",
}

ASSIGNED = [a for a in _MODULES if a != "benu"]


def get_config(name: str) -> ArchSpec:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_MODULES)}")
    mod = importlib.import_module(f".{_MODULES[name]}", __package__)
    return mod.SPEC


def list_archs(include_benu: bool = True) -> List[str]:
    return list(_MODULES) if include_benu else list(ASSIGNED)


def all_cells(include_benu: bool = False) -> List[tuple]:
    """Every (arch, shape) pair of the dry-run matrix (40 assigned cells,
    42 with BENU's two)."""
    return [(a, s) for a in list_archs(include_benu)
            for s in get_config(a).shapes]
