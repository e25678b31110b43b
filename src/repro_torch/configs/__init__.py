"""Architecture registry of the port: ``get_config(arch_id)`` /
``list_archs()``.

Counterpart of ``repro/configs/__init__.py`` for the architectures the
port runs so far: the five LMs (dense GQA, MoE, MLA) and the recsys model
BST. The others of the reference's registry raise
``NotImplementedError`` naming the slice that brings them.
"""

from __future__ import annotations

import importlib
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

_MODULES = {
    "bst": "bst",
    "deepseek-v2-lite-16b": "deepseek_v2_lite_16b",
    "granite-moe-3b-a800m": "granite_moe_3b_a800m",
    "phi4-mini-3.8b": "phi4_mini_3_8b",
    "qwen2-0.5b": "qwen2_0_5b",
    "qwen2.5-3b": "qwen2_5_3b",
}

#: the reference's other architectures -> the later slice of the port
_LATER = {
    "meshgraphnet": "the GNN slice",
    "pna": "the GNN slice",
    "egnn": "the GNN slice",
    "gin-tu": "the GNN slice",
    "benu": "no model config (run repro_torch.launch.enumerate)",
}


@dataclass
class ArchSpec:
    """The reference's ``ArchSpec`` without its shape cells and
    ``input_specs``, which wait for the port's dry-run tooling."""

    name: str
    family: str                   # lm | gnn | recsys | benu
    model_cfg: Any
    source: str = ""              # citation tag from the assignment
    smoke_builder: Optional[Callable[[], "ArchSpec"]] = None

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
