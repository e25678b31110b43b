"""gin-tu [gnn] — arXiv:1810.00826 (paper tier).

n_layers=5 d_hidden=64 aggregator=sum eps=learnable. (The TU-dataset GIN;
BatchNorm replaced by LayerNorm, as in the reference.) BENU's per-vertex
motif counts feed it as features in ``examples/motif_features_torch.py``.
"""

from ..models.gnn import GNNConfig
from . import ArchSpec, ShapeSpec, gnn_shapes

CONFIG = GNNConfig(name="gin-tu", kind="gin", n_layers=5, d_hidden=64,
                   d_feat=16, n_out=7, task="node_class")


def _smoke() -> ArchSpec:
    cfg = GNNConfig(name="gin-smoke", kind="gin", n_layers=2, d_hidden=16,
                    d_feat=8, n_out=3)
    return ArchSpec(
        name="gin-tu/smoke", family="gnn", model_cfg=cfg,
        shapes={"full": ShapeSpec("full", "gnn_full",
                                  {"n_nodes": 64, "n_edges": 256,
                                   "d_feat": 8, "n_classes": 3}),
                "mol": ShapeSpec("mol", "gnn_molecule",
                                 {"n_nodes": 8 * 10, "n_edges": 2 * 8 * 20,
                                  "d_feat": 8, "n_graphs": 8,
                                  "n_classes": 2})})


SPEC = ArchSpec(
    name="gin-tu", family="gnn", model_cfg=CONFIG, shapes=gnn_shapes(),
    source="arXiv:1810.00826; paper", smoke_builder=_smoke)
