"""egnn [gnn] — arXiv:2102.09844 (paper tier).

n_layers=4 d_hidden=64 equivariance=E(n): scalar-distance messages +
equivariant coordinate updates.
"""

from ..models.gnn import GNNConfig
from . import ArchSpec, ShapeSpec, gnn_shapes

CONFIG = GNNConfig(name="egnn", kind="egnn", n_layers=4, d_hidden=64,
                   d_feat=16, n_out=7, task="node_class")


def _smoke() -> ArchSpec:
    cfg = GNNConfig(name="egnn-smoke", kind="egnn", n_layers=2, d_hidden=16,
                    d_feat=8, n_out=3)
    return ArchSpec(
        name="egnn/smoke", family="gnn", model_cfg=cfg,
        shapes={"full": ShapeSpec("full", "gnn_full",
                                  {"n_nodes": 64, "n_edges": 256,
                                   "d_feat": 8, "n_classes": 3})})


SPEC = ArchSpec(
    name="egnn", family="gnn", model_cfg=CONFIG, shapes=gnn_shapes(),
    source="arXiv:2102.09844; paper", smoke_builder=_smoke)
