"""pna [gnn] — arXiv:2004.05718 (paper tier).

n_layers=4 d_hidden=75 aggregators=mean-max-min-std
scalers=identity-amplification-attenuation.
"""

from ..models.gnn import GNNConfig
from . import ArchSpec, ShapeSpec, gnn_shapes

CONFIG = GNNConfig(name="pna", kind="pna", n_layers=4, d_hidden=75,
                   d_feat=16, n_out=7, task="node_class")


def _smoke() -> ArchSpec:
    cfg = GNNConfig(name="pna-smoke", kind="pna", n_layers=2, d_hidden=16,
                    d_feat=8, n_out=3)
    return ArchSpec(
        name="pna/smoke", family="gnn", model_cfg=cfg,
        shapes={"full": ShapeSpec("full", "gnn_full",
                                  {"n_nodes": 64, "n_edges": 256,
                                   "d_feat": 8, "n_classes": 3})})


SPEC = ArchSpec(
    name="pna", family="gnn", model_cfg=CONFIG, shapes=gnn_shapes(),
    source="arXiv:2004.05718; paper", smoke_builder=_smoke)
