"""meshgraphnet [gnn] — arXiv:2010.03409 (unverified tier).

n_layers=15 d_hidden=128 aggregator=sum mlp_layers=2; encode-process-decode
with edge features (d_edge=4: relative displacement + norm) and 3-dim node
regression targets.
"""

from ..models.gnn import GNNConfig
from . import ArchSpec, ShapeSpec, gnn_shapes

CONFIG = GNNConfig(name="meshgraphnet", kind="mgn", n_layers=15,
                   d_hidden=128, d_feat=16, n_out=3, task="node_reg",
                   d_edge=4)


def _smoke() -> ArchSpec:
    cfg = GNNConfig(name="mgn-smoke", kind="mgn", n_layers=3, d_hidden=32,
                    d_feat=8, n_out=3, task="node_reg", d_edge=4)
    return ArchSpec(
        name="meshgraphnet/smoke", family="gnn", model_cfg=cfg,
        shapes={"full": ShapeSpec("full", "gnn_full",
                                  {"n_nodes": 64, "n_edges": 256,
                                   "d_feat": 8, "n_classes": 3})})


SPEC = ArchSpec(
    name="meshgraphnet", family="gnn", model_cfg=CONFIG, shapes=gnn_shapes(),
    source="arXiv:2010.03409; unverified", smoke_builder=_smoke)
