"""bst [recsys] — Behavior Sequence Transformer, arXiv:1905.06874 (paper).

embed_dim=32 seq_len=20 n_blocks=1 n_heads=8 mlp=1024-512-256
interaction=transformer-seq; item table 10^6 rows, user profile 10^5
features in bags of 32.

Its cells are ``recsys_shapes``: a training batch of 65,536 rows,
serving at 512 (p99) and 262,144 (bulk) rows, and retrieval of one user
against 10^6 candidate items; ``SHAPES`` holds their dims.
"""

import torch

from ..models.bst import BSTConfig
from .base import ArchSpec, ShapeSpec, recsys_shapes

CONFIG = BSTConfig(
    name="bst", n_items=1_000_000, n_user_feats=100_000, user_feat_len=32,
    embed_dim=32, seq_len=20, n_blocks=1, n_heads=8,
    mlp_sizes=(1024, 512, 256), dtype=torch.float32)

SHAPES = {k: dict(s.dims) for k, s in recsys_shapes().items()}


def _smoke() -> ArchSpec:
    cfg = BSTConfig(name="bst-smoke", n_items=1000, n_user_feats=500,
                    user_feat_len=8, embed_dim=32, seq_len=20, n_blocks=1,
                    n_heads=8, mlp_sizes=(64, 32))
    return ArchSpec(
        name="bst/smoke", family="recsys", model_cfg=cfg,
        shapes={"train": ShapeSpec("train", "rec_train", {"batch": 16}),
                "retr": ShapeSpec("retr", "rec_retrieval",
                                  {"batch": 1, "n_candidates": 512})})


SPEC = ArchSpec(
    name="bst", family="recsys", model_cfg=CONFIG,
    shapes=recsys_shapes(), source="arXiv:1905.06874; paper",
    applicability=("substrate reuse: the 10^6-row embedding table is "
                   "row-sharded exactly like the BENU DistributedRowStore; "
                   "EmbeddingBag = take + segment_sum per the taxonomy"),
    smoke_builder=_smoke)
