"""bst [recsys] — Behavior Sequence Transformer, arXiv:1905.06874 (paper).

embed_dim=32 seq_len=20 n_blocks=1 n_heads=8 mlp=1024-512-256
interaction=transformer-seq; item table 10^6 rows, user profile 10^5
features in bags of 32.

``SHAPES`` holds the reference's recsys cells (``recsys_shapes`` in
``repro/configs/base.py``) as plain numbers: a training batch of 65,536
rows, serving at 512 (p99) and 262,144 (bulk) rows, and retrieval of one
user against 10^6 candidate items.
"""

import torch

from ..models.bst import BSTConfig
from . import ArchSpec

CONFIG = BSTConfig(
    name="bst", n_items=1_000_000, n_user_feats=100_000, user_feat_len=32,
    embed_dim=32, seq_len=20, n_blocks=1, n_heads=8,
    mlp_sizes=(1024, 512, 256), dtype=torch.float32)

SHAPES = {
    "train_batch": {"batch": 65_536},
    "serve_p99": {"batch": 512},
    "serve_bulk": {"batch": 262_144},
    "retrieval_cand": {"batch": 1, "n_candidates": 1_000_000},
}


def _smoke() -> ArchSpec:
    cfg = BSTConfig(name="bst-smoke", n_items=1000, n_user_feats=500,
                    user_feat_len=8, embed_dim=32, seq_len=20, n_blocks=1,
                    n_heads=8, mlp_sizes=(64, 32))
    return ArchSpec(name="bst/smoke", family="recsys", model_cfg=cfg)


SPEC = ArchSpec(
    name="bst", family="recsys", model_cfg=CONFIG,
    source="arXiv:1905.06874; paper", smoke_builder=_smoke)
