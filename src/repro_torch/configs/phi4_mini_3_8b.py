"""phi4-mini-3.8b [dense] — arXiv:2412.08905 (hf).

32L d_model=3072 24H (GQA kv=8) d_ff=8192 vocab=200064 — RoPE SwiGLU GQA.
"""

import torch

from ..models.transformer import LMConfig
from .base import ArchSpec, lm_shapes, lm_smoke_shapes

CONFIG = LMConfig(
    name="phi4-mini-3.8b",
    n_layers=32, d_model=3072, n_heads=24, n_kv_heads=8, d_head=128,
    d_ff=8192, vocab=200064, qkv_bias=False, rope_theta=10000.0,
    tie_embeddings=True, attn_kind="gqa", dtype=torch.bfloat16)


def _smoke() -> ArchSpec:
    cfg = LMConfig(name="phi4-mini-smoke", n_layers=2, d_model=128,
                   n_heads=4, n_kv_heads=2, d_head=32, d_ff=256, vocab=512,
                   tie_embeddings=True, dtype=torch.float32, remat=False)
    return ArchSpec(
        name="phi4-mini-3.8b/smoke", family="lm", model_cfg=cfg,
        shapes=lm_smoke_shapes())


SPEC = ArchSpec(
    name="phi4-mini-3.8b", family="lm", model_cfg=CONFIG,
    shapes=lm_shapes(), source="arXiv:2412.08905; hf",
    applicability=("BENU inapplicable (no graph-structured data access); "
                   "standard pjit sharding, no technique integration"),
    smoke_builder=_smoke)
