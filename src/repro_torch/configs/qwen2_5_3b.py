"""qwen2.5-3b [dense] — hf:Qwen/Qwen2.5-3B (assignment cites the family
card hf:Qwen/Qwen2.5-0.5B).

36L d_model=2048 16H (GQA kv=2) d_ff=11008 vocab=151936 — GQA, QKV bias.
"""

import torch

from ..models.transformer import LMConfig
from .base import ArchSpec, lm_shapes, lm_smoke_shapes

CONFIG = LMConfig(
    name="qwen2.5-3b",
    n_layers=36, d_model=2048, n_heads=16, n_kv_heads=2, d_head=128,
    d_ff=11008, vocab=151936, qkv_bias=True, rope_theta=1_000_000.0,
    tie_embeddings=True, attn_kind="gqa", dtype=torch.bfloat16)


def _smoke() -> ArchSpec:
    cfg = LMConfig(name="qwen2.5-smoke", n_layers=3, d_model=128, n_heads=4,
                   n_kv_heads=2, d_head=32, d_ff=352, vocab=512,
                   qkv_bias=True, tie_embeddings=True, dtype=torch.float32,
                   remat=False)
    return ArchSpec(
        name="qwen2.5-3b/smoke", family="lm", model_cfg=cfg,
        shapes=lm_smoke_shapes())


SPEC = ArchSpec(
    name="qwen2.5-3b", family="lm", model_cfg=CONFIG,
    shapes=lm_shapes(), source="hf:Qwen/Qwen2.5-3B",
    applicability="BENU inapplicable; standard pjit sharding",
    smoke_builder=_smoke)
