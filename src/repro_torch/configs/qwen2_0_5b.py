"""qwen2-0.5b [dense] — arXiv:2407.10671 (hf).

24L d_model=896 14H (GQA kv=2) d_ff=4864 vocab=151936 — GQA, QKV bias.
"""

import torch

from ..models.transformer import LMConfig
from .base import ArchSpec, lm_shapes, lm_smoke_shapes

CONFIG = LMConfig(
    name="qwen2-0.5b",
    n_layers=24, d_model=896, n_heads=14, n_kv_heads=2, d_head=64,
    d_ff=4864, vocab=151936, qkv_bias=True, rope_theta=1_000_000.0,
    tie_embeddings=True, attn_kind="gqa", dtype=torch.bfloat16)


def _smoke() -> ArchSpec:
    cfg = LMConfig(name="qwen2-smoke", n_layers=2, d_model=112, n_heads=7,
                   n_kv_heads=1, d_head=16, d_ff=224, vocab=512,
                   qkv_bias=True, tie_embeddings=True, dtype=torch.float32,
                   remat=False)
    return ArchSpec(
        name="qwen2-0.5b/smoke", family="lm", model_cfg=cfg,
        shapes=lm_smoke_shapes())


SPEC = ArchSpec(
    name="qwen2-0.5b", family="lm", model_cfg=CONFIG,
    shapes=lm_shapes(), source="arXiv:2407.10671; hf",
    applicability="BENU inapplicable; standard pjit sharding",
    smoke_builder=_smoke)
