"""granite-moe-3b-a800m [moe] — hf:ibm-granite (assignment block).

32L d_model=1536 24H (GQA kv=8) vocab=49155, MoE 40 experts top-8 with
expert d_ff=512, no shared expert. (The assignment block's note says 32
experts; the reference uses 40, per its summary line, and so does the
port.)
"""

import torch

from ..models.transformer import LMConfig
from .base import ArchSpec, lm_shapes, lm_smoke_shapes

CONFIG = LMConfig(
    name="granite-moe-3b-a800m",
    n_layers=32, d_model=1536, n_heads=24, n_kv_heads=8, d_head=64,
    d_ff=512, vocab=49155, rope_theta=10000.0,
    tie_embeddings=True, attn_kind="gqa",
    moe=True, n_experts=40, n_shared=0, top_k=8, moe_d_ff=512,
    first_dense_layers=0, dtype=torch.bfloat16)


def _smoke() -> ArchSpec:
    cfg = LMConfig(name="granite-smoke", n_layers=2, d_model=128, n_heads=4,
                   n_kv_heads=2, d_head=32, d_ff=64, vocab=512,
                   tie_embeddings=True, moe=True, n_experts=5, n_shared=0,
                   top_k=2, moe_d_ff=64, dtype=torch.float32, remat=False)
    return ArchSpec(
        name="granite-moe-3b-a800m/smoke", family="lm", model_cfg=cfg,
        shapes=lm_smoke_shapes())


SPEC = ArchSpec(
    name="granite-moe-3b-a800m", family="lm", model_cfg=CONFIG,
    shapes=lm_shapes(), source="hf:ibm-granite/granite-3.0 family",
    applicability="BENU inapplicable; EP over the model axis",
    smoke_builder=_smoke)
